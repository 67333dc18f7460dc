"""The reader of ``decode_graph_share.decode`` on a fake program record:
the share of the decode-step calls that replayed the step's CUDA graph,
from the program's tallies; None without a record, without tallies (a
program older than them) or without a decode-step call (the train
step's tallies alone)."""
from __future__ import annotations

import sys
import types

import pytest

from portbench.harness import manifest
from portbench.harness import spans as S
from portbench.harness.readers import Run


def test_decode_graph_share_reads_the_programs_tallies(monkeypatch):
    read = manifest.reader("decode_graph_share.decode")
    rec = types.SimpleNamespace(tallies=lambda: {
        "serve.graph.eager": 3, "serve.graph.capture": 3,
        "serve.graph.replay": 252, "train.graph.eager": 40})
    monkeypatch.setitem(sys.modules, S.PROGRAM_RECORD, rec)
    assert read(Run({}, {})) == pytest.approx(100.0 * 252 / 255)
    rec.tallies = lambda: {"train.graph.eager": 1,       # no decode step ran
                           "train.graph.replay": 9}
    assert read(Run({}, {})) is None


def test_decode_graph_share_is_none_without_the_tallies(monkeypatch):
    read = manifest.reader("decode_graph_share.decode")
    monkeypatch.setitem(sys.modules, S.PROGRAM_RECORD, types.SimpleNamespace(
        spans=lambda: [], counters=lambda: []))
    assert read(Run({}, {})) is None
    monkeypatch.delitem(sys.modules, S.PROGRAM_RECORD)
    assert read(Run({}, {})) is None
