"""The reader of ``train_graph_share.train`` on a fake program record:
the share of the train-step calls that replayed the step's CUDA graph,
from the program's tallies; None without a record, without tallies (a
program older than them) or without a train-step call."""
from __future__ import annotations

import sys
import types

import pytest

from portbench.harness import manifest
from portbench.harness import spans as S
from portbench.harness.readers import Run


def test_graph_share_reads_the_programs_tallies(monkeypatch):
    read = manifest.reader("train_graph_share.train")
    rec = types.SimpleNamespace(tallies=lambda: {
        "train.graph.eager": 5, "train.graph.capture": 2,
        "train.graph.replay": 95})
    monkeypatch.setitem(sys.modules, S.PROGRAM_RECORD, rec)
    assert read(Run({}, {})) == pytest.approx(95.0)
    rec.tallies = lambda: {}                       # no train step ran
    assert read(Run({}, {})) is None


def test_graph_share_is_none_without_the_tallies(monkeypatch):
    read = manifest.reader("train_graph_share.train")
    monkeypatch.setitem(sys.modules, S.PROGRAM_RECORD, types.SimpleNamespace(
        spans=lambda: [], counters=lambda: []))
    assert read(Run({}, {})) is None
    monkeypatch.delitem(sys.modules, S.PROGRAM_RECORD)
    assert read(Run({}, {})) is None
