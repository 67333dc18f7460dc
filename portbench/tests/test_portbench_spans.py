"""The readers of the program's spans (``harness/spans.py`` and the six
metrics that use it) on synthetic traces: an activity counts under a
range only when launched on the range's thread, once however many
ranges nest around it, and a recompute inside a backward part counts
for the ranges it recomputes, not for that part; the base is every
activity launched in the step; each reader gives None without its
spans."""
from __future__ import annotations

import sys
import types

import pytest

from portbench.harness import manifest
from portbench.harness import spans as S
from portbench.harness.readers import Run
from portbench.harness.trace import Activity, OpCall, Trace

MS = 1_000_000
MAIN, BWD = 1, 2                 # the caller's thread, autograd's


def act(launch_ms, device_ms, thread=MAIN, start_ms=None):
    s = (launch_ms if start_ms is None else start_ms) * MS
    return Activity(s, s + device_ms * MS, "k", thread, launch_ms * MS, True)


def rng(name, lo, hi, thread=MAIN):
    return (lo * MS, hi * MS, S.PREFIX + name, thread)


def trace(acts, host, ops=(), steps=((0, 100),)):
    return Trace(sorted(acts, key=lambda a: a.start_ns), list(ops),
                 {S.STEP: [(lo * MS, hi * MS, MAIN) for lo, hi in steps]},
                 sorted(host))


def test_another_threads_launch_is_not_counted():
    t = trace([act(10, 4, MAIN), act(11, 6, BWD), act(50, 10, MAIN)],
              [rng("weight_cast", 5, 20, MAIN)])
    assert S.step_share(t, ["weight_cast"]) == pytest.approx(100 * 4 / 20)


def test_nested_ranges_count_once():
    t = trace([act(10, 4), act(12, 6), act(60, 10)],
              [rng("moe.dispatch", 5, 20), rng("weight_cast", 8, 15),
               rng("moe.combine", 9, 13)])
    assert S.step_share(t, ["moe.dispatch", "moe.combine", "weight_cast"]) \
        == pytest.approx(100 * 10 / 20)


def test_backward_parts_count_on_their_own_thread():
    t = trace([act(10, 2, MAIN), act(40, 3, BWD), act(41, 5, MAIN)],
              [rng("ssm", 5, 20, MAIN), rng("ssm.backward", 35, 45, BWD)])
    assert S.step_share(t, ["ssm"]) == pytest.approx(100 * 5 / 10)


def test_a_recompute_inside_a_backward_part_is_not_that_parts():
    """Under remat the layer runs again inside the backward part of the
    op whose saved tensors autograd unpacked first: the recomputed
    ``attn`` and its cast are theirs, the recomputed dispatch the
    dispatch's, the rest of the part the combine's."""
    host = [rng("moe.combine.backward", 60, 80, BWD),
            rng("attn", 62, 66, BWD), rng("weight_cast", 63, 64, BWD),
            rng("moe", 66, 71, BWD), rng("moe.dispatch", 67, 70, BWD)]
    acts = [act(61, 2, BWD), act(63, 1, BWD), act(65, 3, BWD),
            act(68, 4, BWD), act(69, 5, BWD, start_ms=72),
            act(75, 6, BWD)]
    t = trace(acts, host)
    assert S.step_share(t, ["moe.dispatch", "moe.combine"]) == \
        pytest.approx(100 * (2 + 4 + 5 + 6) / 21)
    assert S.step_share(t, ["weight_cast"]) == pytest.approx(100 * 1 / 21)
    assert S.step_share(t, ["attn"]) == pytest.approx(100 * 4 / 21)
    assert S.step_share(t, ["moe"]) == pytest.approx(100 * 9 / 21)


def test_open_ranges_innermost_first():
    t = trace([], [rng("train.backward", 0, 90), rng("moe.backward", 10, 50),
                   rng("moe.combine.backward", 10, 30),
                   rng("attn", 12, 20), rng("head", 60, 70)])
    chains = [c for _, c in S.open_at(t, [act(15, 1), act(25, 1),
                                          act(55, 1), act(95, 1)])]
    assert chains == [["attn", "moe.combine.backward", "moe.backward",
                       "train.backward"],
                      ["moe.combine.backward", "moe.backward",
                       "train.backward"],
                      ["train.backward"], []]


def test_base_is_every_activity_launched_in_the_step():
    unlinked = act(10, 4)
    unlinked.launch_ns = -1                 # never tied to a launch
    t = trace([unlinked, act(12, 5), act(30, 6, BWD), act(150, 50)],
              [rng("train.optimizer", 5, 20)], steps=((0, 100),))
    assert S.step_share(t, ["train.optimizer"]) == pytest.approx(
        100 * 5 / 11)


def test_ops_inside_are_left_out():
    ops = [OpCall("repro_torch::ssd_scan", [], [], MAIN, 8 * MS, 12 * MS),
           OpCall("repro_torch::ssd_scan_backward", [], [], BWD, 40 * MS,
                  44 * MS),
           OpCall("repro_torch::flash_attention", [], [], MAIN, 15 * MS,
                  18 * MS)]
    t = trace([act(9, 5), act(16, 1), act(42, 3, BWD), act(43, 7, MAIN)],
              [rng("ssm", 5, 20), rng("ssm.backward", 35, 45, BWD)], ops)
    assert S.step_share(t, ["ssm"], minus_ops="repro_torch::ssd_scan") \
        == pytest.approx(100 * 1 / 16)


STEP_READERS = ["moe_dispatch_share.train", "ssm_outside_scan_share.train",
                "optimizer_share.train", "weight_cast_share.train"]


@pytest.mark.parametrize("metric", STEP_READERS)
def test_step_readers_give_none_without_their_spans(metric):
    read = manifest.reader(metric)
    t = trace([act(10, 4)], [rng("head", 5, 20)])
    assert read(Run({}, {}, ops=t)) is None
    assert read(Run({}, {})) is None


def test_step_readers_read_their_own_spans():
    host = [rng("moe.dispatch", 1, 10), rng("moe.combine", 10, 20),
            rng("moe.combine.backward", 60, 70, BWD),
            rng("ssm", 20, 30), rng("train.optimizer", 80, 90),
            rng("weight_cast", 2, 3), rng("weight_cast.backward", 61, 62, BWD)]
    acts = [act(2, 1), act(12, 2), act(61, 3, BWD), act(25, 4),
            act(85, 10), act(95, 80)]
    run = Run({}, {}, ops=trace(acts, host))
    read = {m: manifest.reader(m)(run) for m in STEP_READERS}
    assert read == pytest.approx({
        "moe_dispatch_share.train": 100 * 6 / 100,
        "ssm_outside_scan_share.train": 100 * 4 / 100,
        "optimizer_share.train": 100 * 10 / 100,
        "weight_cast_share.train": 100 * 4 / 100})


def fake_record(monkeypatch, spans=(), counters=()):
    rec = types.SimpleNamespace(spans=lambda: list(spans),
                                counters=lambda: list(counters))
    monkeypatch.setitem(sys.modules, S.PROGRAM_RECORD, rec)


def span(name, lo, hi, thread=7):
    return types.SimpleNamespace(name=name, start_ns=lo * MS, end_ns=hi * MS,
                                 thread=thread, phase="forward")


def load(at, value, C, first=0, experts=None):
    return types.SimpleNamespace(
        name="moe.expert_load", value=value, at_ns=at * MS,
        attrs={"capacity": C, "assignments": sum(value), "first": first,
               "experts": len(value) if experts is None else experts})


def test_dropped_share_over_the_traced_steps(monkeypatch):
    read = manifest.reader("moe_dropped.train")
    fake_record(monkeypatch, counters=[
        load(10, [5, 1, 2], 3), load(40, [4, 4, 0], 3),
        load(500, [9, 0, 0], 3)])                 # outside every step
    timeline = Trace([], [], {S.STEP: [(30 * MS, 60 * MS, -1)]}, [])
    run = Run({}, {}, ops=trace([], []), timeline=timeline)
    assert read(run) == pytest.approx(100 * (2 + 1 + 1) / (8 + 8))
    assert read(Run({}, {})) is None
    monkeypatch.delitem(sys.modules, S.PROGRAM_RECORD)
    assert read(run) is None


def test_dropped_share_counts_the_local_experts_only(monkeypatch):
    read = manifest.reader("moe_dropped.train")
    fake_record(monkeypatch, counters=[load(10, [9, 1, 6, 2], 4, first=2,
                                            experts=2)])
    assert read(Run({}, {}, ops=trace([], []))) == pytest.approx(
        100 * 2 / 18)


def test_host_share_of_the_decode_spans(monkeypatch):
    read = manifest.reader("moe_host_share.decode")
    decode = [(0, 100), (200, 300)]
    timeline = Trace([], [], {"portbench.decode": [
        (lo * MS, hi * MS, -1) for lo, hi in decode]}, [])
    fake_record(monkeypatch, spans=[
        span("serve.decode", 1, 99), span("serve.decode", 201, 299),
        span("moe", 10, 30), span("moe", 25, 40),      # overlap once
        span("moe", 210, 250),
        span("moe", 220, 240, thread=8),               # another thread
        span("moe", 150, 190),                         # between decodes
        span("attn", 60, 90)])
    assert read(Run({}, {}, timeline=timeline)) == pytest.approx(
        100 * (30 + 40) / 200)
    fake_record(monkeypatch, spans=[span("serve.decode", 1, 99)])
    assert read(Run({}, {}, timeline=timeline)) is None
    monkeypatch.delitem(sys.modules, S.PROGRAM_RECORD)
    assert read(Run({}, {}, timeline=timeline)) is None
    assert read(Run({}, {})) is None


def test_the_program_record_is_read_not_imported():
    """The benchmark reaches the program through the adapter: reading
    the record loads nothing of the program."""
    before = {m for m in sys.modules if m.split(".")[0] == "repro_torch"}
    if S.PROGRAM_RECORD not in before:
        assert S.program_record() is None
    after = {m for m in sys.modules if m.split(".")[0] == "repro_torch"}
    assert after == before
