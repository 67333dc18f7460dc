"""The statistics over a stall: a rate counts all of the window's time,
and quantiles count every sample."""
from __future__ import annotations

import statistics

import pytest

from portbench.harness import stats as S


def test_rate_counts_the_stall():
    steps = [0.8] * 30 + [5.0]            # one stalled step
    assert S.rate(31 * 8192, sum(steps)) == pytest.approx(31 * 8192 / 29.0)
    with pytest.raises(ValueError):
        S.rate(1, 0.0)


def test_median_and_p95_take_every_sample():
    gaps = [0.05] * 95 + [0.5] * 5
    assert S.median(gaps) == 0.05
    assert S.percentile(gaps, 95) == pytest.approx(
        statistics.quantiles(gaps, n=100)[94])
    assert 0.05 < S.percentile(gaps, 95) <= 0.5
    gaps = [0.05] * 90 + [0.5] * 10
    assert S.percentile(gaps, 95) == 0.5
    assert S.percentile([3.0], 95) == 3.0


@pytest.mark.parametrize("name", ["chat", "prefill_4k"])
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 9 * 10**9 + 7])
def test_every_window_sends_whole_blocks(name, seed):
    """A window of ``run_seconds`` sends whole blocks: the same lengths
    at the same times for every seed, in another order."""
    import json
    from portbench.harness import manifest
    from portbench.harness import traffic as T
    m = manifest.load_manifest()
    tr = json.loads((manifest.ROOT / "portbench" / "traffic"
                     / f"{name}.json").read_text())
    reqs = T.requests(tr, seed, m["run_seconds"])
    ref = T.requests(tr, 3, m["run_seconds"])
    assert len(reqs) % tr["block"] == 0
    assert [r.arrival_s for r in reqs] == [r.arrival_s for r in ref]
    assert sorted(r.prompt_len for r in reqs) == \
        sorted(r.prompt_len for r in ref)
    share = {int(k): w for k, w in tr["prompt_len"].items()}
    for length, w in share.items():
        assert sum(r.prompt_len == length for r in reqs) == \
            round(w * len(reqs))
    with pytest.raises(ValueError):
        T.requests(dict(tr, block=len(reqs) + 1, prompt_len={
            str(min(share)): 1.0}), seed, m["run_seconds"])


def test_step_idle_share_is_of_the_untraced_step():
    """The device's busy time in the traced steps over the median
    untraced step: a traced step the profiler made longer on the host
    does not count as idle."""
    from portbench.harness.readers import Run, step_idle_share
    from portbench.harness.trace import Activity, Trace
    ms = 1_000_000
    acts = [Activity(s * ms, (s + 700) * ms, "k", 0, s * ms, True)
            for s in (0, 2000)]
    spans = {"portbench.step": [(0, 1500 * ms, 0), (2000 * ms, 3500 * ms, 0)]}
    run = Run({}, {}, timeline=Trace(acts, [], spans, []),
              steps=[0.8, 0.8, 0.9, 5.0])
    assert step_idle_share(run, "portbench.step") == pytest.approx(
        100 * (1 - 0.7 / 0.85))
    assert step_idle_share(Run({}, {}, timeline=run.timeline),
                           "portbench.step") is None
