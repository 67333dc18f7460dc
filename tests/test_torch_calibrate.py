"""The port's kernel calibrator and its cost cells against the JAX
package's: the cache, determinism and unknown-operator contract of
tests/test_scenario.py, on the CPU (``device="cpu"``).

The two packages count FLOPs differently: the port counts each operator
by its custom op's formula (``FlopCounterMode``), the JAX package reads
XLA's cost analysis of the interpret-mode Pallas program, which costs
one pass of the kernel's grid loop. So their ``flops_per_record`` are
reported side by side as a ratio, not required to be equal. From equal
profiles, the cost cells and the priced trace must be equal."""
import dataclasses
import math
import random
from types import SimpleNamespace

import pytest
import torch

from repro import hardware as ref_hw
from repro.core import simulator as ref_sim
from repro.core import tasks as ref_tasks
from repro.scenario import calibrate as ref_cal
from repro.scenario import engine as ref_engine
from repro.scenario import profiles as ref_profiles
from repro_torch import hardware as port_hw
from repro_torch.core import simulator as port_sim
from repro_torch.core import tasks as port_tasks
from repro_torch.scenario import (HintedVPTR, KernelCalibrator,
                                  ServiceProfile, ServiceSLO,
                                  analytics_cost_model, calibrate_profiles)
from repro_torch.scenario import calibrate as port_cal_mod
from repro_torch.scenario.engine import _fresh_heuristic

torch.set_num_threads(2)

# the port's counts at the JAX package's canonical shapes
# (scenario/calibrate.py): 4·d per kept causal pair, 256·257/2 pairs per
# head, 2 heads, 256 records; the four chunk products at chunk 64, 2
# chunks, 2 heads, 128 records
EXPECTED = {"flash_attention": 65_792.0, "ssd_scan": 28_672.0}
CASES = [("window_agg", "max", 3), ("window_agg", "sum", 3),
         ("window_agg", "mean", 1), ("ssd_scan", "max", 2),
         ("flash_attention", "max", 2)]
CFG = SimpleNamespace(records_per_step=5_000, mxu_efficiency=0.5,
                      dc_step_floor_s=1e-3)     # the EngineConfig defaults


@pytest.fixture(scope="module")
def port_cal():
    return KernelCalibrator(device="cpu")


def test_calibrator_measures_and_caches(port_cal):
    cal = KernelCalibrator(device="cpu")
    c1 = cal.measure("window_agg", agg="max", m=2)
    c2 = cal.measure("window_agg", agg="max", m=2)
    assert c1 is c2
    assert c1.flops_per_record > 0 and c1.source == "flop-counter"
    assert len(cal.log) == 1 and cal.report() == [dataclasses.asdict(c1)]
    assert (KernelCalibrator(device="cpu").measure("window_agg", agg="max",
                                                   m=2) == c1)
    assert cal.measure("window_agg", agg="count", m=2) == cal.measure(
        "window_agg", agg="sum", m=2)
    with pytest.raises(ValueError, match="unknown operator"):
        cal.measure("not_a_kernel")


@pytest.mark.parametrize("op,entry", [("window_agg", "window_aggregate"),
                                      ("ssd_scan", "ssd_scan"),
                                      ("flash_attention", "flash_attention")])
def test_calibrator_dry_runs_each_type_the_kernels_take(monkeypatch, op,
                                                        entry):
    """One dry-run in float32 and one in bfloat16 (on the card, flash
    attention's two kernels), counted once."""
    seen, real = [], getattr(port_cal_mod, entry)

    def spy(x, *args, **kwargs):
        seen.append(x.dtype)
        return real(x, *args, **kwargs)

    monkeypatch.setattr(port_cal_mod, entry, spy)
    cal = KernelCalibrator(device="cpu").measure(op, agg="max", m=2)
    assert seen == list(port_cal_mod.DRY_RUN_DTYPES)
    assert cal == KernelCalibrator(device="cpu").measure(op, agg="max", m=2)


def test_calibrator_defaults_to_the_card():
    if torch.cuda.is_available():
        assert KernelCalibrator().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            KernelCalibrator()


@pytest.mark.parametrize("op,agg,m", CASES)
def test_flops_per_record_against_jax(port_cal, op, agg, m):
    """Both packages measure; the port's number is its formula's, and the
    ratio to the JAX package's XLA count is reported."""
    port = port_cal.measure(op, agg=agg, m=m)
    ref = ref_cal.KernelCalibrator().measure(op, agg=agg, m=m)
    assert port.source == "flop-counter"
    assert ref.source in ("xla-cost-analysis", "analytic")
    assert (port.operator, port.agg, port.m, port.n_records) == (
        ref.operator, ref.agg, ref.m, ref.n_records)
    assert port.flops_per_record == port.flops_total / port.n_records
    if op in EXPECTED:
        assert port.flops_per_record == EXPECTED[op]
    else:     # T·C + (m − 1)·n_out·C (+ n_out·C for the mean), C = 1
        T, n_out = port.n_records, 4 * m - m + 1
        want = T + (m - 1) * n_out + (n_out if agg == "mean" else 0)
        assert port.flops_total == want
    ratio = port.flops_per_record / ref.flops_per_record
    assert math.isfinite(ratio) and ratio > 0
    print(f"{op} {agg} m={m}: port {port.flops_per_record:.2f} / JAX "
          f"{ref.flops_per_record:.2f} ({ref.source}) = {ratio:.3f}")


def _services():
    slo = ServiceSLO(soft_latency_s=0.05, hard_latency_s=0.5, gamma=2.0)
    return [SimpleNamespace(name="q1_max", operator="window_agg", agg="max",
                            width_s=180.0, slide_s=60.0, slo=slo,
                            bytes_per_record=8.0),
            SimpleNamespace(name="ssm", operator="ssd_scan", agg="mean",
                            width_s=120.0, slide_s=60.0, slo=slo,
                            bytes_per_record=64.0),
            SimpleNamespace(name="attn", operator="flash_attention",
                            agg="mean", width_s=60.0, slide_s=60.0, slo=slo,
                            bytes_per_record=512.0)]


def _fire_tasks(tasks_mod, profiles, cost, n=90, seed=0):
    """A seeded trace of DC fires built the way ScenarioEngine._make_task
    builds them: one task per fire, ceil(window / records_per_step) steps
    on the plan's chips, the SLO shifted by the delay before the task."""
    rng = random.Random(seed)
    names, ts, out = sorted(profiles), 0.0, []
    for tid in range(n):
        name = names[tid % len(names)]
        ts += rng.expovariate(1 / 0.02)
        arrival = ts + rng.uniform(0.0, 0.05)
        n_window = rng.randint(1_000, 400_000)
        chips = rng.choice((4, 8, 16, 32))
        tt = tasks_mod.TaskType(f"svc:{name}", "window",
                                allowable_chips=(chips,))
        task = tasks_mod.Task(
            tid=tid, ttype=tt, arrival=arrival,
            steps=max(1, math.ceil(n_window / CFG.records_per_step)),
            value=profiles[name].slo.value_spec(arrival - ts + 0.01),
            hbm_bytes=cost.hbm_bytes(f"svc:{name}", "window"))
        task.dvfs_hint = rng.choice((1.0, 0.8, 0.6))
        out.append(task)
    return out


def test_calibrated_profiles_price_like_the_reference(port_cal):
    """calibrate_profiles → analytics_cost_model → Simulator(HintedVPTR):
    from equal profiles both packages build equal cells and equal
    SimResults."""
    profiles, cal = calibrate_profiles(
        SimpleNamespace(services=_services()), port_cal)
    assert cal is port_cal and sorted(profiles) == ["attn", "q1_max", "ssm"]
    assert profiles["attn"].flops_per_record == EXPECTED["flash_attention"]
    assert profiles["ssm"].flops_per_record == EXPECTED["ssd_scan"]
    ref_prof = {n: ref_profiles.ServiceProfile(
        slo=ref_profiles.ServiceSLO(**dataclasses.asdict(p.slo)),
        flops_per_record=p.flops_per_record,
        bytes_per_record=p.bytes_per_record, operator=p.operator)
        for n, p in profiles.items()}
    port_prof = {n: ServiceProfile(slo=ServiceSLO(**dataclasses.asdict(p.slo)),
                                   flops_per_record=p.flops_per_record,
                                   bytes_per_record=p.bytes_per_record,
                                   operator=p.operator)
                 for n, p in profiles.items()}
    ref_cost = ref_engine.analytics_cost_model(ref_prof, CFG)
    port_cost = analytics_cost_model(port_prof, CFG)
    assert sorted(port_cost.cells) == sorted(ref_cost.cells)
    for key, cell in ref_cost.cells.items():
        assert dataclasses.astuple(port_cost.cells[key]) == \
            dataclasses.astuple(cell)

    results = []
    for sim, tasks, prof, cost, hint in (
            (ref_sim, ref_tasks, ref_prof, ref_cost, ref_engine.HintedVPTR()),
            (port_sim, port_tasks, port_prof, port_cost, HintedVPTR())):
        r = sim.Simulator(hint, cost).run(_fire_tasks(tasks, prof, cost))
        results.append((r.vos, r.perf_value, r.energy_value, r.completed,
                        r.dropped, r.total_energy_j, r.makespan,
                        r.avg_utilization, r.vos_normalized,
                        [(t.tid, t.start, t.finish, t.dvfs_f, t.earned)
                         for t in r.tasks]))
    assert results[1] == results[0]
    assert results[1][3] + results[1][4] == 90 and results[1][0] > 0
    assert {t[3] for t in results[1][-1] if t[1] is not None} <= {1.0, 0.8,
                                                                  0.6}


@pytest.mark.parametrize("name", ["hinted", "VPTR", "Hybrid"])
def test_fresh_heuristic(name):
    h, ref = _fresh_heuristic(name), ref_engine._fresh_heuristic(name)
    assert type(h).__name__ == type(ref).__name__ and h.name == ref.name
    assert h is not _fresh_heuristic(name)


def test_hardware_constants_equal():
    """The simulated TPU-v5e pod the DES prices, not the card: unchanged,
    so the port's VoS equals the JAX package's (DVFS states by value)."""
    names = [n for n in dir(ref_hw) if n.isupper()]
    assert len(names) > 15
    assert [repr(getattr(port_hw, n)) for n in names] == [
        repr(getattr(ref_hw, n)) for n in names]
