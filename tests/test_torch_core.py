"""The port's JITA-4DS core against the JAX package's: the same cases as
tests/test_value.py, test_vdc.py, test_simulator.py and test_elastic.py,
run through both packages on the same seeded inputs. The core is carried
as it is, so every value, tile, SimResult field and cost cell must be
equal, not close."""
import copy
import dataclasses
import importlib
import math
import statistics as stats
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

_MODULES = ("hardware", "configs", "roofline", "utils.hlo", "core.value",
            "core.tasks", "core.vdc", "core.costmodel", "core.heuristics",
            "core.simulator", "core.elastic")


def _package(name):
    mods = {m.split(".")[-1]: importlib.import_module(f"{name}.{m}")
            for m in _MODULES}
    return SimpleNamespace(**mods)


REF, PORT = _package("repro"), _package("repro_torch")
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["jax", "port"])

ARCHS = ["smollm-135m", "qwen3-1.7b", "yi-6b", "olmoe-1b-7b", "mamba2-1.3b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
HEURISTICS = ("Simple", "VPT", "VPTR", "VPT-CPC", "VPT-JSPC", "Hybrid")


def _task(t):
    return (t.tid, t.ttype.name, t.steps, t.arrival, t.start, t.finish,
            t.chips, t.dvfs_f, t.energy_j, t.earned, t.dropped)


def _result(r):
    """Every field of a SimResult, its tasks' bookkeeping included."""
    return (r.heuristic, r.vos, r.perf_value, r.energy_value, r.completed,
            r.dropped, r.total_energy_j, r.makespan, r.avg_utilization,
            r.vos_normalized, [_task(t) for t in r.tasks])


_COSTS = {}


def _cost(pkg):
    """CostModel.analytic() of the package, built once per process."""
    key = pkg.hardware.__name__
    if key not in _COSTS:
        _COSTS[key] = pkg.costmodel.CostModel.analytic()
    return _COSTS[key]


def _trace(pkg, i, n=150):
    types = [pkg.tasks.TaskType(a, s) for a in ARCHS for s in SHAPES]
    return pkg.tasks.WorkloadGenerator(types, _cost(pkg), seed=100 + i,
                                       **pkg.tasks.PAPER_REGIME).trace(n)


# ------------------------------------------------------------------ value
def _curves(rng, n):
    for _ in range(n):
        v_min = float(rng.uniform(0.0, 1.0))
        v_max = float(rng.uniform(v_min, v_min + 10.0))
        soft = float(rng.uniform(0.01, 1e6))
        hard = soft * float(rng.uniform(1.0, 10.0))
        shape = ("linear", "exponential")[int(rng.integers(2))]
        yield v_max, v_min, soft, hard, shape


@pytest.mark.parametrize("seed", range(4))
def test_value_curves_equal(seed):
    rng = np.random.default_rng(seed)
    for args in _curves(rng, 50):
        ref, port = REF.value.ValueCurve(*args), PORT.value.ValueCurve(*args)
        xs = sorted(float(x) for x in rng.uniform(0.01, 1e6, 10))
        xs += [port.th_soft, port.th_hard, port.th_hard * 1.0001]
        vals = [port.value(x) for x in xs]
        assert vals == [ref.value(x) for x in xs]
        # the properties of tests/test_value.py, on the port
        for x, v in zip(xs, vals):
            assert 0.0 <= v <= port.v_max
            assert v == port.v_max if x <= port.th_soft else True
            assert v == 0.0 if x > port.th_hard else True
        srt = sorted(zip(xs, vals))
        assert all(a[1] >= b[1] - 1e-12 for a, b in zip(srt, srt[1:]))


@pytest.mark.parametrize("seed", range(4))
def test_task_value_equal_and_zero_rule(seed):
    rng = np.random.default_rng(100 + seed)
    for pc, ec in zip(_curves(rng, 25), _curves(rng, 25)):
        gamma, w_p = float(rng.uniform(0.1, 8)), float(rng.uniform(0, 1))
        lat, en = (float(v) for v in rng.uniform(0.01, 1e6, 2))
        vals = []
        for pkg in (REF, PORT):
            spec = pkg.value.TaskValueSpec(
                gamma=gamma, w_p=w_p, w_e=1 - w_p,
                perf_curve=pkg.value.ValueCurve(*pc),
                energy_curve=pkg.value.ValueCurve(*ec))
            vals.append(pkg.value.task_value(spec, lat, en))
        assert vals[0] == vals[1]
        if (PORT.value.ValueCurve(*pc).value(lat) == 0.0
                or PORT.value.ValueCurve(*ec).value(en) == 0.0):
            assert vals[1] == 0.0


@BOTH
def test_vos_total_and_invalid_curves(pkg):
    assert pkg.value.vos_total([1.0, 2.5, 0.0]) == 3.5
    with pytest.raises(ValueError):
        pkg.value.ValueCurve(1.0, 0.0, 10.0, 5.0)
    with pytest.raises(ValueError):
        pkg.value.ValueCurve(1.0, 2.0, 1.0, 5.0)


# -------------------------------------------------------------------- vdc
def _grid_state(grid):
    return (grid.used_chips, grid.free_chips,
            sorted((v.tile.x, v.tile.y, v.tile.w, v.tile.h, v.chips)
                   for v in grid.used.values()))


@pytest.mark.parametrize("seed", range(6))
def test_vdc_alloc_free_same_tiles(seed):
    """The buddy allocator composes the same tiles in both packages under
    one seeded sequence of composes and releases."""
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.choice([4, 8, 16, 32, 64, 128, 256], 30)]
    grids = [REF.vdc.PodGrid(), PORT.vdc.PodGrid()]
    live = [[], []]
    for s in sizes:
        got = [g.compose(s, 1.0, task_id=0) for g in grids]
        assert (got[0] is None) == (got[1] is None)
        if got[1] is not None:
            assert got[1].chips == s
            for lv, v in zip(live, got):
                lv.append(v)
        assert _grid_state(grids[0]) == _grid_state(grids[1])
        assert grids[1].used_chips + grids[1].free_chips == 256
        if live[1] and rng.random() < 0.4:
            i = int(rng.integers(len(live[1])))
            for g, lv in zip(grids, live):
                g.release(lv.pop(i))
    for g, lv in zip(grids, live):
        for v in lv:
            g.release(v)
        assert g.free_chips == 256
        assert g.compose(256, 1.0, 0) is not None


@BOTH
def test_vdc_full_then_none_and_rejects(pkg):
    grid = pkg.vdc.PodGrid()
    assert grid.compose(256, 1.0, 0) is not None
    assert grid.compose(4, 1.0, 1) is None
    with pytest.raises(ValueError):
        pkg.vdc.PodGrid().compose(24, 1.0, 0)


# ---------------------------------------------------------------- costs
# the port's architectures that the JAX package does not have
PORT_ONLY_ARCHS = ["granite-4.0-h-small"]
# ArchConfig fields the JAX package does not have, at their defaults on
# every architecture both packages have
PORT_ONLY_FIELDS = {"routed_experts": 0, "shared_expert_ff": 0,
                    "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
                    "attention_multiplier": 0.0, "ssm_conv_bias": False}


def test_costmodel_analytic_cells_equal_for_every_arch_and_shape():
    archs = REF.configs.list_archs()
    assert len(archs) == 10
    assert PORT.configs.list_archs() == sorted(archs + PORT_ONLY_ARCHS)
    ref = REF.costmodel.CostModel.analytic()
    port_all = PORT.costmodel.CostModel.analytic()
    port = PORT.costmodel.CostModel.analytic(archs)
    keys = [(a, s) for a in archs for s in REF.configs.SHAPES]
    assert sorted(port.cells) == sorted(ref.cells) == sorted(keys)
    assert sorted(port_all.cells) == sorted(
        keys + [(a, s) for a in PORT_ONLY_ARCHS for s in REF.configs.SHAPES])
    for key in keys:
        assert (dataclasses.astuple(port.cells[key])
                == dataclasses.astuple(ref.cells[key]))
        for chips in (16, 64, 256):
            for f in (1.0, 0.7):
                assert (port.time_per_step(*key, chips, f)
                        == ref.time_per_step(*key, chips, f))
                assert (port.energy_per_step(*key, chips, f)
                        == ref.energy_per_step(*key, chips, f))
        assert port.min_chips(*key) == ref.min_chips(*key)


def test_configs_and_roofline_equal():
    def shared_fields(cfg):
        d = dataclasses.asdict(cfg)
        assert {k: d.pop(k) for k in PORT_ONLY_FIELDS} == PORT_ONLY_FIELDS
        return d
    for a in REF.configs.list_archs():
        ra, pa = REF.configs.get_arch(a), PORT.configs.get_arch(a)
        assert shared_fields(pa) == dataclasses.asdict(ra)
        assert pa.param_counts() == ra.param_counts()
        assert shared_fields(pa.reduced()) == dataclasses.asdict(
            ra.reduced())
        for s in REF.configs.SHAPES:
            assert (PORT.roofline.model_flops(pa, PORT.configs.SHAPES[s])
                    == REF.roofline.model_flops(ra, REF.configs.SHAPES[s]))
            assert (PORT.configs.supports_shape(pa, PORT.configs.SHAPES[s])
                    == REF.configs.supports_shape(ra, REF.configs.SHAPES[s]))
    hlo = "\n".join([
        "%ag = bf16[16,4096,128]{2,1,0} all-gather(%x), "
        "replica_groups=[2,8]<=[16]",
        "%ar = f32[1024]{0} all-reduce-start(%y), replica_groups={{0,1,2,3}}",
        "%ar2 = f32[1024]{0} all-reduce-done(%ar)",
        "%cp = (f32[8], s32[8]) collective-permute(%z)"])
    ref, port = REF.hlo.parse_collectives(hlo), PORT.hlo.parse_collectives(hlo)
    assert (port.counts, port.bytes_by_kind) == (ref.counts, ref.bytes_by_kind)
    assert port.total_bytes > 0


# ------------------------------------------------------------ simulator
@pytest.mark.parametrize("name", HEURISTICS)
def test_simresult_equal(name):
    """One paper-regime trace of 150 jobs, every SimResult field equal,
    and the conservation of tests/test_simulator.py on the port."""
    res = [pkg.simulator.Simulator(pkg.heuristics.HEURISTICS[name],
                                   _cost(pkg)).run(_trace(pkg, 0))
           for pkg in (REF, PORT)]
    assert _result(res[1]) == _result(res[0])
    assert res[1].completed + res[1].dropped == 150
    assert 0.0 <= res[1].vos_normalized <= 1.0


def test_fig4_band_equal():
    out = []
    for pkg in (REF, PORT):
        hs = [pkg.heuristics.HEURISTICS[n] for n in ("Simple", "VPTR")]
        out.append(pkg.simulator.compare_heuristics(
            hs, _cost(pkg), lambda i, pkg=pkg: _trace(pkg, i), n_traces=4))
    for n in ("Simple", "VPTR"):
        assert [_result(r) for r in out[1][n]] == [_result(r)
                                                    for r in out[0][n]]
    res = out[1]

    def mean(k, n):
        return stats.mean(getattr(r, k) for r in res[n])
    gain = mean("vos_normalized", "VPTR") / mean("vos_normalized", "Simple")
    assert 0.20 < gain - 1 < 1.30


@pytest.mark.parametrize("frac", [0.55, 0.70, 0.85])
def test_fig5_power_caps_equal(frac):
    names = ["VPT", "VPT-CPC", "VPT-JSPC", "Hybrid"]
    out = []
    for pkg in (REF, PORT):
        out.append(pkg.simulator.compare_heuristics(
            [pkg.heuristics.HEURISTICS[n] for n in names], _cost(pkg),
            lambda i, pkg=pkg: _trace(pkg, i), n_traces=3,
            power_cap_w=pkg.hardware.pod_power_cap_w(frac)))
    for n in names:
        assert [_result(r) for r in out[1][n]] == [_result(r)
                                                    for r in out[0][n]]


def test_power_cap_assignments_equal_and_capped():
    got = []
    for pkg in (REF, PORT):
        cap = pkg.hardware.pod_power_cap_w(0.55)
        grid = pkg.vdc.PodGrid()
        cost = _cost(pkg)
        assigns = pkg.heuristics.HEURISTICS["VPT-JSPC"].assign(
            _trace(pkg, 0)[:30], grid, cost, now=1e4, power_cap_w=cap)
        total = grid.power_w(cost) + sum(cost.power_w(c, f)
                                         for _, c, f in assigns)
        assert total <= cap + grid.free_chips * pkg.hardware.CHIP_STATIC_W
        got.append([(t.tid, c, f) for t, c, f in assigns])
    assert got[1] == got[0]


def test_incremental_feed_equal_to_one_shot_and_reference():
    out = []
    for pkg in (REF, PORT):
        trace = _trace(pkg, 3)[:60]
        cost = _cost(pkg)
        one = pkg.simulator.Simulator(pkg.heuristics.HEURISTICS["VPTR"],
                                      cost).run(copy.deepcopy(trace))
        sim = pkg.simulator.Simulator(pkg.heuristics.HEURISTICS["VPTR"], cost)
        sim.begin()
        mid = trace[len(trace) // 2].arrival
        for t in trace:
            if t.arrival <= mid:
                sim.inject(t)
        sim.run_until(mid)
        for t in trace:
            if t.arrival > mid:
                sim.inject(t)
        inc = sim.finalize()
        assert (inc.vos, inc.completed, inc.dropped, inc.total_energy_j) == (
            one.vos, one.completed, one.dropped, one.total_energy_j)
        out.append(_result(inc))
    assert out[1] == out[0]


def test_late_inject_and_withdraw_equal():
    out = []
    for pkg in (REF, PORT):
        cost = _cost(pkg)
        late = copy.deepcopy(_trace(pkg, 4)[0])
        late.arrival = 0.0
        sim = pkg.simulator.Simulator(pkg.heuristics.HEURISTICS["VPTR"], cost)
        sim.begin()
        sim.run_until(5_000.0)
        sim.inject(late)
        r1 = sim.finalize()
        assert r1.completed + r1.dropped == 1
        assert late.finish is None or late.finish >= 5_000.0

        trace = _trace(pkg, 5)[:3]
        sim = pkg.simulator.Simulator(pkg.heuristics.HEURISTICS["VPTR"], cost,
                                      grid=pkg.vdc.PodGrid(4, 4))
        sim.begin()
        for t in trace:
            sim.inject(t)
        sim.run_until(max(t.arrival for t in trace) + 1e-6)
        target = next(iter(sim.pending_tasks()), None)
        if target is not None:
            assert sim.withdraw(target) and target.dropped
        r2 = sim.finalize()
        assert r2.completed + r2.dropped == 3
        out.append((_result(r1), _result(r2), target is None))
    assert out[1] == out[0]


def test_pending_order_and_drop_memo_equal():
    out = []
    for pkg in (REF, PORT):
        cost = _cost(pkg)
        trace = _trace(pkg, 6)[:40]
        sim = pkg.simulator.Simulator(pkg.heuristics.HEURISTICS["VPTR"], cost,
                                      grid=pkg.vdc.PodGrid(4, 4))
        sim.begin()
        for t in trace:
            sim.inject(t)
        sim.run_until(trace[20].arrival)
        pend = sim.pending_tasks()
        assert pend == sorted(pend, key=lambda t: t.arrival)
        for t in trace:
            if t in pend or t.dropped:
                v, _, _ = pkg.simulator._best_possible(
                    t, cost, sim.now, max(t.ttype.allowable_chips))
                assert (v > 0.0) == (t in pend)
        out.append(([t.tid for t in pend], _result(sim.finalize())))
    assert out[1] == out[0]


# -------------------------------------------------------------- elastic
def _elastic_cost(pkg):
    return pkg.costmodel.CostModel(
        {("a", "s"): pkg.costmodel.CellCost(1.0, 1e-3, 1e-3, 1e9)})


def _running(pkg, cost, soft, hard, chips=16, allow=(16, 64), tid=0,
             grid=None):
    curve = pkg.value.ValueCurve(1.0, 0.1, soft, hard)
    spec = pkg.value.TaskValueSpec(
        gamma=1.0, w_p=0.7, w_e=0.3, perf_curve=curve,
        energy_curve=pkg.value.ValueCurve(1.0, 0.1, 1e12, 1e13))
    task = pkg.tasks.Task(tid=tid, ttype=pkg.tasks.TaskType(
        "a", "s", allowable_chips=allow), steps=10, arrival=0.0, value=spec)
    grid = grid or pkg.vdc.PodGrid()
    vdc = grid.compose(chips, 1.0, task.tid)
    task.start = 0.0
    task.finish = cost.time_per_step("a", "s", chips, 1.0) * 10
    task.chips = chips
    return task, vdc, grid


def _migration(m):
    return None if m is None else (m.task.tid, m.old_chips, m.new_chips,
                                   m.gain)


@pytest.mark.parametrize("case", ["grow", "full", "not_worth", "allowable",
                                  "best_of_two"])
def test_plan_regrow_equal(case):
    out = []
    for pkg in (REF, PORT):
        cost = _elastic_cost(pkg)
        if case == "full":
            task, vdc, grid = _running(pkg, cost, 100.0, 300.0,
                                       grid=pkg.vdc.PodGrid(4, 4))
            pairs = [(task, vdc)]
        elif case == "not_worth":
            task, vdc, grid = _running(pkg, cost, 1e6, 2e6)
            pairs = [(task, vdc)]
        elif case == "allowable":
            task, vdc, grid = _running(pkg, cost, 100.0, 300.0, allow=(16,))
            pairs = [(task, vdc)]
        else:
            task, vdc, grid = _running(pkg, cost, 100.0, 300.0)
            pairs = [(task, vdc)]
            if case == "best_of_two":
                t2, v2, _ = _running(pkg, cost, 1e6, 2e6, tid=1, grid=grid)
                pairs.append((t2, v2))
        mig = pkg.elastic.plan_regrow(pairs, grid, cost, now=10.0)
        out.append(_migration(mig))
    assert out[1] == out[0]
    assert (out[1] is None) == (case in ("full", "not_worth", "allowable"))
    if out[1] is not None:
        assert out[1][:3] == (0, 16, 64) and out[1][3] > 0


def test_elastic_regrow_on_paper_trace_equal():
    out = []
    for pkg in (REF, PORT):
        cost = _cost(pkg)
        task = _trace(pkg, 1)[0]
        grid = pkg.vdc.PodGrid()
        vdc = grid.compose(16, 1.0, task.tid)
        t_step = cost.time_per_step(task.ttype.arch, task.ttype.shape, 16, 1.0)
        task.start, task.finish = task.arrival, task.arrival + t_step * task.steps
        task.chips = 16
        mig = pkg.elastic.plan_regrow([(task, vdc)], grid, cost,
                                      now=task.arrival + 1.0)
        out.append(_migration(mig))
    assert out[1] == out[0]


class _P:
    def __init__(self, site):
        self.site = site


def test_plan_replacement_equal():
    old = {"a": _P("gw-1"), "b": _P("dc"), "c": _P("gw-1")}
    new = {"a": _P("gw-2"), "b": _P("dc"), "c": _P("gw-1"), "d": _P("dc")}
    out = []
    for pkg in (REF, PORT):
        migs = pkg.elastic.plan_replacement(
            old, new, state_bytes_fn=lambda s: 1000.0,
            transfer_time_fn=lambda src, dst, b: b / 500.0)
        out.append([(m.service, m.src, m.dst, m.state_bytes, m.transfer_s,
                     m.warmup_s, m.stall_s) for m in migs])
    assert out[1] == out[0]
    assert [m[0] for m in out[1]] == ["a"]
    assert out[1][0][6] == pytest.approx(2.0 + PORT.elastic.SERVICE_WARMUP_S)
    assert PORT.elastic.SERVICE_WARMUP_S == REF.elastic.SERVICE_WARMUP_S
    assert PORT.elastic.MIGRATION_OVERHEAD_S == REF.elastic.MIGRATION_OVERHEAD_S


# ------------------------------------------------- the paper's §4 trace
_DEMO = {}


def _demo(pkg):
    """examples/vos_scheduler_demo.py: 18 task types, PAPER_REGIME, seed 7,
    a 70% power cap, and one generator whose next 120 jobs go to each
    heuristic in turn."""
    key = pkg.hardware.__name__
    if key not in _DEMO:
        cost = _cost(pkg)
        types = [pkg.tasks.TaskType(a, s)
                 for a in ("smollm-135m", "qwen3-1.7b", "yi-6b",
                           "olmoe-1b-7b", "jamba-v0.1-52b", "mamba2-1.3b")
                 for s in ("train_4k", "prefill_32k", "decode_32k")]
        gen = pkg.tasks.WorkloadGenerator(types, cost, seed=7,
                                          **pkg.tasks.PAPER_REGIME)
        cap = pkg.hardware.pod_power_cap_w(0.70)
        _DEMO[key] = {
            name: pkg.simulator.Simulator(
                pkg.heuristics.HEURISTICS[name], cost,
                power_cap_w=cap).run(copy.deepcopy(gen.trace(120)))
            for name in HEURISTICS}
    return _DEMO[key]


@pytest.mark.parametrize("name", HEURISTICS)
def test_vos_scheduler_demo_equal(name):
    ref, port = _demo(REF)[name], _demo(PORT)[name]
    assert _result(port) == _result(ref)
    assert math.isfinite(port.vos) and port.vos > 0
