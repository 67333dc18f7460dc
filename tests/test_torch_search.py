"""The port's placement search and control against the JAX package's:
the screened search over the recorded scenarios, the decomposed region
search (serial and through a forked ``ParallelEvaluator``), the online and
chaos controllers on recorded scenarios, the straggler monitor and the
deprecation shims. All of it is host code carried as it is, so chosen
plans, VoS floats, evaluator counters and ``stats()`` must be equal, not
close; the recorded ``BENCH_*.json`` values must reproduce too."""
import importlib
import json
import sys
import warnings
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PLACEMENT = json.loads((ROOT / "BENCH_placement.json").read_text())
SEARCH = json.loads((ROOT / "BENCH_search.json").read_text())
ONLINE = json.loads((ROOT / "BENCH_online.json").read_text())
CHAOS = json.loads((ROOT / "BENCH_chaos.json").read_text())


def _package(name):
    mod = importlib.import_module
    return SimpleNamespace(
        name=name, scenario=mod(f"{name}.scenario"),
        placement=mod(f"{name}.placement"),
        search=mod(f"{name}.placement.search"),
        parallel=mod(f"{name}.placement.parallel"),
        region=mod(f"{name}.region"),
        controller=mod(f"{name}.online.controller"),
        chaos=mod(f"{name}.chaos"),
        runtime=mod(f"{name}.runtime.straggler"))


REF, PORT = _package("repro"), _package("repro_torch")


def _both(fn):
    """fn run through each package; the two results."""
    return fn(REF), fn(PORT)


# ------------------------------------------------------- screened search
def _screened(pkg, name):
    sc = PLACEMENT["scenarios"][name]
    spec = pkg.scenario.ScenarioSpec.from_dict(sc["spec"])
    eng = spec.compile()
    sites = tuple(s.name for s in spec.sites)
    ev = pkg.placement.Evaluator(eng)
    sr = pkg.placement.search_placement(
        eng, chips_options=tuple(sc["search"]["chips_options"]),
        dvfs_options=(1.0, 0.7), evaluator=ev, edge_sites=sites)
    return sr, ev


@pytest.mark.parametrize("name", [n for n in SEARCH["scenarios"]
                                  if n != "big_fleet"])
def test_screened_search_equals_reference_and_record(name):
    (a, ev_a), (b, ev_b) = _both(lambda p: _screened(p, name))
    assert b.plan.label == a.plan.label
    assert b.result.vos == a.result.vos
    assert b.method == a.method
    assert (ev_b.hits, ev_b.misses) == (ev_a.hits, ev_a.misses)
    assert ev_b.history == ev_a.history
    sa, sb = a.stats(), b.stats()
    for st in (sa, sb):       # host wall time, the one field that varies
        st["screen"].pop("screen_wall_s", None)
    assert sb == sa
    rec = SEARCH["scenarios"][name]["new"]
    assert (b.plan.label, round(b.result.vos, 4)) == (rec["plan"], rec["vos"])


@pytest.mark.parametrize("method", ["exhaustive", "greedy"])
def test_unscreened_search_equals_reference(method):
    sc = PLACEMENT["scenarios"]["light_windows"]

    def run(pkg):
        eng = pkg.scenario.ScenarioSpec.from_dict(sc["spec"]).compile()
        fn = getattr(pkg.search, f"{method}_search")
        ev = pkg.placement.Evaluator(eng)
        sr = fn(eng, chips_options=(4, 8), evaluator=ev)
        return sr.plan.label, sr.result.vos, ev.hits, ev.misses, ev.history

    a, b = _both(run)
    assert b == a


# --------------------------------------------------------- region search
_SMALL_FLEET = dict(n_sites=12, n_regions=3, seed=5, horizon_s=600.0)


@pytest.fixture(scope="module")
def small_fleet():
    out = {}
    for pkg in (REF, PORT):
        spec = pkg.region.generate_fleet(pkg.region.FleetGenSpec(
            **_SMALL_FLEET))
        out[pkg.name] = (spec, spec.compile())
    return out


def test_generate_fleet_equals_reference(small_fleet):
    a, b = small_fleet["repro"][0], small_fleet["repro_torch"][0]
    assert json.dumps(b.to_dict(), sort_keys=True) == \
        json.dumps(a.to_dict(), sort_keys=True)


def _region(pkg, small_fleet, workers):
    spec, eng = small_fleet[pkg.name]
    if workers:
        ev = pkg.parallel.ParallelEvaluator(eng, workers=workers, spec=spec)
    else:
        ev = pkg.placement.Evaluator(eng)
    try:
        sr = pkg.region.region_search(eng, chips_options=(4,), seed=0,
                                      sweeps=1, evaluator=ev)
    finally:
        if workers:
            ev.close()
    return sr, ev


@pytest.mark.parametrize("workers", [0, 2], ids=["serial", "parallel"])
def test_region_search_equals_reference(small_fleet, workers):
    (a, ev_a), (b, ev_b) = (_region(REF, small_fleet, workers),
                            _region(PORT, small_fleet, workers))
    assert b.plan.key() == a.plan.key()
    assert b.result.vos == a.result.vos
    assert (ev_b.hits, ev_b.misses) == (ev_a.hits, ev_a.misses)
    assert ev_b.history == ev_a.history
    sa, sb = ev_a.stats(), ev_b.stats()
    assert sb == sa
    if workers:
        assert ev_b.parallel_batches >= 1 and not ev_b._pool_broken


def test_parallel_region_search_equals_serial(small_fleet):
    (ser, ev_s), (par, ev_p) = (_region(PORT, small_fleet, 0),
                                _region(PORT, small_fleet, 2))
    assert par.plan.key() == ser.plan.key()
    assert par.result.vos == ser.result.vos
    assert (ev_p.hits, ev_p.misses) == (ev_s.hits, ev_s.misses)
    assert ev_p.history == ev_s.history


# ------------------------------------------------ online and chaos control
def _flash_crowd(pkg):
    from benchmarks.bench_online import _TIDE_PRIORS, scenario_flash_crowd
    sc = scenario_flash_crowd()
    spec = pkg.scenario.ScenarioSpec.from_dict(sc.spec.to_dict())
    ctrl = pkg.controller.OnlineController(
        chips_options=tuple(sc.chips_options), window=1, switch_margin=0.02,
        seed=0, prior_rates=dict(_TIDE_PRIORS))
    return spec.compile().run(ctrl)


def _crash_during_burst(pkg):
    from benchmarks.bench_chaos import scenario_crash_during_burst
    sc = scenario_crash_during_burst()
    spec = pkg.scenario.ScenarioSpec.from_dict(sc.spec.to_dict())
    ctrl = pkg.chaos.ChaosController(
        chips_options=tuple(sc.chips_options), window=1, switch_margin=0.02,
        seed=0, prior_rates=dict(sc.prior_rates))
    return spec.compile().run(ctrl)


@pytest.mark.parametrize("case,recorded", [
    (_flash_crowd, ONLINE["scenarios"]["flash_crowd"]["online"]),
    (_crash_during_burst, CHAOS["scenarios"]["crash_during_burst"]["chaos"]),
], ids=["flash_crowd", "crash_during_burst"])
def test_controller_equals_reference_and_record(case, recorded):
    a, b = _both(case)
    assert b.vos == a.vos
    assert b.ledger.totals() == a.ledger.totals()
    assert json.dumps(b.summary(), sort_keys=True, default=str) == \
        json.dumps(a.summary(), sort_keys=True, default=str)
    assert abs(b.vos - recorded["vos"]) <= 1e-3
    assert b.summary()["fires"] == recorded["fires"]


# ---------------------------------------------------------------- runtime
def test_straggler_monitor_equals_reference():
    def run(pkg):
        mon = pkg.runtime.StragglerMonitor(n_hosts=4, window=10, slack=1.5)
        events = []
        for step in range(12):
            times = [1.0, 1.05, 0.95, 1.0]
            if step >= 6:
                times[2] = 5.0          # host 2 degrades
            events += [(e.step, e.host, e.t_host, e.deadline)
                       for e in mon.record_step(step, times)]
        pol = pkg.runtime.BackupStepPolicy(n_spares=1, redispatch_cost=0.1)
        eff = pol.effective_step_time([1.0, 1.0, 5.0, 1.0], deadline=1.6,
                                      typical=1.0)
        return (events, mon.persistent_stragglers(threshold=3),
                mon.slowdown_factor(2), eff, pol.backups, pol.saved_s)

    a, b = _both(run)
    assert b == a
    assert b[1] == [2]


# ------------------------------------------------------------------ shims
def _shim_spec(pkg):
    return (pkg.scenario.scenario("shim").horizon(240.0)
            .farm(n_things=3, seed=2, rate=pkg.scenario.RateSpec.constant(1.5))
            .service("agg", queue="neubotspeed", column="download_speed",
                     agg="max", width_s=120, slide_s=60)
            .slo(soft_latency_s=2.0, hard_latency_s=10.0, soft_energy_j=2.0,
                 hard_energy_j=100.0).profile(flops_per_record=2e3)
            .build())


def test_cosim_shim_warns_and_delegates():
    from repro_torch.placement import CoSimConfig, CoSimulator, PlacementPlan
    spec = _shim_spec(PORT)
    with pytest.warns(DeprecationWarning,
                      match=r"repro_torch\.placement\.cosim\.CoSimulator is "
                            r"deprecated .* v0\.9 \(2026-12-01\)"):
        shim = CoSimulator(spec.build_pipeline, spec.profiles(),
                           CoSimConfig(horizon_s=240.0))
    plan = PlacementPlan.all_edge(spec.service_names())
    legacy, unified = shim.run(plan), spec.compile().run_plan(plan)
    assert legacy.vos == unified.vos and legacy.ledger == unified.ledger

    def ref_vos(pkg):
        s = _shim_spec(pkg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            cs = pkg.placement.CoSimulator(
                s.build_pipeline, s.profiles(),
                pkg.placement.CoSimConfig(horizon_s=240.0))
        return cs.run(pkg.placement.PlacementPlan.all_edge(
            s.service_names())).vos

    assert legacy.vos == ref_vos(REF)
    sys.modules.pop("repro_torch.placement.cosim", None)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        import repro_torch.placement.cosim  # noqa: F401


def test_des_bridge_shim_warns_and_aliases():
    sys.modules.pop("repro_torch.online.des_bridge", None)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        from repro_torch.online import BridgeInfo  # noqa: F401
    assert "repro_torch.online.des_bridge" not in sys.modules
    with pytest.warns(DeprecationWarning,
                      match=r"repro_torch\.online\.des_bridge is deprecated "
                            r"and will be removed in v0\.9 \(2026-12-01\)"):
        bridge = importlib.import_module("repro_torch.online.des_bridge")
    from repro_torch.scenario.engine import (EngineConfig, EngineResult,
                                             ScenarioEngine)
    assert bridge.FleetCoSimulator is ScenarioEngine
    assert bridge.OnlineConfig is EngineConfig
    assert bridge.OnlineResult is EngineResult
