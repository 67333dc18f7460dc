"""The port's batched fluid engine against the JAX package's, on the CPU.

The lowering (``lower_plans``, the trace arrays, the realizations) is
carried numpy, so its arrays, ``feasible``, ``order``, ``t_bins`` and
``max_vos`` must be equal. The time-stepper is float32 torch standing in
for the reference's jitted ``lax.scan``; XLA contracts some products and
sums into fused multiply-adds, which torch does not, so the trajectories
may differ in the last bits. Tolerance, element for element:
``|port - ref| <= 1e-5 * max(1, |ref|)`` for ``vos``, ``vos_service``,
``vos_t``, ``lat_mean`` and ``drop_frac`` (infeasible plans read ``-inf``
in both). Decisions made on those scores — the plans that
``robust_search``, ``region_search(ensemble=...)`` and the online
controller's risk-aware pick choose, and ``rank_plans`` — must be equal."""
import functools
import importlib
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PLACEMENT = json.loads((ROOT / "BENCH_placement.json").read_text())
ROBUST = json.loads((ROOT / "BENCH_robust.json").read_text())["blocks"]
RTOL = 1e-5
FIELDS = ("vos", "vos_service", "vos_t", "lat_mean", "drop_frac")


def _package(name):
    mod = importlib.import_module
    return SimpleNamespace(
        name=name, scenario=mod(f"{name}.scenario"),
        placement=mod(f"{name}.placement"),
        edge=mod(f"{name}.placement.edge"),
        network=mod(f"{name}.placement.network"),
        fluid=mod(f"{name}.fluid"), region=mod(f"{name}.region"),
        controller=mod(f"{name}.online.controller"))


REF, PORT = _package("repro"), _package("repro_torch")
# the port's fluid engine on the CPU; the reference takes no device
DEV = {"repro": {}, "repro_torch": {"device": "cpu"}}


def assert_close(port, ref, what=""):
    """The tolerance of the module's docstring, and the carried fields
    equal."""
    assert (port.feasible == ref.feasible).all(), what
    assert port.order == ref.order and port.max_vos == ref.max_vos, what
    assert (port.t_bins == ref.t_bins).all(), what
    for k in FIELDS:
        p, r = getattr(port, k), getattr(ref, k)
        assert p.shape == r.shape, (what, k)
        fin = np.isfinite(r)
        assert (np.isfinite(p) == fin).all() and (p[~fin] == r[~fin]).all(), \
            (what, k)
        err = np.abs(p[fin] - r[fin])
        assert (err <= RTOL * np.maximum(1.0, np.abs(r[fin]))).all(), \
            (what, k, float(err.max()))


# ------------------------------------------------------------------ specs
_SLO_KW = dict(soft_latency_s=2.0, hard_latency_s=10.0,
               soft_energy_j=0.5, hard_energy_j=10.0)


def _grid_spec(pkg, base_hz=4.0, n_things=4, width_s=60.0, burst=False):
    """tests/test_fluid_properties.py's spec: two heterogeneous gateways
    and chained services, short horizon."""
    R = pkg.scenario.RateSpec
    rate = (R.bursts(base_hz, 2.5 * base_hz, [(60.0, 150.0)])
            if burst else R.constant(base_hz))
    E, L = pkg.edge.EdgeSpec, pkg.network.LinkSpec
    return (pkg.scenario.scenario("fluid-prop")
            .horizon(240.0)
            .site("gw-a", edge=E(name="gw-a"),
                  link=L(uplink_bps=1e5, rtt_s=0.05, record_bytes=256.0))
            .site("gw-b", edge=E(name="gw-b", flops_per_s=15e9),
                  link=L(uplink_bps=8e4, rtt_s=0.08, record_bytes=256.0))
            .farm(n_things=n_things, seed=5, rate=rate, site="gw-a")
            .service("agg", queue="neubotspeed", column="download_speed",
                     agg="max", width_s=width_s, slide_s=width_s / 2)
            .slo(**_SLO_KW).profile(flops_per_record=2e3)
            .service("smooth", queue="agg_out", column="value", agg="mean",
                     width_s=2 * width_s, slide_s=width_s)
            .fed_by("agg")
            .slo(**_SLO_KW).profile(flops_per_record=2e3)
            .build())


def _grid_plans(pkg, names):
    P, SP = pkg.placement.PlacementPlan, pkg.placement.ServicePlacement
    return [P.all_edge(names, site="gw-a"), P.all_edge(names, site="gw-b"),
            P.all_dc(names, chips=4), P.all_dc(names, chips=8),
            P({"agg": SP("gw-a"), "smooth": SP("dc", chips=4)}),
            P({"agg": SP("dc", chips=4), "smooth": SP("gw-b")})]


GRID = [(4.0, 4, 60.0, False, 0), (4.0, 4, 60.0, False, 2),
        (1.5, 2, 30.0, False, 4), (7.0, 4, 30.0, True, 1),
        (6.0, 2, 60.0, True, 3), (3.0, 4, 30.0, True, 5)]


def _burst_tail(pkg):
    from benchmarks.bench_robust import scenario_burst_tail
    return pkg.scenario.ScenarioSpec.from_dict(scenario_burst_tail().to_dict())


def _correlated_bursts(pkg):
    from benchmarks.bench_online import scenario_correlated_bursts
    spec = scenario_correlated_bursts(smoke=True).spec
    return pkg.scenario.ScenarioSpec.from_dict(spec.to_dict())


def _small_fleet(pkg):
    return pkg.region.generate_fleet(pkg.region.FleetGenSpec(
        n_sites=12, n_regions=3, seed=5, horizon_s=600.0))


# ---------------------------------------------------- port == reference
def _ensembles(build, n, seed, **kw):
    """The same spec lowered and sampled by each package."""
    out = {}
    for pkg in (REF, PORT):
        spec = build(pkg)
        eng = spec.compile()
        out[pkg.name] = (pkg, eng, pkg.fluid.ScenarioEnsemble.from_spec(
            spec, n=n, seed=seed, engine=eng, **kw, **DEV[pkg.name]))
    return out


def _plans_of(pkg, eng, build_plans):
    return [pkg.placement.PlacementPlan.from_dict(p)
            for p in build_plans(list(eng.order),
                                 list(eng.info().fleet.site_names))]


def _anchor_dicts(names, sites, chips=(4, 8)):
    from repro_torch.placement import PlacementPlan
    plans = [PlacementPlan.all_edge(names, site=s) for s in sites]
    plans += [PlacementPlan.all_dc(names, chips=c) for c in chips]
    return [p.to_dict() for p in plans]


CASES = {
    **{f"grid{i}": (lambda pkg, a=a: _grid_spec(pkg, *a[:4]),
                    lambda names, sites: [
                        p.to_dict() for p in _grid_plans(PORT, names)])
       for i, a in enumerate(GRID[1:])},
    "burst_tail": (_burst_tail, _anchor_dicts),
    "correlated_bursts": (_correlated_bursts, _anchor_dicts),
    "hierarchical": (_small_fleet, _anchor_dicts),
}


@functools.lru_cache(maxsize=None)
def _case_ensembles(case):
    return _ensembles(CASES[case][0], n=4, seed=3)


@pytest.mark.parametrize("jit", [True, False], ids=["jit", "eager"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fluid_equals_reference(case, jit):
    plans = CASES[case][1]
    ens = _case_ensembles(case)
    out, lowered = {}, {}
    for name, (pkg, eng, e) in ens.items():
        ps = _plans_of(pkg, eng, plans)
        out[name] = e.evaluate(ps, jit=jit)
        lowered[name] = e.fluid.lower_plans(ps)
    assert ens["repro_torch"][2].fluid._hier == (case == "hierarchical")
    for k, v in ens["repro"][2].realizations.items():
        assert (ens["repro_torch"][2].realizations[k] == v).all(), k
    a, b = lowered["repro"], lowered["repro_torch"]
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and (a[k] == b[k]).all(), k
    assert_close(out["repro_torch"], out["repro"], case)


def test_nominal_realization_equals_reference():
    """The single nominal realization (no ensemble), at six plans and at
    one."""
    res = {}
    for pkg in (REF, PORT):
        eng = _grid_spec(pkg).compile()
        fl = eng.fluid_engine(**DEV[pkg.name])
        plans = _grid_plans(pkg, list(eng.order))
        res[pkg.name] = (fl.evaluate(plans), fl.evaluate(plans[:1]))
    for p, r in zip(res["repro_torch"], res["repro"]):
        assert_close(p, r)


# ------------------------------------------------ the recorded agreement
@pytest.mark.parametrize("name", sorted(PLACEMENT["scenarios"]))
def test_recorded_agreement_block(name):
    """BENCH_robust.json's agreement block: the fluid VoS of each anchor
    plan reproduces (within 1e-3; ``null`` is an infeasible plan, -inf),
    and stays within 5% of the exact DES."""
    sc = PLACEMENT["scenarios"][name]
    eng = PORT.scenario.ScenarioSpec.from_dict(sc["spec"]).compile()
    rows = [r for r in ROBUST["agreement"]["plans"] if r["scenario"] == name]
    plans = [PORT.placement.PlacementPlan.from_dict(p) for p in _anchor_dicts(
        list(eng.order), list(eng.info().fleet.site_names),
        sc["search"]["chips_options"])]
    assert [p.label for p in plans] == [r["plan"] for r in rows]
    fr = eng.fluid_engine(device="cpu").evaluate(plans)
    for m, (plan, row) in enumerate(zip(plans, rows)):
        f = float(fr.vos[0, m])
        if row["fluid_vos"] is None:
            assert f == float("-inf"), plan.label
        else:
            assert abs(f - row["fluid_vos"]) <= 1e-3, (plan.label, f)
        des = eng.run_plan(plan)
        if not des.feasible or not np.isfinite(f):
            assert not des.feasible and not np.isfinite(f), plan.label
        else:
            assert abs(f - des.vos) <= 0.05 * max(abs(des.vos), 1e-9)


@pytest.mark.parametrize("base_hz,n_things,width_s,burst,plan_idx", GRID)
def test_fluid_tracks_des_fixed_grid(base_hz, n_things, width_s, burst,
                                     plan_idx):
    """The fluid-vs-DES gate of tests/test_fluid_properties.py on the
    port: the nominal fluid VoS within 5% of the exact DES, or both say
    the plan is infeasible."""
    eng = _grid_spec(PORT, base_hz, n_things, width_s, burst).compile()
    plan = _grid_plans(PORT, list(eng.order))[plan_idx]
    f_vos = float(PORT.fluid.FluidEngine.compile(eng, device="cpu")
                  .evaluate([plan], jit=False).vos[0, 0])
    des = eng.run_plan(plan)
    if not des.feasible or not np.isfinite(f_vos):
        assert not des.feasible and not np.isfinite(f_vos)
        return
    assert abs(f_vos - des.vos) <= 0.05 * max(abs(des.vos), 1e-9)


@pytest.mark.parametrize("seed", range(3))
def test_plan_batch_permutation_invariance(seed):
    eng = _grid_spec(PORT).compile()
    ens = PORT.fluid.ScenarioEnsemble.from_spec(
        _grid_spec(PORT), n=3, seed=seed, engine=eng, device="cpu")
    plans = _grid_plans(PORT, list(eng.order))
    base = ens.evaluate(plans)
    perm = np.random.default_rng(seed).permutation(len(plans))
    shuf = ens.evaluate([plans[i] for i in perm])
    for k in FIELDS:
        assert (getattr(shuf, k) == getattr(base, k)[:, perm]).all(), k
    assert (shuf.feasible == base.feasible[perm]).all()


# ------------------------------------------------------ decisions on top
def test_robust_search_burst_tail_equals_reference():
    """robust_search under "mean" and "cvar" over one shared ensemble
    (BENCH_robust.json's burst_tail row): the same plans in both
    packages, and CVaR still beats mean on the worst decile."""
    ens = _ensembles(_burst_tail, n=48, seed=0, rate_scale=0.45,
                     onset_scale=0.15)
    picked, fluid = {}, {}
    for name, (pkg, eng, e) in ens.items():
        ev = pkg.placement.Evaluator(eng)
        sites = tuple(eng.info().fleet.site_names)
        srs = {m: pkg.placement.robust_search(
            eng, e, risk=m, chips_options=(4, 8), shortlist=16, final_k=6,
            evaluator=ev, edge_sites=sites) for m in ("mean", "cvar")}
        picked[name] = {m: (sr.plan.label, sr.result.vos,
                            [(f["plan"], f["des_vos"])
                             for f in sr.screen["robust"]["finalists"]])
                        for m, sr in srs.items()}
        fluid[name] = e.evaluate([srs["mean"].plan, srs["cvar"].plan])
    assert picked["repro_torch"] == picked["repro"]
    rec = next(r for r in ROBUST["choice"] if r["scenario"] == "burst_tail")
    assert picked["repro_torch"]["mean"][0] == rec["mean_plan"]
    assert picked["repro_torch"]["cvar"][0] == rec["cvar_plan"]
    q10 = np.quantile(fluid["repro_torch"].vos, 0.1, axis=0)
    assert q10[1] > q10[0]
    assert abs(q10[1] - rec["fluid"]["cvar_plan"]["q10"]) <= 1e-3
    assert abs(q10[0] - rec["fluid"]["mean_plan"]["q10"]) <= 1e-3
    # rank_plans and risk_score: the same function of the same matrix, and
    # the same order on each package's own scores
    vos = fluid["repro"].vos
    for risk in ("mean", "cvar", "worst"):
        r_ref = REF.fluid.rank_plans(vos, risk)
        assert (PORT.fluid.rank_plans(vos, risk) == r_ref).all()
        assert (PORT.fluid.risk_score(vos, risk)
                == REF.fluid.risk_score(vos, risk)).all()
        assert (PORT.fluid.rank_plans(fluid["repro_torch"].vos, risk)
                == r_ref).all()


def test_region_search_ensemble_equals_reference():
    ens = _ensembles(_small_fleet, n=6, seed=1)
    out = {}
    for name, (pkg, eng, e) in ens.items():
        sr = pkg.region.region_search(eng, chips_options=(4,), seed=0,
                                      sweeps=1, ensemble=e, risk="cvar")
        out[name] = (sr.plan.key(), sr.result.vos,
                     {k: v for k, v in sr.screen["robust"].items()
                      if k != "fluid_wall_s"})
    assert out["repro_torch"] == out["repro"]


def test_online_risk_pick_equals_reference():
    """OnlineController(risk="cvar"): the risk-aware pick of every epoch
    and the run's VoS equal the reference's."""
    from benchmarks.bench_online import _TIDE_PRIORS, scenario_flash_crowd
    d = scenario_flash_crowd(smoke=True).spec.to_dict()
    out = {}
    for pkg in (REF, PORT):
        ctrl = pkg.controller.OnlineController(
            chips_options=(4, 8), window=1, switch_margin=0.02, seed=0,
            prior_rates=dict(_TIDE_PRIORS), risk="cvar")
        r = pkg.scenario.ScenarioSpec.from_dict(d).compile().run(ctrl)
        out[pkg.name] = json.dumps(r.summary(), sort_keys=True, default=str)
    assert out["repro_torch"] == out["repro"]
    assert '"risk"' in out["repro_torch"]


# --------------------------------------------------------------- devices
def test_fluid_engine_cache_and_device():
    """One fluid engine per (dt_s, device); with no card the default
    device is an error, never a fallback to the CPU."""
    eng = _grid_spec(PORT).compile()
    a = eng.fluid_engine(device="cpu")
    assert eng.fluid_engine(device="cpu") is a
    assert eng.fluid_engine(dt_s=15.0, device="cpu") is not a
    assert a.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eng.fluid_engine()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PORT.fluid.ScenarioEnsemble.from_spec(_grid_spec(PORT), n=2,
                                                  engine=eng)


def test_each_search_evaluates_its_ensemble_once():
    """``region_search`` and ``robust_search`` make one fluid call each, so
    no call of theirs repeats an input shape and none would replay a CUDA
    graph; a repeated call is counted as one. On the CPU nothing is
    captured."""
    spec = _small_fleet(PORT)
    eng = spec.compile()
    ens = PORT.fluid.ScenarioEnsemble.from_spec(spec, n=4, seed=1,
                                                engine=eng, device="cpu")
    fl = ens.fluid
    PORT.region.region_search(eng, chips_options=(4,), seed=0, sweeps=1,
                              ensemble=ens, risk="cvar")
    assert (fl.evaluations, fl.repeated_shapes) == (1, 0)
    PORT.placement.robust_search(
        eng, ens, risk="cvar", chips_options=(4,), shortlist=8, final_k=3,
        edge_sites=tuple(eng.info().fleet.site_names))
    assert fl.evaluations == 2
    plans = _plans_of(PORT, eng, _anchor_dicts)
    a, b = ens.evaluate(plans), ens.evaluate(plans)
    assert fl.evaluations == 4 and fl.repeated_shapes == 1
    assert fl.graph_captures == 0
    for k in FIELDS:
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
