"""The port's Scenario API against the JAX package's: the cases of
tests/test_scenario.py run through both packages on the same specs. The
spec, the engine, the ledger and the screen are carried as they are, so
every VoS, energy, fire count, ledger total, JSON string and screened
score must be equal, not close.

Calibrated compiles differ between the packages on purpose (the port
counts each operator's work, the JAX package reads XLA's cost of one
interpret-mode grid pass), so they are held against each other only with
the same callable calibrator; the port's ``KernelCalibrator`` is held
against its own figures."""
import dataclasses
import importlib
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "BENCH_placement.json"
RECORDED = json.loads(BENCH.read_text())["scenarios"]

_SLO_KW = dict(soft_latency_s=2.0, hard_latency_s=10.0,
               soft_energy_j=2.0, hard_energy_j=100.0)


def _package(name):
    mod = importlib.import_module
    return SimpleNamespace(
        name=name, scenario=mod(f"{name}.scenario"),
        engine=mod(f"{name}.scenario.engine"),
        placement=mod(f"{name}.placement"),
        edge=mod(f"{name}.placement.edge"),
        network=mod(f"{name}.placement.network"),
        online=mod(f"{name}.online"))


REF, PORT = _package("repro"), _package("repro_torch")
BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["jax", "port"])


def _mini_spec(pkg, horizon: float = 300.0):
    return (pkg.scenario.scenario("mini")
            .horizon(horizon)
            .farm(n_things=4, seed=3, rate=pkg.scenario.RateSpec.constant(2.0))
            .service("agg", queue="neubotspeed", column="download_speed",
                     agg="max", width_s=120, slide_s=30)
            .slo(**_SLO_KW).profile(flops_per_record=2e3)
            .service("smooth", queue="agg_out", column="value", agg="mean",
                     width_s=120, slide_s=60)
            .fed_by("agg")
            .slo(**_SLO_KW).profile(flops_per_record=2e3)
            .build())


def _rich_spec(pkg):
    """Every declarative dimension: multi-site fleet, pinned farms, drift
    kinds, outages, stores, epochs, DC knobs."""
    R = pkg.scenario.RateSpec
    return (pkg.scenario.scenario("rich")
            .horizon(1200.0).epochs(300.0)
            .dc(records_per_step=2000, dc_step_floor_s=2e-3)
            .site("gw-a", edge=pkg.edge.EdgeSpec(name="gw-a",
                                                 active_power_w=4.0),
                  link=pkg.network.LinkSpec(uplink_bps=1e6), user=True)
            .site("gw-b")
            .outage("gw-b", 300.0, 600.0)
            .farm(queue="neubotspeed", n_things=3, seed=7, site="gw-a",
                  rate=R.diurnal(2.0, amplitude=0.5, period_s=1200.0))
            .farm(queue="aux", n_things=2, seed=9, site="gw-b",
                  rate=R.piecewise([(0.0, 1.0), (600.0, 4.0),
                                    (1200.0, 1.0)]))
            .service("a", queue="neubotspeed", column="download_speed",
                     agg="max", width_s=120, slide_s=60)
            .slo(**_SLO_KW).profile(flops_per_record=3e3)
            .with_store(chunk_seconds=600.0, edge_budget_chunks=4)
            .service("b", queue="aux", column="latency_ms", agg="mean",
                     width_s=120, slide_s=60)
            .slo(**_SLO_KW).profile(flops_per_record=3e3)
            .service("fuse", queue="mix", column="value", agg="mean",
                     width_s=240, slide_s=120)
            .fed_by("a", "b")
            .slo(**_SLO_KW).profile(flops_per_record=3e3)
            .build())


def _plans(pkg, spec_name):
    """Three plans over each spec: all on the edge, all in the DC and a
    mix, the rich spec's across its two gateways."""
    P, SP = pkg.placement.PlacementPlan, pkg.placement.ServicePlacement
    if spec_name == "mini":
        return {"all_edge": P.all_edge(["agg", "smooth"]),
                "all_dc": P.all_dc(["agg", "smooth"], chips=4),
                "mixed": P({"agg": SP("edge"), "smooth": SP("dc", chips=4)})}
    return {"all_edge": P({"a": SP("gw-a"), "b": SP("gw-b"),
                           "fuse": SP("gw-a")}),
            "all_dc": P.all_dc(["a", "b", "fuse"], chips=8, dvfs_f=0.7),
            "mixed": P({"a": SP("gw-a"), "b": SP("gw-b"),
                        "fuse": SP("dc", chips=4)})}


SPECS = {"mini": _mini_spec, "rich": _rich_spec}


def _outcome(r):
    """Every number a run reports: VoS, energy, fires, ledger, per service
    and per site."""
    return (r.vos, r.feasible, r.vos_normalized, r.edge_energy_j,
            r.network_energy_j, r.dc_energy_j, r.energy_total_j,
            r.fires_total, r.fires_completed, r.fires_dropped,
            r.fires_inflight, r.bytes_up, r.bytes_down, r.ledger.totals(),
            r.ledger.conserved(), r.per_service, r.infeasible_reason,
            json.dumps(r.summary(), sort_keys=True))


# ---------------------------------------------------------------- builder
@BOTH
def test_builder_topology_and_profiles(pkg):
    spec = _mini_spec(pkg)
    assert spec.service_names() == ["agg", "smooth"]
    assert spec.topology() == {"agg": [], "smooth": ["agg"]}
    profs = spec.profiles()
    assert profs["agg"].flops_per_record == 2e3
    assert profs["agg"].slo.soft_latency_s == 2.0
    rich = _rich_spec(pkg)
    assert rich.topology() == {"a": [], "b": [], "fuse": ["a", "b"]}
    assert {s.name for s in rich.sites} == {"gw-a", "gw-b"}
    assert rich.sites[0].farm_queues == ("neubotspeed",)
    assert rich.user_site == "gw-a"
    assert rich.outage_map() == {"gw-b": ((300.0, 600.0),)}


@pytest.mark.parametrize("spec", ["mini", "rich"])
def test_profiles_and_engine_config_equal(spec):
    ref, port = SPECS[spec](REF), SPECS[spec](PORT)
    assert ({k: dataclasses.asdict(v) for k, v in ref.profiles().items()}
            == {k: dataclasses.asdict(v) for k, v in port.profiles().items()})
    assert (dataclasses.asdict(ref.engine_config())
            == dataclasses.asdict(port.engine_config()))


def _bad_wiring(pkg, case):
    s = pkg.scenario.scenario
    if case == "consumes":
        s("dangling").farm().service(
            "x", queue="nobody_publishes_this").build()
    elif case == "duplicate":
        (s("dup").farm().service("x", queue="neubotspeed")
         .service("x", queue="neubotspeed").build())
    elif case == "fed_by unknown":
        (s("bad").farm().service("x", queue="neubotspeed")
         .service("y", queue="q2").fed_by("ghost").build())
    else:
        s("dcsite").site("dc")


@pytest.mark.parametrize("case", ["consumes", "duplicate", "fed_by unknown",
                                  "reserved"])
def test_builder_rejects_bad_wiring(case):
    """Each package refuses the same wiring with the same message."""
    errors = []
    for pkg in (REF, PORT):
        with pytest.raises(ValueError, match=case) as e:
            _bad_wiring(pkg, case)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ------------------------------------------------------------- round-trip
@pytest.mark.parametrize("spec", ["mini", "rich"])
def test_json_roundtrip_equal_strings(spec):
    ref, port = SPECS[spec](REF), SPECS[spec](PORT)
    blob = port.to_json()
    assert blob == ref.to_json()
    back = PORT.scenario.ScenarioSpec.from_json(blob)
    assert back == port and back.to_json() == blob
    # the JAX package's JSON reads into the port's spec
    assert PORT.scenario.ScenarioSpec.from_json(ref.to_json()) == port


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_recorded_specs_roundtrip_equal(name):
    d = RECORDED[name]["spec"]
    ref = REF.scenario.ScenarioSpec.from_dict(d)
    port = PORT.scenario.ScenarioSpec.from_dict(d)
    assert port.to_json() == ref.to_json()
    assert port.to_dict() == ref.to_dict()
    assert PORT.scenario.ScenarioSpec.from_dict(port.to_dict()) == port


def _rate_pairs(pkg):
    R, on = pkg.scenario.RateSpec, pkg.online
    return [
        (R.diurnal(4.0, amplitude=0.5, period_s=100.0, phase_s=25.0),
         on.diurnal(4.0, amplitude=0.5, period_s=100.0, phase_s=25.0)),
        (R.bursts(1.0, 5.0, [(10.0, 20.0)]),
         on.step_bursts(1.0, 5.0, [(10.0, 20.0)])),
        (R.piecewise([(0.0, 1.0), (10.0, 3.0)]),
         on.piecewise_linear([(0.0, 1.0), (10.0, 3.0)])),
        (R.poisson(2.0, 8.0, mean_gap_s=60.0, mean_len_s=30.0, seed=9),
         on.poisson_bursts(2.0, 8.0, 600.0, mean_gap_s=60.0,
                           mean_len_s=30.0, seed=9)),
    ]


@pytest.mark.parametrize("i", range(4), ids=["diurnal", "bursts",
                                             "piecewise", "poisson"])
def test_rate_spec_curves_match_drift_generators(i):
    """The port's RateSpec through JSON equals its drift generator, and
    both equal the JAX package's, at every probe time."""
    h = 600.0
    ts = (0.0, 5.0, 15.0, 50.0, 123.4, 599.0)
    (rspec, gen), (ref_spec, ref_gen) = (_rate_pairs(PORT)[i],
                                         _rate_pairs(REF)[i])
    rt = PORT.scenario.RateSpec(
        **json.loads(json.dumps(dataclasses.asdict(rspec))))
    for t in ts:
        want = ref_gen(t)
        assert gen(t) == want == ref_spec.curve(h)(t)
        assert rspec.curve(h)(t) == want and rt.curve(h)(t) == want


# ----------------------------------------------------------------- engine
@pytest.mark.parametrize("plan", ["all_edge", "all_dc", "mixed"])
@pytest.mark.parametrize("spec", ["mini", "rich"])
def test_run_plan_equal(spec, plan):
    """run_plan on the same spec and plan: every number equal."""
    out = []
    for pkg in (REF, PORT):
        engine = SPECS[spec](pkg).compile()
        r = engine.run_plan(_plans(pkg, spec)[plan])
        assert r.feasible and r.ledger.conserved()
        out.append(_outcome(r))
    assert out[0] == out[1]


@pytest.mark.parametrize("spec", ["mini", "rich"])
def test_run_fixed_plan_controller_equal(spec):
    """run(_FixedPlan(plan)) over the epochs: the EngineResult's VoS,
    ledger, per-epoch meta and DC SimResult equal."""
    out = []
    for pkg in (REF, PORT):
        engine = SPECS[spec](pkg).compile()
        r = engine.run(pkg.engine._FixedPlan(_plans(pkg, spec)["mixed"]))
        assert r.ledger.conserved()
        out.append((r.vos, r.energy_total_j, r.ledger.totals(),
                    json.dumps(r.summary(), sort_keys=True),
                    None if r.dc is None else (r.dc.vos, r.dc.completed,
                                               r.dc.total_energy_j)))
    assert out[0] == out[1]


def _replay(pkg, sc):
    engine = pkg.scenario.ScenarioSpec.from_dict(sc["spec"]).compile()
    P = pkg.placement.PlacementPlan
    names = list(engine.topology)
    plans = {"searched": P.from_dict(sc["search"]["assignments"]),
             "all_edge": P.all_edge(names),
             "all_dc": P.all_dc(names, chips=sc["search"]["chips_options"][0])}
    return {k: engine.run_plan(p) for k, p in plans.items()}


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_recorded_placement_bench_replay(name):
    """The users' recorded scenarios of BENCH_placement.json at their
    recorded size: the port's VoS is the JAX package's float, within 1e-3
    of the recorded value, with the recorded fires and records."""
    sc = RECORDED[name]
    ref, port = _replay(REF, sc), _replay(PORT, sc)
    for key, r in port.items():
        assert _outcome(r) == _outcome(ref[key]), key
        summary, rec = r.summary(), sc[key]
        assert r.feasible == rec["feasible"] and r.ledger.conserved(), key
        if rec["vos"] is None:
            assert r.vos == float("-inf"), key
        else:
            assert r.vos == pytest.approx(rec["vos"], abs=1e-3), key
        assert summary["fires"] == rec["fires"], key
        assert summary["records"] == rec["records"], key


def test_compile_requires_flops_or_calibrator():
    b = (PORT.scenario.scenario("uncal")
         .farm(n_things=2, rate=PORT.scenario.RateSpec.constant(1.0))
         .service("x", queue="neubotspeed", column="latency_ms", agg="mean",
                  width_s=60, slide_s=30)
         .slo(**_SLO_KW).profile(flops_per_record=None))
    spec = b.build()
    with pytest.raises(ValueError, match="flops_per_record"):
        spec.compile()
    engine = spec.compile(calibrator=lambda s: 123.0)   # any callable works
    assert engine.profiles["x"].flops_per_record == 123.0


# ------------------------------------------------------------- calibration
def test_calibrated_compile_uses_measured_flops():
    spec = _mini_spec(PORT, horizon=120.0)
    cal = PORT.scenario.KernelCalibrator(device="cpu")
    engine = spec.compile(calibrator=cal)
    for name in ("agg", "smooth"):
        svc = next(s for s in spec.services if s.name == name)
        assert engine.profiles[name].flops_per_record == cal(svc)
        assert engine.profiles[name].flops_per_record != 2e3
    assert len(cal.log) == 2 and all(c.source == "flop-counter"
                                     for c in cal.log)


def test_calibrated_heavy_analytics_on_the_cpu():
    """heavy_analytics compiled with KernelCalibrator(device="cpu"):
    classify (flash_attention) reads the pinned 65,792 flops per record,
    and the engine prices the recorded searched plan with those profiles,
    run for run the same."""
    sc = RECORDED["heavy_analytics"]
    spec = PORT.scenario.ScenarioSpec.from_dict(sc["spec"])
    plan = PORT.placement.PlacementPlan.from_dict(sc["search"]["assignments"])
    runs = []
    for _ in range(2):
        cal = PORT.scenario.KernelCalibrator(device="cpu")
        engine = spec.compile(calibrator=cal)
        runs.append((engine.profiles, _outcome(engine.run_plan(plan))))
    profiles, outcome = runs[0]
    assert runs[0] == runs[1]
    assert profiles["classify"].flops_per_record == 65_792.0
    assert profiles["classify"].operator == "flash_attention"
    declared = spec.profiles()
    for name, p in profiles.items():
        assert p.slo == declared[name].slo
        assert p.bytes_per_record == declared[name].bytes_per_record
    assert outcome[1] and outcome[14]          # feasible, conserved


@pytest.mark.parametrize("spec", ["mini", "heavy_analytics"])
def test_same_callable_calibrator_same_vos(spec):
    """A calibrator is any callable over a ServiceSpec: the same one in
    both packages gives the same profiles and the same run."""
    def calibrator(svc):
        return 50.0 * svc.width_s / svc.slide_s + len(svc.operator)

    out = []
    for pkg in (REF, PORT):
        if spec == "mini":
            s = _mini_spec(pkg)
            plan = _plans(pkg, "mini")["mixed"]
        else:
            sc = RECORDED[spec]
            s = pkg.scenario.ScenarioSpec.from_dict(sc["spec"])
            plan = pkg.placement.PlacementPlan.from_dict(
                sc["search"]["assignments"])
        engine = s.compile(calibrator=calibrator)
        out.append(({k: p.flops_per_record
                     for k, p in engine.profiles.items()},
                    _outcome(engine.run_plan(plan))))
    assert out[0] == out[1]


# ------------------------------------------------------- tier-1 screening
def _candidates(pkg, names, chips):
    from itertools import islice
    return list(islice(pkg.placement.enumerate_plans(names, chips,
                                                     (1.0, 0.7)), 400))


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_screening_scores_equal_on_recorded_scenarios(name):
    """ScreeningModel.score_batch over the recorded scenario's candidate
    plans (the space its search screened): array_equal to the JAX one."""
    sc = RECORDED[name]
    scores = []
    for pkg in (REF, PORT):
        engine = pkg.scenario.ScenarioSpec.from_dict(sc["spec"]).compile()
        plans = _candidates(pkg, list(engine.topology),
                            tuple(sc["search"]["chips_options"]))
        sm = engine.screening_model()
        scores.append(sm.score_batch(plans))
        r = sm.run(plans[0])
        scores.append(np.array([r.vos, float(r.feasible)]))
    assert len(scores[0]) == sc["search"]["screen"]["space"]
    assert np.array_equal(scores[0], scores[2])
    assert np.array_equal(scores[1], scores[3])


def test_screening_mini_deterministic_and_infeasible():
    """The port's screen is pure array math, equal to the JAX one's on
    the mini spec; RAM-infeasible plans screen to -inf."""
    out = []
    for pkg in (REF, PORT):
        spec = _mini_spec(pkg)
        names = spec.service_names()
        plans = list(pkg.placement.enumerate_plans(names, (4, 8), (1.0, 0.7)))
        s1 = spec.compile().screening_model().score_batch(plans)
        s2 = spec.compile().screening_model().score_batch(plans)
        assert np.array_equal(s1, s2)
        tiny = dataclasses.replace(spec, sites=(dataclasses.replace(
            spec.sites[0], edge=pkg.edge.EdgeSpec(ram_bytes=1024.0)),))
        r = tiny.compile().screening_model().run(
            pkg.placement.PlacementPlan.all_edge(names))
        assert not r.feasible and r.vos == float("-inf")
        out.append(s1)
    assert np.array_equal(out[0], out[1])
