"""The port's live serving runtime (``repro_torch.serve``) against the JAX
package's. It is host code carried as it is, so the same spec and plan
give equal results, not close ones: every field of the result (VoS,
latencies, fires, energies, bytes, the ledgers, per-service and per-epoch
records) is ``==``. The recorded ``BENCH_serve.json`` replays
and its ``live`` drift scenario reproduce too. The checks of
tests/test_serve.py (conservation, seeded determinism, backpressure,
engine-vs-runtime agreement under live re-placement, the calibration
loop, load shedding, the broker queue's capacity) are mirrored on the
port."""
import dataclasses
import importlib
import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
PLACEMENT = json.loads((ROOT / "BENCH_placement.json").read_text())
SERVE = json.loads((ROOT / "BENCH_serve.json").read_text())

_SLO_KW = dict(soft_latency_s=2.0, hard_latency_s=10.0,
               soft_energy_j=2.0, hard_energy_j=100.0)


def _package(name):
    mod = importlib.import_module
    return SimpleNamespace(
        name=name, scenario=mod(f"{name}.scenario"),
        plan=mod(f"{name}.placement.plan"), serve=mod(f"{name}.serve"),
        online=mod(f"{name}.online"), streams=mod(f"{name}.pipeline.streams"))


REF, PORT = _package("repro"), _package("repro_torch")


def _plain(x):
    """A result as plain data, NaN as a string so that == compares it."""
    if dataclasses.is_dataclass(x):
        return _plain(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def _lat(r):
    return {"p50": round(r.latency_p50, 4), "p95": round(r.latency_p95, 4),
            "p99": round(r.latency_p99, 4)}


# ------------------------------------------------ the recorded replays
def _replay(pkg, name):
    sc = PLACEMENT["scenarios"][name]
    spec = pkg.scenario.ScenarioSpec.from_dict(sc["spec"])
    plan = pkg.plan.PlacementPlan.from_dict(sc["search"]["assignments"])
    return pkg.serve.serve_scenario(spec).run_plan(plan)


@pytest.mark.parametrize("name", list(SERVE["replays"]))
def test_replay_equals_reference_and_record(name):
    a, b = _replay(REF, name), _replay(PORT, name)
    assert _plain(b) == _plain(a)
    rec = SERVE["replays"][name]
    assert b.feasible
    assert b.plan_label == a.plan_label == rec["plan"]
    assert round(b.vos, 4) == rec["vos_real"]
    assert _lat(b) == rec["latency_real"]
    assert b.fires_total == rec["fires"]["real"]
    assert b.ledger.conserved() == rec["ledger_conserved"] is True
    assert b.dc is None


def _recorded_in(rec, got):
    """Every key of the recorded ``rec`` is in ``got`` with its recorded
    value (the record predates fields the code added since, such as the
    search's cumulative cache counters)."""
    if isinstance(rec, dict):
        return isinstance(got, dict) and all(
            k in got and _recorded_in(v, got[k]) for k, v in rec.items())
    if isinstance(rec, list):
        return (isinstance(got, list) and len(got) == len(rec)
                and all(map(_recorded_in, rec, got)))
    return rec == got


def _live(pkg):
    spec = pkg.scenario.ScenarioSpec.from_dict(SERVE["live"]["spec"])
    ctl = pkg.online.OnlineController(calibrate=True)
    return pkg.serve.serve_scenario(spec).run(ctl), ctl


def test_live_drift_scenario_equals_reference_and_record():
    """BENCH_serve.json's ``live`` section: an OnlineController with a
    CalibrationLoop re-placing a drifting pipeline while it serves."""
    (a, ca), (b, cb) = _live(REF), _live(PORT)
    assert _plain(b) == _plain(a)
    assert cb.calibration.history == ca.calibration.history
    rec = SERVE["live"]
    assert round(b.vos, 4) == rec["vos_real"]
    assert _lat(b) == rec["latency_real"]
    assert b.migrations == rec["migrations"]["real"]
    assert _recorded_in(rec["epochs"], json.loads(json.dumps(b.epochs)))
    assert b.ledger.conserved() == rec["ledger_conserved"] is True
    cal = rec["calibration"]
    assert cb.calibration.observations == cal["observations"]
    assert len(cb.calibration.history) == cal["history_len"]
    assert cb.calibration.history[-1]["corrections"] == cal[
        "last_corrections"]


def test_live_spec_is_the_benchmarks_spec():
    """The recorded ``live`` spec round-trips through the port's JSON as
    through the JAX package's; the fields added since the record
    (``chaos``, ``regions``) come back empty."""
    rec = SERVE["live"]["spec"]
    got = PORT.scenario.ScenarioSpec.from_dict(rec).to_dict()
    assert got == REF.scenario.ScenarioSpec.from_dict(rec).to_dict()
    assert {k: v for k, v in got.items() if k in rec} == rec
    assert {k: got[k] for k in set(got) - set(rec)} == {"chaos": None,
                                                        "regions": []}


# --------------------------------------- tests/test_serve.py on the port
def _mini_spec(pkg, horizon=600.0, epoch_s=150.0):
    sc = pkg.scenario
    return (sc.scenario("mini")
            .horizon(horizon).epochs(epoch_s)
            .farm(n_things=4, seed=3, rate=sc.RateSpec.constant(2.0))
            .service("agg", queue="neubotspeed", column="download_speed",
                     agg="max", width_s=120, slide_s=30)
            .slo(**_SLO_KW).profile(flops_per_record=2e3)
            .service("smooth", queue="agg_out", column="value", agg="mean",
                     width_s=120, slide_s=60)
            .fed_by("agg")
            .slo(**_SLO_KW).profile(flops_per_record=2e3)
            .build())


def _burst_spec(pkg):
    sc = pkg.scenario
    return (sc.scenario("burst")
            .horizon(600.0)
            .farm(n_things=6, seed=5, rate=sc.RateSpec.constant(4.0))
            .service("agg", queue="neubotspeed", column="download_speed",
                     agg="max", width_s=60, slide_s=15)
            .slo(**_SLO_KW).profile(flops_per_record=2e3)
            .service("smooth", queue="agg_out", column="value", agg="mean",
                     width_s=240, slide_s=120)
            .fed_by("agg")
            .slo(**_SLO_KW).profile(flops_per_record=2e3)
            .build())


class _Flipper:
    """Alternates all-edge / all-DC each epoch to force migrations."""

    def __init__(self, pkg):
        self.plan = pkg.plan.PlacementPlan

    def bind(self, info):
        self.names = list(info.topology)

    def decide(self, obs):
        if obs.epoch % 2 == 0:
            return self.plan.all_edge(self.names, "edge")
        return self.plan.all_dc(self.names)


def _fire_tuples(telemetry):
    return {svc: [(f.state, f.site, f.n_window, f.n_new, f.value, f.lat_s
                   if f.lat_s == f.lat_s else None, f.backlog, f.shed)
                  for f in grid]
            for svc, grid in telemetry.fires.items()}


@pytest.mark.parametrize("placement", ["all_edge", "all_dc"])
def test_run_plan_conserved_and_equal_to_reference(placement):
    runs = []
    for pkg in (REF, PORT):
        spec = _mini_spec(pkg)
        names = spec.service_names()
        plan = (pkg.plan.PlacementPlan.all_edge(names, "edge")
                if placement == "all_edge"
                else pkg.plan.PlacementPlan.all_dc(names))
        rt = pkg.serve.serve_scenario(spec)
        runs.append((rt.run_plan(plan, label=placement),
                     _fire_tuples(rt.last_telemetry)))
    (a, ta), (b, tb) = runs
    assert b.feasible and b.ledger.conserved()
    assert b.fires_completed > 0 and b.vos > 0
    if placement == "all_dc":
        assert b.dc_energy_j > 0 and b.bytes_up > 0
    assert _plain(b) == _plain(a)
    assert tb == ta


def test_seeded_determinism_identical_ledgers_and_telemetry():
    runs = []
    for _ in range(2):
        ctl = PORT.online.OnlineController(calibrate=True)
        rt = PORT.serve.serve_scenario(_mini_spec(PORT))
        res = rt.run(ctl)
        runs.append((_plain(res), _fire_tuples(rt.last_telemetry),
                     ctl.calibration.history))
    assert runs[0] == runs[1]


def test_backpressure_bounds_inter_stage_backlog():
    names = ["agg", "smooth"]
    free = PORT.serve.serve_scenario(_burst_spec(PORT))
    res_free = free.run_plan(PORT.plan.PlacementPlan.all_edge(names, "edge"))
    assert max(f.backlog for f in free.last_telemetry.fires["smooth"]) > 2
    cap = 2
    bounded = PORT.serve.serve_scenario(
        _burst_spec(PORT), serve=PORT.serve.ServeConfig(stage_capacity=cap))
    res_cap = bounded.run_plan(PORT.plan.PlacementPlan.all_edge(names,
                                                                "edge"))
    assert max(f.backlog
               for f in bounded.last_telemetry.fires["smooth"]) <= cap
    assert res_free.ledger.conserved() and res_cap.ledger.conserved()
    ref = REF.serve.serve_scenario(
        _burst_spec(REF), serve=REF.serve.ServeConfig(stage_capacity=cap))
    assert _plain(ref.run_plan(REF.plan.PlacementPlan.all_edge(
        names, "edge"))) == _plain(res_cap)


def test_runtime_matches_engine_under_live_replacement():
    sim = _mini_spec(PORT).compile().run(_Flipper(PORT))
    real = PORT.serve.serve_scenario(_mini_spec(PORT)).run(_Flipper(PORT))
    assert real.ledger.conserved()
    assert real.migrations == sim.migrations > 0
    assert real.vos == pytest.approx(sim.vos, abs=1e-3)
    for m_real, m_sim in zip(real.epochs, sim.epochs):
        assert m_real["migrations"] == m_sim["migrations"]
        assert m_real["plan"] == m_sim["plan"]
    ref = REF.serve.serve_scenario(_mini_spec(REF)).run(_Flipper(REF))
    assert _plain(real) == _plain(ref)


def test_calibration_loop_ingests_measured_residuals():
    ctl = PORT.online.OnlineController(calibrate=True)
    res = PORT.serve.serve_scenario(_mini_spec(PORT)).run(ctl)
    assert res.ledger.conserved()
    assert ctl.calibration.observations >= len(res.epochs) - 1 >= 2
    for entry in ctl.calibration.history:
        assert entry["observed"], entry
        for svc, ob in entry["observed"].items():
            assert svc in ("agg", "smooth")
            assert ob["tier"] in ("edge", "dc")
            assert ob["completed"] >= 0 and ob["vos"] is not None
    for meta in res.epochs:
        assert set(meta["rates_measured"]) == {"agg", "smooth"}
        assert meta["rates_measured"]["agg"] > 0


def test_shed_after_migration_stall_accounts_drops():
    rt = PORT.serve.serve_scenario(
        _mini_spec(PORT), serve=PORT.serve.ServeConfig(shed_after_s=1.0))
    res = rt.run(_Flipper(PORT))
    assert res.fires_dropped > 0
    assert res.ledger.conserved()
    shed = [f for grid in rt.last_telemetry.fires.values()
            for f in grid if f.shed]
    assert shed and all(f.value == 0.0 for f in shed)


def test_calibrated_serve_scenario_on_the_cpu_equals_compile():
    """``serve_scenario(spec, calibrator=)`` prices its profiles as
    ``spec.compile(calibrator=)`` does, with the port's calibrator on the
    CPU (its kernels' plain versions)."""
    from repro_torch.scenario import KernelCalibrator
    spec = PORT.scenario.ScenarioSpec.from_dict(
        PLACEMENT["scenarios"]["heavy_analytics"]["spec"])
    rt = PORT.serve.serve_scenario(spec,
                                   calibrator=KernelCalibrator(device="cpu"))
    eng = spec.compile(calibrator=KernelCalibrator(device="cpu"))
    assert rt.profiles == eng.profiles
    assert rt.profiles["classify"].flops_per_record == 65_792.0
    plan = PORT.plan.PlacementPlan.from_dict(
        PLACEMENT["scenarios"]["heavy_analytics"]["search"]["assignments"])
    res = rt.run_plan(plan)
    assert res.ledger.conserved() and math.isfinite(res.vos)


# ------------------------------------------- the broker queue's capacity
def _rec(ts):
    return PORT.streams.Record(ts=ts, values={"v": ts})


def test_queue_capacity_validation_and_drop_oldest():
    Queue = PORT.streams.Queue
    q = Queue("q", capacity=2)
    with pytest.raises(ValueError):
        Queue("bad", capacity=0)
    for i in range(4):
        q.publish(_rec(float(i)))
    assert len(q.buf) == 2 and q.dropped == 2
    assert [r.ts for r in q.fetch("c")] == [2.0, 3.0]
    assert q.base_seq == 2


def test_queue_set_capacity_shrink_drops_oldest():
    q = PORT.streams.Queue("q", capacity=8)
    for i in range(6):
        q.publish(_rec(float(i)))
    q.fetch("seen")
    q.set_capacity(2)
    assert len(q.buf) == 2 and q.dropped == 4 and q.base_seq == 4
    with pytest.raises(ValueError):
        q.set_capacity(0)
    assert [r.ts for r in q.fetch("late")] == [4.0, 5.0]


def test_queue_backlog_per_consumer():
    q = PORT.streams.Queue("q", capacity=4)
    for i in range(3):
        q.publish(_rec(float(i)))
    assert q.backlog("c") == 3
    q.fetch("c")
    assert q.backlog("c") == 0
    for i in range(6):
        q.publish(_rec(float(3 + i)))
    assert q.backlog("c") == 4


def test_broker_queue_explicit_capacity_applies():
    b = PORT.streams.Broker()
    q = b.queue("x")
    for i in range(5):
        q.publish(_rec(float(i)))
    q2 = b.queue("x", capacity=3)
    assert q2 is q and q.capacity == 3
    assert len(q.buf) == 3 and q.dropped == 2


def test_serve_exports_the_references_names():
    names = ("DCPool", "FarmDriver", "PlacementRouter", "ServeConfig",
             "ServeRuntime", "ServeTelemetry", "ServiceStage", "StageFire",
             "UplinkShaper", "VirtualClock", "serve_scenario")
    for pkg in (REF, PORT):
        for n in names:
            assert getattr(pkg.serve, n).__module__.startswith(
                f"{pkg.name}.serve")
