"""The modules the port's scenario engine imports — chaos, failure
injection, the fleet, drift, regions, the ledger and the feedback loop —
against their JAX counterparts (the cases of tests/test_chaos.py,
test_online.py, test_region.py, test_ledger_properties.py and
test_feedback.py). They are carried as they are, so every draw, window,
arrival time, ledger total and correction must be equal, not close."""
import dataclasses
import importlib
import json
import math
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(2)


def _package(name):
    mod = importlib.import_module
    return SimpleNamespace(
        name=name, scenario=mod(f"{name}.scenario"),
        engine=mod(f"{name}.scenario.engine"),
        placement=mod(f"{name}.placement"),
        edge=mod(f"{name}.placement.edge"),
        network=mod(f"{name}.placement.network"),
        online=mod(f"{name}.online"), fleet=mod(f"{name}.online.fleet"),
        region=mod(f"{name}.region"), chaos=mod(f"{name}.chaos"),
        failure=mod(f"{name}.checkpoint.failure"),
        pipeline=mod(f"{name}.pipeline"))


REF, PORT = _package("repro"), _package("repro_torch")


def _both(fn):
    """fn run through each package; the two results."""
    return fn(REF), fn(PORT)


# ---------------------------------------------------------------- chaos
def _chaos_spec(pkg):
    c = pkg.chaos
    return c.ChaosSpec(
        crashes=(c.SiteCrash(site="gw-a", at_s=100.0, recover_s=400.0),),
        partitions=(c.Partition(site="gw-b", at_s=50.0, heal_s=200.0),),
        straggles=(c.LinkStraggle(site="gw-a", at_s=500.0, until_s=700.0,
                                  factor=4.0),),
        migration="live", ledger_mode="at_least_once",
        checkpoint_every=8, p_crash=0.01, seed=7)


def test_chaos_spec_roundtrip_equal():
    ref, port = _both(_chaos_spec)
    d = json.loads(json.dumps(port.to_dict()))
    assert d == json.loads(json.dumps(ref.to_dict()))
    assert PORT.chaos.ChaosSpec.from_dict(d) == port


_BAD = {
    "migration": lambda c: dict(migration="teleport"),
    "ledger_mode": lambda c: dict(ledger_mode="maybe_once"),
    "unknown site": lambda c: dict(crashes=(
        c.SiteCrash(site="nope", at_s=0.0, recover_s=1.0),)),
    "empty crash": lambda c: dict(crashes=(
        c.SiteCrash(site="gw-a", at_s=5.0, recover_s=5.0),)),
    "straggle factor": lambda c: dict(straggles=(
        c.LinkStraggle(site="gw-a", at_s=0.0, until_s=1.0, factor=0.5),)),
}


@pytest.mark.parametrize("bad", sorted(_BAD))
def test_chaos_spec_validation_rejects(bad):
    """Both packages refuse the same spec with the same message."""
    errors = []
    for pkg in (REF, PORT):
        with pytest.raises(ValueError) as e:
            pkg.chaos.ChaosSpec(**_BAD[bad](pkg.chaos)).validate(
                ["gw-a", "gw-b"])
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("seed", [3, 11])
def test_chaos_timeline_random_crashes_equal(seed):
    epochs = [(0.0, 300.0), (300.0, 600.0), (600.0, 900.0)]

    def windows(pkg):
        t = pkg.chaos.ChaosTimeline.compile(
            pkg.chaos.ChaosSpec(p_crash=0.5, seed=seed), ["gw-a", "gw-b"],
            900.0, epochs)
        return ({s: t.crash_windows(s) for s in ("gw-a", "gw-b")},
                t.boundaries(0.0, 900.0), t.any_faults())

    ref, port = _both(windows)
    assert port == ref
    assert port == windows(PORT)                 # deterministic
    if seed == 3:
        assert port[2]                           # seed 3 fires


@pytest.mark.parametrize("p,seed", [(0.3, 42), (0.1, 7), (0.5, 0)])
def test_failure_injector_step_keyed(p, seed):
    """Draws keyed by step: out-of-order consumption fires the same steps,
    each once, and the steps equal the JAX package's."""
    F = PORT.failure.FailureInjector
    a, b = F(p_fail=p, seed=seed), F(p_fail=p, seed=seed)
    order_a = [5, 1, 3, 0, 2, 4, 9, 7, 8, 6]
    fired_a = {s for s in order_a if a.should_fail(s)}
    fired_b = {s for s in range(10) if b.should_fail(s)}
    assert fired_a == fired_b == set(a.fail_times(10))
    assert not any(a.should_fail(s) for s in fired_a)     # fire-once
    assert (F(p_fail=p, seed=seed).fail_times(100)
            == REF.failure.FailureInjector(p_fail=p, seed=seed)
            .fail_times(100))


class _MemoryCheckpoints:
    """A checkpoint manager that keeps states in a dict."""

    def __init__(self, every):
        self.every, self.saved = every, {}

    def maybe_save(self, step, state):
        if step % self.every == 0:
            self.saved[step] = dict(state)

    def restore_latest(self, template, shardings=None):
        if not self.saved:
            raise FileNotFoundError
        step = max(self.saved)
        return dict(self.saved[step]), step

    def finalize(self):
        pass


def test_run_with_restarts_equal():
    def run(pkg):
        def one_step(state, step):
            return {"w": state["w"] + step + 1}, {"w0": state["w"]}
        return pkg.failure.run_with_restarts(
            init_state={"w": 0.0}, train_one_step=one_step,
            ckpt_manager=_MemoryCheckpoints(3), n_steps=20,
            injector=pkg.failure.FailureInjector(p_fail=0.2, seed=5))

    ref, port = _both(run)
    assert port == ref
    state, history, restarts = port
    assert restarts > 0 and [s for s, _ in history] == list(range(20))
    assert state == {"w": 210.0}


# ---------------------------------------------------------------- fleet
def test_linkqueue_withdraw_exact_restore():
    def run(pkg):
        q = pkg.fleet.LinkQueue()
        q.admit(0.0, 2.0)
        tok = q.last_token
        q.admit(1.0, 3.0)
        before = (q.busy_until, q.queue_wait_s, q.transfers)
        assert q.withdraw(tok) and not q.withdraw(tok)
        after = (q.busy_until, q.queue_wait_s, q.transfers)
        q.admit(0.0, 1.0)
        q.admit(0.0, 1.0)
        assert q.withdraw_last() and q.withdraw_last()
        return before, after, (q.busy_until, q.queue_wait_s, q.transfers)

    ref, port = _both(run)
    assert port == ref
    assert port[0] == (5.0, 1.0, 2) and port[1] == (4.0, 0.0, 1)


def test_fleet_routing_legs_equal():
    def run(pkg):
        S, E, L = pkg.fleet.SiteSpec, pkg.edge.EdgeSpec, pkg.network.LinkSpec
        fleet = pkg.fleet.Fleet(pkg.fleet.FleetSpec(sites=(
            S("a", E(), L(uplink_bps=1e4, rtt_s=0.1, record_bytes=100.0)),
            S("b", E(), L(uplink_bps=1e4, rtt_s=0.2, record_bytes=100.0)))))
        legs = [fleet.ship_records("a", "dc", 10, 0.0),
                fleet.ship_records("a", "b", 10, 10.0),
                fleet.ship_records("a", "a", 10, 5.0),
                fleet.ship_state("a", "b", 5000.0, 0.0),
                fleet.ship_result("b", "a", 20.0)]
        return legs, [(s.net.bytes_up, s.net.bytes_down, s.net.energy_j)
                      for s in fleet.sites.values()], fleet.uplink.transfers

    ref, port = _both(run)
    assert port == ref
    assert port[0][0] == pytest.approx(0.05 + 1000 / 1e4)
    assert port[0][2] == 5.0


@pytest.mark.parametrize("seed", [7, 8])
def test_drifting_farm_records_equal(seed):
    def stream(pkg):
        b = pkg.pipeline.Broker()
        farm = pkg.online.DriftingFarm(
            b, pkg.online.poisson_bursts(2.0, 8.0, 300.0, mean_gap_s=60.0,
                                         mean_len_s=30.0, seed=9),
            n_things=3, seed=seed)
        farm.advance_to(300.0)
        return [(r.ts, sorted(r.values.items()))
                for r in b.queue("neubotspeed").buf]

    ref, port = _both(stream)
    assert port == ref and len(port) > 100


# -------------------------------------------------------------- regions
def _sites(pkg, *names):
    return tuple(pkg.fleet.SiteSpec(name=n, edge=pkg.edge.EdgeSpec(name=n),
                                    link=pkg.network.LinkSpec())
                 for n in names)


def test_regions_view_flat_and_hier_equal():
    def views(pkg):
        r = pkg.region
        flat = pkg.fleet.FleetSpec(sites=_sites(pkg, "a", "b"))
        hier = r.HierFleetSpec(sites=_sites(pkg, "a", "b"), regions=(
            r.RegionSpec("r0", ("a",), r.DEFAULT_RAP),
            r.RegionSpec("r1", ("b",), r.TRANSPARENT_RAP)))
        return [[(v.name, v.sites, v.transparent, dataclasses.asdict(v.rap))
                 for v in r.regions_view(f)] for f in (flat, hier)]

    ref, port = _both(views)
    assert port == ref
    assert port[0][0][2] and [v[0] for v in port[1]] == ["r0", "r1"]


def _two_site_spec(pkg):
    b = (pkg.scenario.scenario("hier")
         .horizon(600.0)
         .site("gw-a", edge=pkg.edge.EdgeSpec(name="gw-a"),
               link=pkg.network.LinkSpec(uplink_bps=40e3), user=True)
         .site("gw-b", edge=pkg.edge.EdgeSpec(name="gw-b"),
               link=pkg.network.LinkSpec(uplink_bps=30e3))
         .farm(queue="neubotspeed", n_things=4, seed=3, site="gw-a",
               rate=pkg.scenario.RateSpec.constant(3.0))
         .service("agg", queue="neubotspeed", column="download_speed",
                  agg="max", width_s=120, slide_s=30)
         .slo(soft_latency_s=2.0, hard_latency_s=10.0)
         .profile(flops_per_record=2e3))
    b.region("all", "gw-a", "gw-b", rap=pkg.region.TRANSPARENT_RAP)
    return b.build()


def test_hier_spec_json_roundtrip_and_run_equal():
    """A HierFleetSpec behind a transparent (infinite) RAP survives JSON,
    equal to the JAX package's string, and runs the same."""
    def run(pkg):
        spec = _two_site_spec(pkg)
        back = pkg.scenario.ScenarioSpec.from_dict(
            json.loads(json.dumps(spec.to_dict())))
        assert back == spec and math.isinf(back.regions[0].rap.uplink_bps)
        assert isinstance(spec.fleet_spec(), pkg.region.HierFleetSpec)
        r = spec.compile().run_plan(
            pkg.placement.PlacementPlan.all_dc(["agg"], chips=4))
        return spec.to_json(), r.vos, r.energy_total_j, r.ledger.totals()

    ref, port = _both(run)
    assert port == ref


# ------------------------------------------------- engine under a crash
def _crash_mini(pkg, mode):
    c = pkg.chaos
    chaos = c.ChaosSpec(crashes=(c.SiteCrash(site="gw-a", at_s=350.0,
                                             recover_s=1000.0),),
                        migration="cold", ledger_mode=mode)
    E, L = pkg.edge.EdgeSpec, pkg.network.LinkSpec
    return (pkg.scenario.scenario("chaos_mini")
            .site("gw-a", edge=E(name="gw-a", throughput_rps=2000.0,
                                 active_power_w=1.0,
                                 energy_per_record_j=50e-6),
                  link=L(uplink_bps=15e3, downlink_bps=2e6, rtt_s=0.040,
                         record_bytes=64.0, compression=0.25))
            .site("gw-b", edge=E(name="gw-b", throughput_rps=1500.0,
                                 flops_per_s=15e9, active_power_w=1.2,
                                 energy_per_record_j=60e-6),
                  link=L(uplink_bps=12e3, downlink_bps=2e6, rtt_s=0.060,
                         record_bytes=64.0, compression=0.25))
            .horizon(1200.0).epochs(300.0).dc(dc_step_floor_s=2e-3)
            .farm(n_things=6, seed=11, site="gw-a",
                  rate=pkg.scenario.RateSpec.constant(4.0))
            .service("agg", queue="neubotspeed", column="download_speed",
                     agg="max", width_s=120, slide_s=30, buffer_budget=8192)
            .slo(soft_latency_s=2.0, hard_latency_s=10.0,
                 soft_energy_j=0.3, hard_energy_j=3.0)
            .profile(flops_per_record=2e3)
            .chaos(chaos)
            .build())


def _fixed_with_fallback(pkg):
    """A fixed plan (agg on gw-a) that moves agg to gw-b at the first
    realized crash and keeps it there: the engine's mid-epoch re-plan and
    chaos migrations, driven the same way in both packages."""
    P = pkg.placement.PlacementPlan

    class FixedWithFallback(pkg.engine._FixedPlan):
        def __init__(self):
            super().__init__(P.all_edge(["agg"], site="gw-a"), "pin-a")
            self.fallback = P.all_edge(["agg"], site="gw-b")

        def decide_fault(self, fobs):
            if any(fobs.down_now.values()) and self.plan is not self.fallback:
                self.plan = self.fallback
                return self.plan
            return None

    return FixedWithFallback()


@pytest.mark.parametrize("mode", ["exactly_once", "at_least_once"])
def test_engine_under_site_crash_equal(mode):
    def run(pkg):
        r = _crash_mini(pkg, mode).compile().run(_fixed_with_fallback(pkg))
        assert r.ledger.conserved()
        return (r.vos, r.energy_total_j, r.ledger.totals(),
                json.dumps(r.summary(), sort_keys=True))

    ref, port = _both(run)
    assert port == ref
    epochs = json.loads(port[3])["epochs"]
    replans = [e for ep in epochs for e in ep.get("chaos", ())]
    assert replans, "no mid-epoch re-plan fired"
    if mode == "exactly_once":
        assert "duplicates" not in port[2]
    else:
        declared = sum(m["replay_records"] for e in replans
                       for m in e["migrations"] if m["duplicates"])
        assert declared > 0 and port[2]["duplicates"] == declared


# ----------------------------------------------- ledger conservation
_WINDOWS = [(60.0, 30.0), (120.0, 60.0), (90.0, 45.0)]


def _ledger_case(pkg, c):
    """A small scenario and plan from the drawn parameters ``c`` (the
    generator of tests/test_ledger_properties.py)."""
    sites = ["gw-a", "gw-b"][:c["n_sites"]]
    slo = dict(soft_latency_s=2.0, hard_latency_s=10.0, soft_energy_j=0.5,
               hard_energy_j=10.0)
    R = pkg.scenario.RateSpec
    b = pkg.scenario.scenario("ledger-prop").horizon(180.0)
    for s in sites:
        b.site(s, edge=pkg.edge.EdgeSpec(name=s),
               link=pkg.network.LinkSpec(uplink_bps=2e5, record_bytes=128.0))
    rate = c["rate"]
    b.farm(n_things=c["n_things"], seed=c["seed"], site=sites[0],
           rate=(R.bursts(rate, rate * 4.0, [(60.0, 120.0)]) if c["bursty"]
                 else R.constant(rate)))
    names = ["svc0"]
    w = [_WINDOWS[i] for i in c["widths"]]
    (b.service("svc0", queue="neubotspeed", column="download_speed",
               agg="max", width_s=w[0][0], slide_s=w[0][1],
               buffer_budget=c["budgets"][0])
     .slo(**slo).profile(flops_per_record=2e3))
    if c["store"]:
        b.with_store(chunk_seconds=60.0, edge_budget_chunks=2)
    if c["shared"]:
        names.append("svc1")
        (b.service("svc1", queue="neubotspeed", column="latency_ms",
                   agg="mean", width_s=w[1][0], slide_s=w[1][1],
                   buffer_budget=c["budgets"][1])
         .slo(**slo).profile(flops_per_record=2e3))
    if c["chain"]:
        names.append("tail")
        (b.service("tail", queue="svc0_out", column="value", agg="mean",
                   width_s=w[2][0], slide_s=w[2][1],
                   buffer_budget=c["budgets"][2])
         .fed_by("svc0").slo(**slo).profile(flops_per_record=2e3))
    SP = pkg.placement.ServicePlacement
    options = [SP(s) for s in sites] + [SP("dc", chips=4)]
    plan = pkg.placement.PlacementPlan(
        {n: options[c["options"][i] % len(options)]
         for i, n in enumerate(names)})
    return b.build(), plan


def test_ledger_conserves_at_every_cut():
    """On drawn specs and plans: the port's ledger partitions every cut
    (broker queue, service buffer, fire outcomes, sites), and equals the
    JAX package's."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies
    cases = st.fixed_dictionaries({
        "n_sites": st.integers(1, 2), "shared": st.booleans(),
        "chain": st.booleans(), "rate": st.sampled_from([1.0, 2.5, 4.0]),
        "bursty": st.booleans(), "n_things": st.integers(1, 3),
        "budgets": st.lists(st.sampled_from([64, 256, 4096]), min_size=3,
                            max_size=3),
        "widths": st.lists(st.integers(0, 2), min_size=3, max_size=3),
        "store": st.booleans(), "seed": st.integers(0, 10),
        "options": st.lists(st.integers(0, 2), min_size=3, max_size=3)})

    @hypothesis.settings(max_examples=6, deadline=None, database=None)
    @hypothesis.given(c=cases)
    def check(c):
        results = []
        for pkg in (REF, PORT):
            spec, plan = _ledger_case(pkg, c)
            res = spec.compile().run(pkg.engine._FixedPlan(plan))
            results.append(res)
        ref, res = results
        ledger = res.ledger
        assert ledger.conserved()
        assert ledger.totals() == ref.ledger.totals() and res.vos == ref.vos
        for name, sl in ledger.services.items():
            assert sl.produced == sl.overflow + sl.unread + sl.fetched, name
            assert sl.fetched == (sl.covered + sl.buffered
                                  + sl.evicted_stored + sl.evicted_lost), name
            assert sl.covered == (sl.processed_edge + sl.processed_dc
                                  + sl.dropped_dc + sl.inflight_dc), name
            assert sl.dropped == (sl.overflow + sl.dropped_dc
                                  + sl.evicted_lost)
            assert sl.in_flight == (sl.unread + sl.buffered + sl.inflight_dc
                                    + sl.evicted_stored)
        tot = ledger.totals()
        assert (sum(d.get("records_processed", 0)
                    for d in res.per_site.values())
                == tot["processed_edge"] + tot["processed_dc"])
        assert res.fires_total == (res.fires_completed + res.fires_dropped
                                   + res.fires_inflight)

    check()


# ------------------------------------------------------ feedback loop
def _residuals(pkg):
    """Each epoch's realized residuals, as the controller saw them at the
    last boundary, from an all-edge run of a bursty three-epoch spec."""
    spec = (pkg.scenario.scenario("det")
            .horizon(900.0).epochs(300.0)
            .farm(n_things=4, seed=3, rate=pkg.scenario.RateSpec.bursts(
                2.0, 10.0, [(300.0, 600.0)]))
            .service("agg", queue="neubotspeed", column="download_speed",
                     agg="max", width_s=120, slide_s=30)
            .slo(soft_latency_s=2.0, hard_latency_s=10.0, soft_energy_j=0.3,
                 hard_energy_j=3.0)
            .profile(flops_per_record=2e3)
            .build())
    seen = []

    class Recorder(pkg.engine._FixedPlan):
        def decide(self, obs):
            seen.append(obs.realized_window)
            return self.plan

    spec.compile().run(Recorder(
        pkg.placement.PlacementPlan.all_dc(["agg"], chips=4)))
    return seen[-1]


def test_calibration_loop_from_engine_residuals_equal():
    """The CalibrationLoop fed an engine run's realized residuals against
    a forecast that is off: the same corrections and history in both
    packages, and the DC tier learned something."""
    def fit(pkg):
        loop = pkg.scenario.CalibrationLoop(["agg"])
        for k, realized in enumerate(_residuals(pkg)):
            loop.observe(k, {"agg": {"tier": "dc", "lat_s": 3.0 + k,
                                     "vos": 1.0}}, realized)
        return (loop.history, {s: c.to_dict()
                               for s, c in loop.corrections().items()})

    ref, port = _both(fit)
    assert port == ref
    assert len(port[0]) == 2
    assert not PORT.scenario.ServiceCorrection(**port[1]["agg"]["dc"]) \
        .is_identity
