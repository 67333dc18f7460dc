"""ServeRuntime: execute a compiled ScenarioSpec on real record streams.

The runtime is the engine's live twin: it takes the *same* ``build``
callable, profiles and :class:`~repro_torch.scenario.engine.EngineConfig` a
``ScenarioSpec.compile()`` produces, but instead of replaying a cached
functional drive under a DES it runs the actual
:class:`~repro_torch.pipeline.composition.Pipeline` operators on an asyncio
event loop in deterministic virtual time: farms publish real records,
stages fetch/fire through :class:`~repro_torch.pipeline.adapters.StageAdapter`
with bounded-queue backpressure, placement is executed as routing
(serial gateway devices, uplink shaper, DC chip pool), and telemetry is
*measured* rather than simulated.

Interchangeability is the contract
(:class:`~repro_torch.scenario.observe.ObservationSource`): ``info()`` hands
controllers the same :class:`~repro_torch.scenario.observe.BridgeInfo`,
``run(controller)`` asks ``decide`` at every epoch boundary with a
measured :class:`~repro_torch.scenario.observe.EpochObservation` — so an
:class:`~repro_torch.online.controller.OnlineController` makes live
re-placement decisions mid-run and its
:class:`~repro_torch.scenario.feedback.CalibrationLoop` trains on measured
residuals through the unchanged ``feedback`` API — and the result is
the same :class:`~repro_torch.scenario.engine.EngineResult` (with ``dc=None``:
there is no DES to report).

What deliberately diverges from the engine (the measured sim-to-real
gap ``benchmarks/bench_serve.py`` quantifies):

* **Late data.** A fire's window is whatever has physically arrived at
  dispatch; the DES instead waits for upstream settlement.
* **Serial operators.** A stage is one operator instance; a fire that
  outlives the slide delays the next dispatch. The DES overlaps a
  service's DC fires freely.
* **Analytic DC.** DC fires are priced by the same roofline cells but
  run under a plain chip pool, not the JITA-4DS scheduler.
* **No clairvoyance.** ``rates_oracle`` falls back to the trailing
  measurement (first epoch: the controller's own prior of 1 rec/s);
  ``down_oracle`` still reads the *declared* outage schedule.
"""
from __future__ import annotations

import asyncio
import dataclasses
import math
from typing import (AsyncIterator, Callable, Dict, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np

from repro_torch.chaos.inject import ChaosTimeline, FaultObservation
from repro_torch.chaos.migrate import plan_chaos_migrations
from repro_torch.core.elastic import ServiceMigration
from repro_torch.online.fleet import Fleet
from repro_torch.pipeline.adapters import StageAdapter
from repro_torch.pipeline.composition import Pipeline
from repro_torch.placement.plan import SITE_DC, PlacementPlan
from repro_torch.scenario.engine import (_SHARED_FIELDS, _FixedPlan,
                                         _infeasible, CoSimResult,
                                         EngineConfig, EngineResult,
                                         analytics_cost_model)
from repro_torch.scenario.ledger import (RecordLedger, ServiceLedger,
                                         _topo_order, tap_pipeline)
from repro_torch.scenario.observe import (BridgeInfo, EpochObservation,
                                          ServiceInfo, attach_forecast,
                                          epoch_bounds, merge_realized_vos)
from repro_torch.scenario.profiles import ServiceProfile
from repro_torch.serve.clock import VirtualClock
from repro_torch.serve.metrics import ServeTelemetry
from repro_torch.serve.router import PlacementRouter
from repro_torch.serve.shaper import UplinkShaper
from repro_torch.serve.stage import FarmDriver, ServiceStage

_EPS = 1e-9


@dataclasses.dataclass
class ServeConfig:
    """Serving-only knobs (everything physical comes from the shared
    ``EngineConfig``). ``stage_capacity`` bounds every stage-to-stage
    queue: a publishing stage parks until the downstream backlog drops
    below it (``None`` = unbounded, broker capacity is the only bound).
    ``shed_after_s`` drops a fire whose pre-start wait already exceeds
    the budget (records roll into the next window; ``None`` = never
    shed, the engine's behavior). ``settle_rounds`` caps event-loop
    passes per virtual instant before declaring a livelock."""
    stage_capacity: Optional[int] = None
    shed_after_s: Optional[float] = None
    settle_rounds: int = 200_000


class ServeRuntime:
    """Live serving twin of :class:`~repro_torch.scenario.engine.ScenarioEngine`
    — same constructor shape, same controller contract, measured
    telemetry. Usually constructed via :func:`serve_scenario`."""

    def __init__(self, build: Callable[[], Pipeline],
                 profiles: Dict[str, ServiceProfile],
                 cfg: EngineConfig,
                 outages: Optional[Mapping[str, Sequence[Tuple[float, float]]]]
                 = None,
                 serve: Optional[ServeConfig] = None):
        self.build = build
        self.profiles = dict(profiles)
        self.cfg = cfg
        self.outages = {k: tuple(v) for k, v in (outages or {}).items()}
        self.serve = serve or ServeConfig()
        pipe = build()
        self.topology = pipe.topology()
        names = [s.cfg.name for s in pipe.services]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate service names: {names}")
        missing = set(self.topology) - set(self.profiles)
        if missing:
            raise ValueError(f"no ServiceProfile for {sorted(missing)}")
        self.order = _topo_order(self.topology, names)
        self.rank = {s: i for i, s in enumerate(self.order)}
        self.cost = analytics_cost_model(self.profiles, cfg)
        self.services_info = {
            s.cfg.name: ServiceInfo(queue=s.cfg.queue,
                                    slide_s=s.cfg.window.slide_s,
                                    width_s=s.cfg.window.width_s,
                                    buffer_budget=s.cfg.buffer_budget)
            for s in pipe.services}
        self.epoch_s = cfg.epoch_s or cfg.horizon_s
        self.epochs = epoch_bounds(cfg.horizon_s, cfg.epoch_s)
        self._fresh_pipe: Optional[Pipeline] = pipe
        self._result: Optional[EngineResult] = None
        self.last_telemetry: Optional[ServeTelemetry] = None

    # ----------------------------------------------------------- bridging
    @property
    def all_sites(self) -> Tuple[str, ...]:
        return tuple(self.cfg.fleet.site_names) + (SITE_DC,)

    def info(self) -> BridgeInfo:
        return BridgeInfo(topology=self.topology, profiles=self.profiles,
                          fleet=self.cfg.fleet, services=self.services_info,
                          cost=self.cost,
                          grid_chips=(self.cfg.grid_shape[0]
                                      * self.cfg.grid_shape[1]),
                          epoch_s=self.epoch_s,
                          records_per_step=self.cfg.records_per_step,
                          outages=self.outages)

    def _site_ram_ok(self, plan: PlacementPlan) -> Optional[str]:
        for name in self.cfg.fleet.site_names:
            spec = self.cfg.fleet.site(name).edge
            budget = sum(self.services_info[s].buffer_budget
                         for s in self.order if plan.site(s) == name)
            if spec.ram_required(budget) > spec.ram_bytes:
                return (f"site {name} RAM: buffer budgets need "
                        f"{spec.ram_required(budget)/2**20:.0f} MiB, device "
                        f"has {spec.ram_bytes/2**20:.0f} MiB")
        return None

    def _state_bytes(self, svc: str) -> float:
        return (self.services_info[svc].buffer_budget
                * self.cfg.state_bytes_per_record)

    # ---------------------------------------------------------------- run
    def run(self, controller) -> EngineResult:
        """Serve one plan schedule end-to-end; returns the same result
        type the engine returns (``dc=None``)."""
        async def _drive():
            async for _ in self.iter_epochs(controller):
                pass
            return self._result
        return asyncio.run(_drive())

    def run_plan(self, plan: PlacementPlan,
                 label: Optional[str] = None) -> CoSimResult:
        """One fixed plan for the whole horizon (the engine's
        single-plan surface, served live)."""
        plan.validate(self.topology,
                      grid_chips=self.cfg.grid_shape[0]
                      * self.cfg.grid_shape[1],
                      sites=self.all_sites)
        bad = self._site_ram_ok(plan)
        if bad is not None:
            return _infeasible(plan, bad)
        res = self.run(_FixedPlan(plan, label=label or plan.label))
        return CoSimResult(plan_label=label or plan.label, feasible=True,
                           **{k: getattr(res, k) for k in _SHARED_FIELDS})

    async def iter_epochs(self, controller) -> AsyncIterator[Dict]:
        """Iterator-first serving: set up the live world, yield one
        epoch record per boundary (after the controller's re-placement
        decision has been applied and the epoch has been served), then
        drain in-flight fires and score. After exhaustion the full
        :class:`EngineResult` is available via ``run``'s return or
        ``self._result``."""
        cfg = self.cfg
        pipe, self._fresh_pipe = self._fresh_pipe or self.build(), None
        staps, qtaps = tap_pipeline(pipe)
        clock = VirtualClock(settle_rounds=self.serve.settle_rounds)
        timeline = (ChaosTimeline.compile(
            cfg.chaos, cfg.fleet.site_names, cfg.horizon_s, self.epochs)
            if cfg.chaos is not None else None)
        fleet = Fleet(cfg.fleet, self.outages, chaos=timeline)
        self._duplicates: Dict[str, int] = {}
        link_snap = {s: (0.0, 0) for s in cfg.fleet.site_names}
        link_secs: List[Dict[str, float]] = []
        shaper = UplinkShaper(fleet)
        router = PlacementRouter(
            cost=self.cost,
            grid_chips=cfg.grid_shape[0] * cfg.grid_shape[1],
            records_per_step=cfg.records_per_step,
            state_bytes=self._state_bytes,
            ship_state=shaper.ship_state,
            warmup_s=cfg.migration_warmup_s)
        telemetry = ServeTelemetry(
            self.order,
            {s: self.services_info[s].slide_s for s in self.order},
            self.epochs, cfg.horizon_s)
        self.last_telemetry = telemetry     # inspectable after the run
        dl_user = fleet.downlink_time(cfg.fleet.result_site)

        def origin_site(origin: Optional[str], consumer: str,
                        epoch: int) -> str:
            if origin is None:
                return cfg.fleet.farm_site(self.services_info[consumer].queue)
            return router.site(origin, epoch)

        stages: Dict[str, ServiceStage] = {}
        for svc_obj in pipe.services:
            name = svc_obj.cfg.name
            adapter = StageAdapter(svc_obj, qtaps[name], staps[name])
            stages[name] = ServiceStage(
                adapter, self.rank[name], self.profiles[name], clock,
                router, shaper, telemetry, fleet, self.epochs,
                cfg.horizon_s, origin_site, cfg.fleet.result_site, dl_user,
                stage_capacity=self.serve.stage_capacity,
                shed_after_s=self.serve.shed_after_s)
        # wire downstream consumers: services fed by a queue some
        # upstream stage's sink republishes into
        for up, q in pipe.edges:
            for svc_obj in pipe.services:
                if svc_obj.cfg.queue == q:
                    stages[up].consumers.append(stages[svc_obj.cfg.name])

        step = cfg.drive_step_s or min(self.services_info[s].slide_s
                                       for s in self.order)
        tasks = [clock.spawn(FarmDriver(farm, clock, cfg.horizon_s,
                                        step).run())
                 for farm in pipe.farms]
        tasks += [clock.spawn(stages[s].run()) for s in self.order]

        charge = getattr(controller, "charge_migrations", True)
        bind = getattr(controller, "bind", None)
        if bind is not None:
            bind(self.info())

        epoch_meta: List[Dict] = []
        n_migs = 0
        rates_window: List[Dict[str, float]] = []
        try:
            for k, (t0, t1) in enumerate(self.epochs):
                obs = EpochObservation(
                    epoch=k, t0=t0, t1=t1,
                    rates_window=list(rates_window),
                    realized_window=telemetry.realized_upto(k),
                    down_now={s: fleet.site(s).failed_at(t0)
                              for s in cfg.fleet.site_names},
                    rates_oracle=(dict(rates_window[-1]) if rates_window
                                  else {s: 1.0 for s in self.order}),
                    down_oracle={s: any(d < t1 and u > t0
                                        for d, u in fleet.site(s).outages)
                                 for s in cfg.fleet.site_names},
                    partitioned_now={s: fleet.site(s).partitioned_at(t0)
                                     for s in cfg.fleet.site_names},
                    link_secs_window=[dict(d) for d in link_secs])
                plan = controller.decide(obs)
                plan.validate(self.topology,
                              grid_chips=cfg.grid_shape[0]
                              * cfg.grid_shape[1],
                              sites=self.all_sites)
                bad = self._site_ram_ok(plan)
                if bad is not None:
                    raise ValueError(f"epoch {k}: infeasible plan from "
                                     f"{type(controller).__name__}: {bad}")
                migs: List[ServiceMigration] = router.push_plan(
                    plan, t0, charge=charge)
                n_migs += len(migs)

                # mid-epoch chaos reaction: cut the epoch at realized
                # fault boundaries so a chaos-aware controller can push
                # an emergency plan (fires dispatched after the push
                # route under it); the controller sees only the realized
                # world, never the fault schedule
                chaos_log: List[Dict] = []
                react = (timeline is not None
                         and getattr(controller, "decide_fault", None)
                         is not None)
                for T in (timeline.boundaries(t0, t1) if react else []):
                    await clock.advance_past(T)
                    fobs = FaultObservation(
                        t=T, epoch=k,
                        down_now={s: fleet.site(s).failed_at(T)
                                  for s in cfg.fleet.site_names},
                        partitioned_now={s: fleet.site(s).partitioned_at(T)
                                         for s in cfg.fleet.site_names},
                        straggle_now={s: fleet.site(s).straggle_factor(T)
                                      for s in cfg.fleet.site_names},
                        events=timeline.events_at(T))
                    plan2 = controller.decide_fault(fobs)
                    if plan2 is None:
                        continue
                    entry = self._adopt_replan(
                        plan2, T, k, fobs, charge, router, fleet, shaper,
                        telemetry,
                        rates_window[-1] if rates_window else {})
                    chaos_log.append(entry)
                    n_migs += len(entry["migrations"])

                await clock.advance_past(t1)
                # close the epoch's uplink telemetry window: mean
                # serialization seconds per transfer at each site
                window: Dict[str, float] = {}
                for s in cfg.fleet.site_names:
                    site = fleet.site(s)
                    b0, n0 = link_snap[s]
                    db = site.link_busy_s - b0
                    dn = site.link_transfers - n0
                    link_snap[s] = (site.link_busy_s, site.link_transfers)
                    window[s] = db / dn if dn > 0 else 0.0
                link_secs.append(window)
                rates_window.append(telemetry.measured_rates(k))
                meta = {
                    "epoch": k, "t0": t0, "t1": t1, "plan": plan.label,
                    "migrations": [
                        {"service": m.service, "src": m.src, "dst": m.dst,
                         "stall_s": round(m.stall_s, 3)} for m in migs],
                    "rates_measured": {s: round(r, 6) for s, r
                                       in rates_window[-1].items()},
                }
                if chaos_log:
                    meta["chaos"] = chaos_log
                attach_forecast(controller, k, meta)
                epoch_meta.append(meta)
                yield meta

            # ---- drain: finish in-flight fires past the horizon ---------
            for _ in range(len(self.order) + 2):
                await clock.advance_past(float("inf"))
                if all(t.done() for t in tasks):
                    break
                for st in stages.values():   # chained backpressure parks
                    st.notify_fetch()
            await asyncio.gather(*tasks)
        finally:
            for t in tasks:
                if not t.done():
                    t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        self._result = self._score(pipe, staps, qtaps, fleet, router,
                                   telemetry, epoch_meta, n_migs, controller)

    # ---------------------------------------------------------- chaos path
    def _adopt_replan(self, plan: PlacementPlan, T: float, k: int,
                      fobs, charge: bool, router: PlacementRouter,
                      fleet: Fleet, shaper, telemetry: ServeTelemetry,
                      rates_k: Dict[str, float]) -> Dict:
        """Adopt an emergency mid-epoch plan at time ``T`` with the
        checkpoint-aware live/cold migration semantics (the serve twin
        of ``ScenarioEngine._adopt_replan``: measured fire counts stand
        in for the DES fire trace)."""
        plan.validate(self.topology,
                      grid_chips=self.cfg.grid_shape[0]
                      * self.cfg.grid_shape[1],
                      sites=self.all_sites)
        bad = self._site_ram_ok(plan)
        if bad is not None:
            raise ValueError(f"epoch {k}: infeasible fault re-plan: {bad}")
        chaos = self.cfg.chaos
        ck = max(1, chaos.checkpoint_every)
        old = router.plans[-1]

        def _replay_records(svc: str) -> int:
            fires = telemetry.fires[svc]
            i_t = len(fires)
            return sum(f.n_new for f in fires[(i_t // ck) * ck:i_t])

        def _replay_time(svc: str, n: int, dst: str) -> float:
            if dst == SITE_DC:
                return router.dc_cost(svc, n, plan.placement(svc))[0]
            return fleet.site(dst).node.fire_time(
                n, self.profiles[svc].flops_per_record)

        def _drain(svc: str) -> float:
            src = old.site(svc)
            if src == SITE_DC:
                return 0.0
            return max(0.0, fleet.site(src).node.busy_until - T)

        def _src_dead(s: str) -> bool:
            if s == SITE_DC:
                return False
            site = fleet.site(s)
            return site.crashed_at(T) or site.partitioned_at(T)

        def _local_origin(svc: str, dst: str) -> bool:
            return (not self.topology[svc]
                    and self.cfg.fleet.farm_site(
                        self.services_info[svc].queue) == dst)

        def _ckpt_bytes(svc: str) -> float:
            return (self.services_info[svc].buffer_budget
                    * chaos.checkpoint_bytes_per_record)

        migs = plan_chaos_migrations(
            chaos, old.assignments, plan.assignments, T,
            src_dead=_src_dead, ship=shaper.ship_state,
            state_bytes=self._state_bytes, ckpt_bytes=_ckpt_bytes,
            replay_records=_replay_records, replay_time=_replay_time,
            rate_rps=lambda svc: rates_k.get(svc, 0.0),
            drain_s=_drain, dc_site=SITE_DC, local_origin=_local_origin,
            warmup_s=self.cfg.migration_warmup_s, charge=charge)
        for m in migs:
            if m.duplicates:
                self._duplicates[m.service] = (
                    self._duplicates.get(m.service, 0) + m.duplicates)
        router.push_plan(plan, T, charge=charge, epoch=k, migrations=migs)
        return {"t": round(T, 6), "plan": plan.label,
                "trigger": list(fobs.events),
                "migrations": [m.digest() for m in migs]}

    # -------------------------------------------------------------- score
    def _score(self, pipe, staps, qtaps, fleet: Fleet,
               router: PlacementRouter, telemetry: ServeTelemetry,
               epoch_meta: List[Dict], n_migs: int,
               controller) -> EngineResult:
        vos = max_vos = 0.0
        latencies: List[float] = []
        completed = dropped = inflight = 0
        dc_energy = 0.0
        ep_vos = [0.0] * len(self.epochs)
        per_service: Dict[str, Dict] = {}
        for svc in self.order:
            prof = self.profiles[svc]
            s_lat: List[float] = []
            s_done = s_drop = s_wait = 0
            for f in telemetry.fires[svc]:
                max_vos += prof.slo.max_value
                if f.done:
                    s_done += 1
                    s_lat.append(f.lat_s)
                    if f.site == SITE_DC:
                        dc_energy += f.energy_j
                elif f.shed:
                    s_drop += 1
                else:
                    s_wait += 1
                ep_vos[f.epoch] += f.value
                vos += f.value
            completed += s_done
            dropped += s_drop
            inflight += s_wait
            latencies.extend(s_lat)
            per_service[svc] = {
                "site": router.plans[-1].placement(svc).label
                if router.plans else "",
                "fires": len(telemetry.fires[svc]), "completed": s_done,
                "dropped": s_drop, "inflight": s_wait,
                "vos": round(sum(f.value for f in telemetry.fires[svc]), 4),
                "latency_p95": round(float(np.percentile(s_lat, 95)), 4)
                if s_lat else float("nan"),
            }
        merge_realized_vos(epoch_meta, ep_vos)

        ledger, per_site = self._ledger(pipe, staps, qtaps, fleet, telemetry)
        lat = (np.asarray(latencies) if latencies
               else np.asarray([float("nan")]))
        p50, p95, p99 = np.percentile(lat, (50, 95, 99))
        return EngineResult(
            label=getattr(controller, "label", type(controller).__name__),
            vos=vos, vos_normalized=vos / max(max_vos, 1e-6),
            fires_total=sum(len(fl) for fl in telemetry.fires.values()),
            fires_completed=completed, fires_dropped=dropped,
            fires_inflight=inflight,
            latency_p50=float(p50), latency_p95=float(p95),
            latency_p99=float(p99),
            edge_energy_j=fleet.edge_energy_j,
            network_energy_j=fleet.network_energy_j,
            dc_energy_j=dc_energy,
            bytes_up=fleet.bytes_up, bytes_down=fleet.bytes_down,
            uplink_wait_s=fleet.uplink_wait_s,
            uplink_transfers=fleet.uplink_transfers,
            migrations=n_migs, ledger=ledger, per_site=per_site,
            per_service=per_service, epochs=epoch_meta, dc=None)

    def _ledger(self, pipe, staps, qtaps, fleet: Fleet,
                telemetry: ServeTelemetry
                ) -> Tuple[RecordLedger, Dict[str, Dict]]:
        """Same conservation schema as the engine, from the live taps:
        identity partitions over what the runtime actually published,
        dropped, fetched and covered. Fires that never ran (shed, or
        truncated by a crash) claim nothing — their records stay in the
        ``buffered``/``unread`` buckets, so the ledger still conserves."""
        ledger = RecordLedger()
        site_processed: Dict[str, int] = {s: 0
                                          for s in self.cfg.fleet.site_names}
        site_processed[SITE_DC] = 0
        for svc_obj in pipe.services:
            name = svc_obj.cfg.name
            tap, qtap = staps[name], qtaps[name]
            fetched_ids = set(qtap.fetched.get(name, {}))
            covered_ids = set(tap.covered)
            buf_ids = set(map(id, svc_obj.buffer))
            drop_ids = set(map(id, qtap.drop_refs))
            evicted_unc = fetched_ids - buf_ids - covered_ids
            sl = ServiceLedger(
                service=name, queue=svc_obj.cfg.queue,
                produced=len(qtap.pub_refs),
                overflow=len(drop_ids - fetched_ids),
                unread=len(set(map(id, svc_obj.q.buf)) - fetched_ids),
                fetched=len(fetched_ids),
                buffered=len(buf_ids - covered_ids),
                **{("evicted_stored" if svc_obj.cfg.store is not None
                    else "evicted_lost"): len(evicted_unc)})
            sl.duplicates = getattr(self, "_duplicates", {}).get(name, 0)
            for f in telemetry.fires[name]:
                if not f.done:
                    continue        # shed/unfired: records roll or buffer
                if f.site != SITE_DC:
                    sl.processed_edge += f.n_new
                    site_processed[f.site] += f.n_new
                else:
                    sl.processed_dc += f.n_new
                    site_processed[SITE_DC] += f.n_new
            ledger.services[name] = sl
        per_site = fleet.per_site_energy()
        for s, n in site_processed.items():
            per_site.setdefault(s, {})["records_processed"] = n
        return ledger, per_site


def serve_scenario(spec, calibrator=None,
                   serve: Optional[ServeConfig] = None) -> ServeRuntime:
    """``ScenarioSpec`` → live runtime — the serving counterpart of
    ``spec.compile()``: same validation, same profiles (optionally
    kernel-calibrated), same engine config; only the execution substrate
    differs."""
    spec.validate()
    if calibrator is not None:
        from repro_torch.scenario.calibrate import calibrate_profiles
        profiles, _ = calibrate_profiles(spec, calibrator)
    else:
        profiles = spec.profiles()
    return ServeRuntime(spec.build_pipeline, profiles, spec.engine_config(),
                        outages=spec.outage_map(), serve=serve)
