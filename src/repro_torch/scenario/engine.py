"""The unified co-simulation engine of the port, carried from the JAX
package's ``scenario/engine.py``: one event-feed DES bridge for every
scenario — single-gateway static placements, multi-site fleets, and
online re-placement schedules alike.

The functional dataflow (farms → brokers → services) is driven exactly
once — it does not depend on placement — and the timing / energy of
every fire is replayed under a *plan schedule*: at each epoch boundary a
controller (fixed-plan, static, online, or oracle) decides the placement
for the coming epoch.

DC-placed fires submit *incrementally* into one persistent JITA-4DS
:class:`~repro_torch.core.simulator.Simulator`: a fire's task enters the
live event heap the moment its inputs exist (``Simulator.inject``), and a
downstream fire waits for the task's *actual* completion event — VDC
composition pressure, power-cap contention and scheduler drops are
co-simulated, never estimated. Each DC task is priced by
:func:`analytics_cost_model` from the service's ``ServiceProfile``; a spec
compiled with ``calibrator=KernelCalibrator()`` measures those profiles
by launching the port's CUDA kernels on the card. Grid occupancy and
pending backlog persist across epochs, so a placement switch inherits the
DC's real queue state. Site moves ship operator state over the contended
uplink and stall the service for a warm-up (cost math from
``repro_torch.core.elastic``).

Fire life-cycle::

    new ──deps settled──► queued  (edge)  ──device──► done
                      └─► inflight (dc, task injected) ─► done | failed

A fire's dependencies are every upstream fire with an earlier timestamp;
cross-site results and record hauls route through the fleet (FIFO-
contended shared uplink). Record conservation is tracked per service
*and* per site with exact set partitions.

Everything here is host code (stdlib and numpy) and is carried with the
JAX package's arithmetic in its order, so a run's VoS, energy and ledger
equal the reference's float for float. The fluid lowering
(``fluid_engine``) is the one tensor path; it runs on the CUDA card
unless its caller asks for the CPU.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch import hardware as hw
from repro_torch.chaos.inject import ChaosTimeline, FaultObservation
from repro_torch.chaos.migrate import plan_chaos_migrations
from repro_torch.chaos.spec import ChaosSpec
from repro_torch.core.costmodel import CellCost, CostModel
from repro_torch.core.elastic import (SERVICE_WARMUP_S, ServiceMigration,
                                plan_replacement)
from repro_torch.core.heuristics import HEURISTICS, VPTRHeuristic
from repro_torch.core.simulator import SimResult, Simulator
from repro_torch.core.tasks import Task, TaskType
from repro_torch.core.value import task_value
from repro_torch.core.vdc import PodGrid
from repro_torch.online.fleet import Fleet, FleetSpec, SiteSpec
from repro_torch.pipeline.composition import Pipeline
from repro_torch.placement.edge import EdgeSpec
from repro_torch.placement.network import LinkSpec
from repro_torch.placement.plan import SITE_DC, SITE_EDGE, PlacementPlan
from repro_torch.scenario.ledger import (RecordLedger, ServiceLedger, _QueueTap,
                                   _ServiceTap, _topo_order, tap_and_drive)
from repro_torch.scenario.observe import (BridgeInfo, EpochObservation, ServiceInfo,
                                    attach_forecast, epoch_bounds, epoch_of,
                                    merge_realized_vos)
from repro_torch.scenario.profiles import ServiceProfile

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class EngineConfig:
    """Engine knobs. ``epoch_s=None`` runs the whole horizon as one
    epoch (the static single-plan co-sim); setting it enables epoch-based
    re-placement. The default matches the historical ``OnlineConfig``
    (600 s epochs) so legacy fleet callers keep re-placing; spec-compiled
    engines always pass ``epoch_s`` explicitly."""
    fleet: FleetSpec
    horizon_s: float = 3600.0
    epoch_s: Optional[float] = 600.0
    drive_step_s: Optional[float] = None   # None -> min service slide
    heuristic: str = "hinted"
    power_cap_w: Optional[float] = None
    records_per_step: int = 5_000
    dc_step_floor_s: float = 1e-3
    mxu_efficiency: float = 0.5
    grid_shape: Tuple[int, int] = (hw.POD_X, hw.POD_Y)
    migration_warmup_s: float = SERVICE_WARMUP_S
    # Wire footprint of migrated operator state per buffered record. The
    # operator ships compacted window state (partial aggregates + record
    # index), not the raw 64 B in-RAM records.
    state_bytes_per_record: float = 16.0
    # Unplanned-fault injection (None = no chaos; every chaos code path
    # is dormant and the engine is bit-identical to the pre-chaos one).
    chaos: Optional[ChaosSpec] = None


def single_site_fleet(edge: Optional[EdgeSpec] = None,
                      link: Optional[LinkSpec] = None,
                      site: str = SITE_EDGE) -> FleetSpec:
    """The classic paper deployment: one gateway next to the farm."""
    return FleetSpec(sites=(SiteSpec(site, edge or EdgeSpec(),
                                     link or LinkSpec()),))


# ---------------------------------------------------------------------------
# DC-side glue: analytics cost cells + hint-honouring heuristic
# ---------------------------------------------------------------------------
def analytics_cost_model(profiles: Dict[str, ServiceProfile],
                         cfg) -> CostModel:
    """One roofline cell per service: a DC task step processes
    ``records_per_step`` window values of that service's operator. The
    collective term models the VDC composition / kernel-launch floor, so
    tiny windows don't pretend to finish in nanoseconds."""
    cells = {}
    ref = 256
    for name, prof in profiles.items():
        r = cfg.records_per_step
        t_c = (r * prof.flops_per_record
               / (ref * hw.PEAK_FLOPS_BF16 * cfg.mxu_efficiency))
        t_m = r * prof.bytes_per_record / (ref * hw.HBM_BW)
        cells[(f"svc:{name}", "window")] = CellCost(
            t_c, t_m, cfg.dc_step_floor_s, r * prof.bytes_per_record)
    return CostModel(cells)


class HintedVPTR(VPTRHeuristic):
    """VPTR that honours the placement plan's per-task DVFS hint."""
    name = "VPTR-hint"
    can_scale_f = True

    def _freqs(self, task, headroom_fn):
        return (getattr(task, "dvfs_hint", 1.0),)


def _fresh_heuristic(name: str):
    if name == "hinted":
        return HintedVPTR()
    return type(HEURISTICS[name])()


# ---------------------------------------------------------------------------
# Per-service facts the controllers plan with: ServiceInfo, BridgeInfo and
# EpochObservation live in repro_torch.scenario.observe (the shared protocol
# between this engine and the live serving runtime) and are re-exported
# above.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _OFire:
    svc: str
    idx: int
    ts: float
    epoch: int
    n_window: int
    n_new: int
    origins: Dict[Optional[str], int]
    site: str = ""
    state: str = "new"            # new|queued|inflight|done|failed
    start: float = 0.0
    ready_out: Optional[float] = None
    energy_j: float = 0.0
    value: float = 0.0
    dropped: bool = False
    pending: bool = False
    lat_s: Optional[float] = None   # settled realized latency (NaN: no sample)
    arrival_at: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def terminal(self) -> bool:
        return self.state in ("done", "failed")


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------
def _num(x):
    return None if math.isnan(x) or math.isinf(x) else round(x, 4)


@dataclasses.dataclass
class EngineResult:
    """Full co-simulation outcome of one plan schedule."""
    label: str
    vos: float
    vos_normalized: float
    fires_total: int
    fires_completed: int
    fires_dropped: int
    fires_inflight: int
    latency_p50: float
    latency_p95: float
    latency_p99: float
    edge_energy_j: float
    network_energy_j: float
    dc_energy_j: float
    bytes_up: float
    bytes_down: float
    uplink_wait_s: float
    uplink_transfers: int
    migrations: int
    ledger: RecordLedger
    per_site: Dict[str, Dict]
    per_service: Dict[str, Dict]
    epochs: List[Dict]
    dc: Optional[SimResult] = None

    @property
    def energy_total_j(self) -> float:
        return self.edge_energy_j + self.network_energy_j + self.dc_energy_j

    def summary(self) -> Dict:
        return {
            "label": self.label,
            "vos": round(self.vos, 4),
            "vos_normalized": round(self.vos_normalized, 4),
            "fires": {"total": self.fires_total,
                      "completed": self.fires_completed,
                      "dropped": self.fires_dropped,
                      "inflight": self.fires_inflight},
            "latency_s": {"p50": _num(self.latency_p50),
                          "p95": _num(self.latency_p95),
                          "p99": _num(self.latency_p99)},
            "energy_j": {"edge": round(self.edge_energy_j, 2),
                         "network": round(self.network_energy_j, 2),
                         "dc": round(self.dc_energy_j, 2)},
            "bytes": {"up": int(self.bytes_up), "down": int(self.bytes_down)},
            "uplink": {"fifo_wait_s": round(self.uplink_wait_s, 3),
                       "transfers": self.uplink_transfers},
            "migrations": self.migrations,
            "records": self.ledger.totals(),
            "per_site": self.per_site,
            "epochs": self.epochs,
        }


@dataclasses.dataclass
class CoSimResult:
    """Single-plan result (the historical ``placement.cosim`` surface:
    what the placement search scores)."""
    plan_label: str
    feasible: bool
    vos: float
    vos_normalized: float
    fires_total: int
    fires_completed: int
    fires_dropped: int       # DC scheduler drops (value decayed to zero)
    fires_inflight: int      # DC tasks the horizon truncated mid-queue
    latency_p50: float
    latency_p95: float
    latency_p99: float
    edge_energy_j: float
    network_energy_j: float
    dc_energy_j: float
    bytes_up: float
    bytes_down: float
    ledger: RecordLedger = dataclasses.field(default_factory=RecordLedger)
    dc: Optional[SimResult] = None
    per_service: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    infeasible_reason: str = ""

    @property
    def energy_total_j(self) -> float:
        return self.edge_energy_j + self.network_energy_j + self.dc_energy_j

    def summary(self) -> Dict:
        """JSON-safe digest for benchmark output (strict RFC 8259: NaN
        percentiles of infeasible/fire-less runs become null)."""
        return {
            "plan": self.plan_label,
            "feasible": self.feasible,
            "vos": None if not self.feasible else round(self.vos, 4),
            "vos_normalized": None if not self.feasible
            else round(self.vos_normalized, 4),
            "fires": {"total": self.fires_total,
                      "completed": self.fires_completed,
                      "dropped": self.fires_dropped,
                      "inflight": self.fires_inflight},
            "latency_s": {"p50": _num(self.latency_p50),
                          "p95": _num(self.latency_p95),
                          "p99": _num(self.latency_p99)},
            "energy_j": {"edge": round(self.edge_energy_j, 2),
                         "network": round(self.network_energy_j, 2),
                         "dc": round(self.dc_energy_j, 2)},
            "bytes": {"up": int(self.bytes_up), "down": int(self.bytes_down)},
            "records": self.ledger.totals(),
            "infeasible_reason": self.infeasible_reason,
        }


# fields a single-plan CoSimResult copies verbatim from the EngineResult
# (derived, so a metric added to both dataclasses flows automatically)
_SHARED_FIELDS = tuple(
    {f.name for f in dataclasses.fields(CoSimResult)}
    & {f.name for f in dataclasses.fields(EngineResult)})


def _infeasible(plan: PlacementPlan, reason: str) -> CoSimResult:
    return CoSimResult(plan_label=plan.label, feasible=False,
                       vos=float("-inf"), vos_normalized=float("-inf"),
                       fires_total=0, fires_completed=0, fires_dropped=0,
                       fires_inflight=0,
                       latency_p50=float("nan"), latency_p95=float("nan"),
                       latency_p99=float("nan"), edge_energy_j=0.0,
                       network_energy_j=0.0, dc_energy_j=0.0,
                       bytes_up=0.0, bytes_down=0.0,
                       infeasible_reason=reason)


class _FixedPlan:
    """Trivial controller: one plan for every epoch, no migrations."""
    charge_migrations = True

    def __init__(self, plan: PlacementPlan, label: str = ""):
        self.plan = plan
        self.label = label or plan.label

    def decide(self, obs: EpochObservation) -> PlacementPlan:
        return self.plan


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
class ScenarioEngine:
    """Co-simulates one scenario's pipeline across its site topology
    under a controller-produced plan schedule. ``build`` must return a
    fresh Pipeline (with its farms) on every call; the functional drive
    is cached so several controllers / plans replay identical record
    streams. Usually constructed via ``ScenarioSpec.compile()``."""

    def __init__(self, build: Callable[[], Pipeline],
                 profiles: Dict[str, ServiceProfile],
                 cfg: EngineConfig,
                 outages: Optional[Mapping[str, Sequence[Tuple[float, float]]]]
                 = None):
        self.build = build
        self.profiles = dict(profiles)
        self.cfg = cfg
        self.outages = {k: tuple(v) for k, v in (outages or {}).items()}
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
        # epoch boundaries (last epoch absorbs any sub-epoch remainder)
        self.epoch_s = cfg.epoch_s or cfg.horizon_s
        self.epochs = epoch_bounds(cfg.horizon_s, cfg.epoch_s)
        self._fresh_pipe: Optional[Pipeline] = pipe
        self._driven = None
        self._true_rates: Optional[List[Dict[str, float]]] = None
        self._ledger_static: Optional[Dict[str, Dict]] = None
        self._screen = None
        self._fluid: Dict = {}

    @property
    def all_sites(self) -> Tuple[str, ...]:
        return tuple(self.cfg.fleet.site_names) + (SITE_DC,)

    # --------------------------------------------------------------- driving
    def _ensure_driven(self):
        if self._driven is None:
            pipe, self._fresh_pipe = self._fresh_pipe or self.build(), None
            staps, by_service = tap_and_drive(pipe, self.cfg.horizon_s,
                                              self.cfg.drive_step_s)
            self._driven = (pipe, staps, by_service)
        return self._driven

    def _epoch_of(self, ts: float) -> int:
        return epoch_of(self.epochs, ts)

    def true_epoch_rates(self) -> List[Dict[str, float]]:
        """Ground-truth newly-covered-records/s per service per epoch
        (drive-derived; what the oracle plans with). Plan-independent,
        so computed once — a search calls run_plan per candidate."""
        if self._true_rates is None:
            _, staps, _ = self._ensure_driven()
            out = [{s: 0.0 for s in self.order} for _ in self.epochs]
            for svc, tap in staps.items():
                for fr in tap.fires:
                    k = self._epoch_of(fr.ts)
                    out[k][svc] += fr.n_new
            for k, (t0, t1) in enumerate(self.epochs):
                for svc in out[k]:
                    out[k][svc] /= max(t1 - t0, _EPS)
            self._true_rates = out
        return [dict(r) for r in self._true_rates]

    def screening_model(self):
        """Cached tier-1 vectorized plan screener over this engine's
        (placement-independent) fire trace — see
        :class:`repro_torch.scenario.screen.ScreeningModel`. The screened
        search (``repro_torch.placement.search.screened_search``) uses it
        to score whole candidate batches in one numpy pass and reserves
        the exact DES replay for the top-K survivors."""
        if self._screen is None:
            from repro_torch.scenario.screen import ScreeningModel
            self._screen = ScreeningModel(self)
        return self._screen

    def fluid_engine(self, dt_s=None, device=None):
        """Cached fluid lowering of this engine, one per ``(dt_s,
        device)`` — see :class:`repro_torch.fluid.engine.FluidEngine`;
        ``device=None`` is the CUDA card. Drift ensembles
        (:class:`repro_torch.fluid.ensemble.ScenarioEnsemble`) built on
        this engine route through here, so an epoch loop that re-ranks
        finalists every epoch reuses the lowered trace arrays and the
        captured CUDA graphs instead of re-lowering per ensemble."""
        from repro_torch.device import resolve_device
        key = (dt_s, resolve_device(device))
        fl = self._fluid.get(key)
        if fl is None:
            from repro_torch.fluid.engine import FluidEngine
            fl = self._fluid[key] = FluidEngine.compile(
                self, dt_s=dt_s, device=key[1])
        return fl

    def info(self) -> BridgeInfo:
        return BridgeInfo(topology=self.topology, profiles=self.profiles,
                          fleet=self.cfg.fleet, services=self.services_info,
                          cost=self.cost,
                          grid_chips=(self.cfg.grid_shape[0]
                                      * self.cfg.grid_shape[1]),
                          epoch_s=self.epoch_s,
                          records_per_step=self.cfg.records_per_step,
                          outages=self.outages)

    # ------------------------------------------------------------- plumbing
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
        info = self.services_info[svc]
        return info.buffer_budget * self.cfg.state_bytes_per_record

    def _plan_at(self, ts: float) -> PlacementPlan:
        """Plan governing a fire with timestamp ``ts``. Plans are keyed
        by *adoption time* (epoch boundaries, plus mid-epoch chaos
        re-plans), so with one plan per epoch this is exactly the old
        ``self._plans[fire.epoch]`` lookup."""
        i = bisect.bisect_right(self._plan_times, ts) - 1
        return self._plans[i if i >= 0 else 0]

    def _origin_site(self, f: _OFire, origin: Optional[str]) -> str:
        if origin is None:
            return self.cfg.fleet.farm_site(self.services_info[f.svc].queue)
        return self._plan_at(f.ts).site(origin)

    def _avail(self, svc: str, ts: float) -> float:
        t = 0.0
        for t_mig, ready in self._stalls.get(svc, ()):
            if t_mig <= ts:
                t = max(t, ready)
        return t

    # ----------------------------------------------------------- resolution
    def _deps_settled(self, f: _OFire) -> bool:
        for u in self.topology[f.svc]:
            k = bisect.bisect_left(self._ts[u], f.ts)
            arr = self._fires[u]
            p = self._term[u]
            while p < len(arr) and arr[p].terminal:
                p += 1
            self._term[u] = p
            if p < k:
                return False
        return True

    def _result_arrival(self, g: _OFire, dst: str) -> float:
        src = g.site
        if src == dst or dst == SITE_DC:
            # same site, or the result ships with the DC consumer's
            # record uplink (edge upstream) / never left the DC
            return g.ready_out
        if src == SITE_DC:
            return g.ready_out + self._fleet.downlink_time(dst)
        if dst not in g.arrival_at:
            g.arrival_at[dst] = self._fleet.ship_result(src, dst, g.ready_out)
        return g.arrival_at[dst]

    def _dep_time(self, f: _OFire, dst: str) -> float:
        """Latest arrival (at ``dst``) of any settled upstream result.
        Incremental per (consumer, upstream, dst): the settled prefix of
        an upstream only grows as the consumer's fires advance in ts
        order, so each upstream fire is visited once per destination
        instead of rescanned per dispatch. ``_result_arrival`` caching
        keeps the FIFO-uplink side effects identical to a full rescan."""
        t = f.ts
        for u in self.topology[f.svc]:
            k = bisect.bisect_left(self._ts[u], f.ts)
            key = (f.svc, u, dst)
            ptr, mx = self._dep_ptr.get(key, (0, float("-inf")))
            arr = self._fires[u]
            while ptr < k:
                g = arr[ptr]
                if g.state == "done" and g.ready_out is not None:
                    a = self._result_arrival(g, dst)
                    if a > mx:
                        mx = a
                ptr += 1
            self._dep_ptr[key] = (ptr, mx)
            if mx > t:
                t = mx
        return t

    def _ship_inputs(self, f: _OFire, base: float) -> float:
        """Haul this fire's newly covered records that live on a
        different site than the fire executes on; DC-origin results
        arrive via the result hop instead (no re-ship)."""
        groups: Dict[str, int] = {}
        for o, c in f.origins.items():
            so = self._origin_site(f, o)
            if so == f.site or so == SITE_DC or c == 0:
                continue
            groups[so] = groups.get(so, 0) + c
        t = base
        for so in sorted(groups):
            t = max(t, self._fleet.ship_records(so, f.site, groups[so], base))
        return t

    def _make_task(self, f: _OFire, arrival: float) -> Task:
        p = self._plan_at(f.ts).placement(f.svc)
        prof = self.profiles[f.svc]
        shift = ((arrival - f.ts)
                 + self._fleet.downlink_time(self.cfg.fleet.result_site))
        steps = max(1, math.ceil(f.n_window / self.cfg.records_per_step))
        tt = TaskType(f"svc:{f.svc}", "window", allowable_chips=(p.chips,))
        task = Task(tid=self._next_tid, ttype=tt, steps=steps,
                    arrival=arrival, value=prof.slo.value_spec(shift),
                    hbm_bytes=self.cost.hbm_bytes(f"svc:{f.svc}", "window"))
        task.dvfs_hint = p.dvfs_f
        self._next_tid += 1
        return task

    def _dispatch(self, limit_ts: float) -> bool:
        """Dispatch every currently-dispatchable fire in global
        (ts, topo-rank) order — one at a time, so shared-uplink FIFO
        admissions happen in causal time order rather than per-service
        sweep order (a service must not reserve the pipe for a *future*
        haul ahead of another service's earlier transfer)."""
        progressed = False
        while True:
            best: Optional[_OFire] = None
            for svc in self.order:
                i = self._disp[svc]
                arr = self._fires[svc]
                if i >= len(arr):
                    continue
                f = arr[i]
                if f.ts >= limit_ts or f.epoch >= self._epochs_planned:
                    continue
                if not self._deps_settled(f):
                    continue
                if best is None or (f.ts, self.rank[f.svc]) < (best.ts,
                                                               self.rank[best.svc]):
                    best = f
            if best is None:
                return progressed
            f = best
            svc, i = f.svc, f.idx
            f.site = self._plan_at(f.ts).site(svc)
            base = max(self._dep_time(f, f.site), self._avail(svc, f.ts))
            in_ready = self._ship_inputs(f, base)
            if f.site == SITE_DC:
                task = self._make_task(f, in_ready)
                self._sim.inject(task)
                f.state = "inflight"
                self._waiting[(svc, i)] = task
                self._task_by_key[(svc, i)] = task
            else:
                f.start = in_ready
                f.state = "queued"
                heapq.heappush(self._equeue,
                               (in_ready, f.ts, self.rank[svc],
                                f.site, svc, i))
            self._disp[svc] = i + 1
            progressed = True

    def _next_fire_ts(self, limit_ts: float) -> Optional[float]:
        """Timestamp of the earliest not-yet-dispatched fire below
        ``limit_ts`` (dispatchable or not — its ts is still a time the
        cursor must visit)."""
        out: Optional[float] = None
        for svc in self.order:
            i = self._disp[svc]
            if i >= len(self._fires[svc]):
                continue
            ts = self._fires[svc][i].ts
            if ts < limit_ts and (out is None or ts < out):
                out = ts
        return out

    def _exec_edge_one(self, max_ready: float = float("inf")) -> bool:
        """Execute the queued edge fire with the smallest readiness, but
        only once the time cursor has reached it — executing a far-future
        fire early would occupy the serial device out of order."""
        if not self._equeue or self._equeue[0][0] > max_ready:
            return False
        in_ready, _, _, site, svc, i = heapq.heappop(self._equeue)
        f = self._fires[svc][i]
        prof = self.profiles[svc]
        ex = self._fleet.site(site).execute_fire(in_ready, f.n_window,
                                                 prof.flops_per_record)
        f.start, f.ready_out, f.energy_j = ex.start, ex.finish, ex.energy_j
        f.state = "done"
        return True

    def _collect_dc(self) -> bool:
        progressed = False
        for (svc, i), task in list(self._waiting.items()):
            f = self._fires[svc][i]
            if task.dropped:
                f.state, f.dropped = "failed", True
            elif (task.finish is not None
                  and task.finish <= self._sim.now + _EPS):
                f.state = "done"
                f.ready_out = task.finish
                # the completed aggregate surfaces at the user's site
                self._fleet.site(self.cfg.fleet.result_site).net.downlink(1)
            else:
                continue
            del self._waiting[(svc, i)]
            progressed = True
        return progressed

    def _starve_waiting(self) -> bool:
        """Event heap is empty and tasks are still pending: nothing will
        ever schedule them (no event retriggers the heuristic). Withdraw
        and classify exactly like a drained one-shot trace's tail."""
        if not self._waiting:
            return False
        now = self._sim.now
        progressed = False
        for (svc, i), task in list(self._waiting.items()):
            if not self._sim.withdraw(task):
                continue    # actually scheduled: its completion event
                # is still in flight, let the advance loop collect it
            progressed = True
            f = self._fires[svc][i]
            chips = task.ttype.allowable_chips[0]
            fh = getattr(task, "dvfs_hint", 1.0)
            dur = task.steps * self.cost.time_per_step(
                task.ttype.arch, task.ttype.shape, chips, fh)
            energy = task.steps * self.cost.energy_per_step(
                task.ttype.arch, task.ttype.shape, chips, fh)
            v = task_value(task.value, (now - task.arrival) + dur, energy)
            f.state = "failed"
            f.pending = v > 0          # horizon starvation, not decay
            f.dropped = not f.pending
            del self._waiting[(svc, i)]
        return progressed

    def _advance(self, t_from: float, t_to: float) -> None:
        """Co-advance the fire graph, the edge devices and the DES from
        ``t_from`` to ``t_to`` behind one global time cursor: fires
        dispatch when the cursor reaches their timestamp, queued edge
        fires execute when it reaches their readiness, DC completions
        collect as the event heap catches up. The cursor keeps shared-
        uplink FIFO admissions in causal time order — no transfer may
        reserve the pipe for a haul the simulation hasn't reached."""
        cursor = t_from
        while True:
            p = self._dispatch(limit_ts=cursor + _EPS)
            if self._exec_edge_one(max_ready=cursor + _EPS):
                p = True
            if self._collect_dc():
                p = True
            if p:
                continue
            ne = self._sim.next_event_time()
            if ne is not None and ne <= self._sim.now + _EPS:
                # late injections land at the current instant — process
                # them before deciding the clock is stuck
                self._sim.run_until(self._sim.now)
                continue
            nxt: List[float] = []
            nf = self._next_fire_ts(t_to)
            if nf is not None:
                nxt.append(nf)
            if self._equeue:
                nxt.append(self._equeue[0][0])
            if ne is not None:
                nxt.append(ne)
            # only strictly-future times can advance the cursor (a fire
            # at the cursor that didn't dispatch is blocked on something
            # later; its timestamp must not pin the loop)
            nxt = [t for t in nxt if cursor + _EPS < t <= t_to]
            if not nxt:
                return
            cursor = min(nxt)
            self._sim.run_until(cursor)

    # ------------------------------------------------------------ chaos path
    def _advance_epoch(self, controller, k: int, t0: float, t1: float,
                       charge: bool, rates_k: Dict[str, float]) -> List[Dict]:
        """Advance one epoch, cutting at realized fault boundaries so a
        chaos-aware controller (one exposing ``decide_fault``) can
        re-plan mid-epoch. The controller sees only the realized world at
        the cut (a :class:`FaultObservation`), never the fault schedule.
        Chaos-free runs — and controllers without ``decide_fault`` —
        take the single-segment path, bit-identical to the old loop."""
        react = (self._timeline is not None
                 and getattr(controller, "decide_fault", None) is not None)
        cuts = self._timeline.boundaries(t0, t1) if react else []
        log: List[Dict] = []
        cur = t0
        names = self.cfg.fleet.site_names
        for T in cuts:
            self._advance(cur, T)
            self._sim.run_until(T)
            self._collect_dc()
            cur = T
            fobs = FaultObservation(
                t=T, epoch=k,
                down_now={s: self._fleet.site(s).failed_at(T)
                          for s in names},
                partitioned_now={s: self._fleet.site(s).partitioned_at(T)
                                 for s in names},
                straggle_now={s: self._fleet.site(s).straggle_factor(T)
                              for s in names},
                events=self._timeline.events_at(T))
            plan = controller.decide_fault(fobs)
            if plan is not None:
                log.append(self._adopt_replan(plan, T, k, fobs, charge,
                                              rates_k))
        self._advance(cur, t1)
        return log

    def _adopt_replan(self, plan: PlacementPlan, T: float, k: int,
                      fobs: FaultObservation, charge: bool,
                      rates_k: Dict[str, float]) -> Dict:
        """Adopt an emergency mid-epoch plan at time ``T``: charge the
        checkpoint-aware live/cold migrations (never the raw-state
        epoch-boundary cost model) and key the plan by adoption time so
        only fires with ``ts >= T`` execute under it."""
        plan.validate(self.topology,
                      grid_chips=self.cfg.grid_shape[0]
                      * self.cfg.grid_shape[1],
                      sites=self.all_sites)
        bad = self._site_ram_ok(plan)
        if bad is not None:
            raise ValueError(f"epoch {k}: infeasible fault re-plan: {bad}")
        old = self._plans[-1]
        chaos = self.cfg.chaos
        ck = max(1, chaos.checkpoint_every)

        def _replay_records(svc: str) -> int:
            # fires the source covered since its newest checkpoint
            # (cadence: one save every `ck` fires)
            i_t = bisect.bisect_right(self._ts[svc], T)
            return sum(f.n_new
                       for f in self._fires[svc][(i_t // ck) * ck:i_t])

        def _replay_time(svc: str, n: int, dst: str) -> float:
            if dst == SITE_DC:
                p = plan.placement(svc)
                steps = max(1, math.ceil(n / self.cfg.records_per_step))
                return steps * self.cost.time_per_step(
                    f"svc:{svc}", "window", p.chips, p.dvfs_f)
            return self._fleet.site(dst).node.fire_time(
                n, self.profiles[svc].flops_per_record)

        def _drain(svc: str) -> float:
            src = old.site(svc)
            if src == SITE_DC:
                return 0.0
            return max(0.0, self._fleet.site(src).node.busy_until - T)

        def _src_dead(s: str) -> bool:
            if s == SITE_DC:
                return False
            site = self._fleet.site(s)
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
            src_dead=_src_dead, ship=self._fleet.ship_state,
            state_bytes=self._state_bytes, ckpt_bytes=_ckpt_bytes,
            replay_records=_replay_records, replay_time=_replay_time,
            rate_rps=lambda svc: rates_k.get(svc, 0.0),
            drain_s=_drain, dc_site=SITE_DC, local_origin=_local_origin,
            warmup_s=self.cfg.migration_warmup_s, charge=charge)
        for m in migs:
            if charge:
                self._stalls.setdefault(m.service, []).append(
                    (T, T + m.stall_s))
            if m.duplicates:
                self._duplicates[m.service] = (
                    self._duplicates.get(m.service, 0) + m.duplicates)
        self._plans.append(plan)
        self._plan_times.append(T)
        return {"t": round(T, 6), "plan": plan.label,
                "trigger": list(fobs.events),
                "migrations": [m.digest() for m in migs]}

    def _snap_link_secs(self) -> None:
        """Close the epoch's uplink telemetry window: mean serialization
        seconds per transfer at each site since the previous boundary
        (a straggling link surfaces here, and only here)."""
        out: Dict[str, float] = {}
        for s in self.cfg.fleet.site_names:
            site = self._fleet.site(s)
            b0, n0 = self._link_snap[s]
            db, dn = site.link_busy_s - b0, site.link_transfers - n0
            self._link_snap[s] = (site.link_busy_s, site.link_transfers)
            out[s] = db / dn if dn > 0 else 0.0
        self._link_secs.append(out)

    # ------------------------------------------------------- realized value
    def _settle_value(self, svc: str, f: _OFire) -> None:
        """Realized value + end-to-end latency of a terminal fire,
        computed once and cached on the fire (the per-epoch realized
        feedback and the final ``_score`` share the same numbers)."""
        if f.lat_s is not None or not f.terminal:
            return
        if f.state == "done" and f.site != SITE_DC:
            f.lat_s = f.ready_out - f.ts
            f.value = task_value(self._vspec[svc], f.lat_s, f.energy_j)
        elif f.state == "done":
            f.value = self._task_by_key[(svc, f.idx)].earned
            f.lat_s = f.ready_out + self._dl_user - f.ts
        else:
            f.lat_s = float("nan")      # dropped/starved: no latency sample

    def _epoch_residuals(self, epoch: int) -> Dict[str, Dict]:
        """Per-service realized residuals of one epoch as of the
        current simulation time: the VoS earned, the terminal fire
        counts (the per-service ledger residuals) and the mean realized
        latency. Fires still in flight count as ``inflight`` with no
        value realized."""
        out = {s: {"vos": 0.0, "completed": 0, "dropped": 0,
                   "inflight": 0, "lat_mean_s": float("nan"),
                   "_lat_sum": 0.0}
               for s in self.order}
        for svc, f in self._fires_by_epoch.get(epoch, ()):
            d = out[svc]
            self._settle_value(svc, f)
            if f.state == "done":
                d["completed"] += 1
                d["vos"] += f.value
                d["_lat_sum"] += f.lat_s
            elif f.dropped:
                d["dropped"] += 1
            else:
                d["inflight"] += 1
        for d in out.values():
            if d["completed"]:
                d["lat_mean_s"] = d["_lat_sum"] / d["completed"]
            del d["_lat_sum"]
            d["vos"] = round(d["vos"], 6)
        return out

    def _realized_upto(self, upto_epoch: int) -> List[Dict[str, Dict]]:
        """Frozen residual snapshots for every epoch < ``upto``. Each
        epoch is materialized exactly once, at the first boundary after
        it completes, and never rescanned: fires that straddle that
        boundary stay counted ``inflight`` in the snapshot (the
        calibration loop reads each epoch exactly once anyway, and
        freezing keeps the per-run cost at one pass over the fires
        instead of one pass per boundary)."""
        while len(self._realized) < upto_epoch:
            self._realized.append(self._epoch_residuals(len(self._realized)))
        return [{s: dict(d) for s, d in per.items()}
                for per in self._realized[:upto_epoch]]

    # ------------------------------------------------------------------ run
    def run(self, controller) -> EngineResult:
        """Co-simulate one plan schedule: ``controller.decide`` is asked
        for a plan at every epoch boundary (single-plan runs come in via
        :meth:`run_plan`). Raises ValueError on an infeasible plan."""
        pipe, staps, qtaps = self._ensure_driven()
        cfg = self.cfg
        self._timeline = (ChaosTimeline.compile(
            cfg.chaos, cfg.fleet.site_names, cfg.horizon_s, self.epochs)
            if cfg.chaos is not None else None)
        self._fleet = Fleet(cfg.fleet, self.outages, chaos=self._timeline)
        self._dl_user = self._fleet.downlink_time(cfg.fleet.result_site)
        self._vspec = {s: self.profiles[s].slo.value_spec()
                       for s in self.order}
        self._sim = Simulator(_fresh_heuristic(cfg.heuristic), self.cost,
                              power_cap_w=cfg.power_cap_w,
                              grid=PodGrid(*cfg.grid_shape))
        self._sim.begin()
        self._fires = {
            svc: [_OFire(svc=svc, idx=i, ts=fr.ts,
                         epoch=self._epoch_of(fr.ts), n_window=fr.n_window,
                         n_new=fr.n_new, origins=fr.origins)
                  for i, fr in enumerate(staps[svc].fires)]
            for svc in self.order}
        self._ts = {s: [f.ts for f in fl] for s, fl in self._fires.items()}
        self._fires_by_epoch: Dict[int, List[Tuple[str, _OFire]]] = {}
        for svc, fl in self._fires.items():
            for f in fl:
                self._fires_by_epoch.setdefault(f.epoch, []).append((svc, f))
        self._realized: List[Dict[str, Dict]] = []
        self._term = {s: 0 for s in self.order}
        self._disp = {s: 0 for s in self.order}
        self._equeue: List[Tuple] = []
        self._waiting: Dict[Tuple[str, int], Task] = {}
        self._task_by_key: Dict[Tuple[str, int], Task] = {}
        self._dep_ptr: Dict[Tuple[str, str, str], Tuple[int, float]] = {}
        self._stalls: Dict[str, List[Tuple[float, float]]] = {}
        self._plans: List[PlacementPlan] = []
        self._plan_times: List[float] = []      # adoption time of each plan
        self._epochs_planned = 0                # epoch-boundary decisions only
        self._duplicates: Dict[str, int] = {}   # at-least-once double passes
        self._link_secs: List[Dict[str, float]] = []
        self._link_snap = {s: (0.0, 0) for s in cfg.fleet.site_names}
        self._next_tid = 0
        true_rates = self.true_epoch_rates()
        charge = getattr(controller, "charge_migrations", True)
        bind = getattr(controller, "bind", None)
        if bind is not None:
            bind(self.info())

        epoch_meta: List[Dict] = []
        n_migs = 0
        rates_window: List[Dict[str, float]] = []
        for k, (t0, t1) in enumerate(self.epochs):
            obs = EpochObservation(
                epoch=k, t0=t0, t1=t1,
                rates_window=list(rates_window),
                realized_window=self._realized_upto(k),
                down_now={s: self._fleet.site(s).failed_at(t0)
                          for s in cfg.fleet.site_names},
                rates_oracle=dict(true_rates[k]),
                down_oracle={s: any(d < t1 and u > t0
                                    for d, u in self._fleet.site(s).outages)
                             for s in cfg.fleet.site_names},
                partitioned_now={s: self._fleet.site(s).partitioned_at(t0)
                                 for s in cfg.fleet.site_names},
                link_secs_window=[dict(d) for d in self._link_secs])
            plan = controller.decide(obs)
            plan.validate(self.topology,
                          grid_chips=cfg.grid_shape[0] * cfg.grid_shape[1],
                          sites=self.all_sites)
            bad = self._site_ram_ok(plan)
            if bad is not None:
                raise ValueError(f"epoch {k}: infeasible plan from "
                                 f"{type(controller).__name__}: {bad}")
            migs: List[ServiceMigration] = []
            if self._plans:
                def _xfer(src: str, dst: str, nbytes: float,
                          _t0: float = t0) -> float:
                    if not charge:
                        return 0.0
                    return self._fleet.ship_state(src, dst, nbytes, _t0) - _t0
                migs = plan_replacement(self._plans[-1].assignments,
                                        plan.assignments,
                                        self._state_bytes, _xfer,
                                        warmup_s=cfg.migration_warmup_s)
                if charge:
                    for m in migs:
                        self._stalls.setdefault(m.service, []).append(
                            (t0, t0 + m.stall_s))
            n_migs += len(migs)
            self._plans.append(plan)
            self._plan_times.append(t0)
            self._epochs_planned += 1

            chaos_log = self._advance_epoch(controller, k, t0, t1, charge,
                                            true_rates[k])
            self._sim.run_until(t1)
            self._collect_dc()
            self._snap_link_secs()
            rates_window.append(dict(true_rates[k]))
            meta = {
                "epoch": k, "t0": t0, "t1": t1, "plan": plan.label,
                "migrations": [
                    {"service": m.service, "src": m.src, "dst": m.dst,
                     "stall_s": round(m.stall_s, 3)} for m in migs],
            }
            if chaos_log:
                meta["chaos"] = chaos_log
                n_migs += sum(len(e["migrations"]) for e in chaos_log)
            # regret telemetry: controllers that score plans against a
            # forecast expose it per epoch; the realized per-epoch VoS
            # is merged in by _score once fires settle
            attach_forecast(controller, k, meta)
            epoch_meta.append(meta)

        # ---- final sweep: drain cross-epoch stragglers -------------------
        while True:
            self._advance(self.epochs[-1][1], float("inf"))
            if not self._starve_waiting():
                break
        self._sim.drain()
        self._collect_dc()      # safety: completions the loop never saw
        sim_result = self._sim.finalize()

        return self._score(pipe, staps, qtaps, sim_result, epoch_meta,
                           n_migs, controller)

    def run_plan(self, plan: PlacementPlan,
                 label: Optional[str] = None) -> CoSimResult:
        """One fixed plan for the whole horizon. Infeasible plans (site
        RAM) come back as a ``feasible=False`` result rather than
        raising — this is what the placement search scores."""
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

    # -------------------------------------------------------------- scoring
    def _score(self, pipe, staps, qtaps, sim_result: SimResult,
               epoch_meta: List[Dict], n_migs: int,
               controller) -> EngineResult:
        cfg = self.cfg
        vos = max_vos = 0.0
        latencies: List[float] = []
        completed = dropped = inflight = 0
        ep_vos = [0.0] * len(self.epochs)
        per_service: Dict[str, Dict] = {}
        for svc in self.order:
            prof = self.profiles[svc]
            s_lat: List[float] = []
            s_done = s_drop = s_wait = 0
            for f in self._fires[svc]:
                max_vos += prof.slo.max_value
                self._settle_value(svc, f)
                if f.state == "done":
                    s_done += 1
                    s_lat.append(f.lat_s)
                elif f.dropped:
                    s_drop += 1
                else:
                    s_wait += 1
                ep_vos[f.epoch] += f.value
                vos += f.value
            completed += s_done
            dropped += s_drop
            inflight += s_wait
            latencies.extend(s_lat)
            s_vos = sum(f.value for f in self._fires[svc])
            per_service[svc] = {
                "site": self._plans[-1].placement(svc).label
                if self._plans else "",
                "fires": len(self._fires[svc]), "completed": s_done,
                "dropped": s_drop, "inflight": s_wait,
                "vos": round(s_vos, 4),
                "latency_p95": round(float(np.percentile(s_lat, 95)), 4)
                if s_lat else float("nan"),
            }
        merge_realized_vos(epoch_meta, ep_vos)

        ledger, per_site = self._ledger(pipe, staps, qtaps)
        lat = (np.asarray(latencies) if latencies
               else np.asarray([float("nan")]))
        p50, p95, p99 = np.percentile(lat, (50, 95, 99))
        return EngineResult(
            label=getattr(controller, "label", type(controller).__name__),
            vos=vos, vos_normalized=vos / max(max_vos, 1e-6),
            fires_total=sum(len(fl) for fl in self._fires.values()),
            fires_completed=completed, fires_dropped=dropped,
            fires_inflight=inflight,
            latency_p50=float(p50), latency_p95=float(p95),
            latency_p99=float(p99),
            edge_energy_j=self._fleet.edge_energy_j,
            network_energy_j=self._fleet.network_energy_j,
            dc_energy_j=sim_result.total_energy_j,
            bytes_up=self._fleet.bytes_up, bytes_down=self._fleet.bytes_down,
            uplink_wait_s=self._fleet.uplink_wait_s,
            uplink_transfers=self._fleet.uplink_transfers,
            migrations=n_migs, ledger=ledger, per_site=per_site,
            per_service=per_service, epochs=epoch_meta, dc=sim_result)

    def _ledger_skeleton(self) -> Dict[str, Dict]:
        """Plan-independent ledger fields (record identity partitions
        over the engine's one cached drive). Computed once and copied
        per run — a search over many plans used to redo the id()-set
        algebra on every evaluation."""
        if self._ledger_static is not None:
            return self._ledger_static
        pipe, staps, qtaps = self._ensure_driven()
        out: Dict[str, Dict] = {}
        for svc_obj in pipe.services:
            name = svc_obj.cfg.name
            tap, qtap = staps[name], qtaps[name]
            fetched_ids = set(qtap.fetched.get(name, {}))
            covered_ids = set(tap.covered)
            buf_ids = set(map(id, svc_obj.buffer))
            drop_ids = set(map(id, qtap.drop_refs))
            evicted_unc = fetched_ids - buf_ids - covered_ids
            out[name] = {
                "queue": svc_obj.cfg.queue,
                "produced": len(qtap.pub_refs),
                "overflow": len(drop_ids - fetched_ids),
                "unread": len(set(map(id, svc_obj.q.buf)) - fetched_ids),
                "fetched": len(fetched_ids),
                "buffered": len(buf_ids - covered_ids),
                ("evicted_stored" if svc_obj.cfg.store is not None
                 else "evicted_lost"): len(evicted_unc),
            }
        self._ledger_static = out
        return out

    def _ledger(self, pipe: Pipeline, staps, qtaps
                ) -> Tuple[RecordLedger, Dict[str, Dict]]:
        ledger = RecordLedger()
        site_processed: Dict[str, int] = {s: 0
                                          for s in self.cfg.fleet.site_names}
        site_processed[SITE_DC] = 0
        skeleton = self._ledger_skeleton()
        for svc_obj in pipe.services:
            name = svc_obj.cfg.name
            sl = ServiceLedger(service=name, **skeleton[name])
            sl.duplicates = self._duplicates.get(name, 0)
            for f in self._fires[name]:
                if f.state == "done" and f.site != SITE_DC:
                    sl.processed_edge += f.n_new
                    site_processed[f.site] += f.n_new
                elif f.state == "done":
                    sl.processed_dc += f.n_new
                    site_processed[SITE_DC] += f.n_new
                elif f.dropped:
                    sl.dropped_dc += f.n_new
                else:
                    sl.inflight_dc += f.n_new
            ledger.services[name] = sl
        per_site = self._fleet.per_site_energy()
        for s, n in site_processed.items():
            per_site.setdefault(s, {})["records_processed"] = n
        return ledger, per_site
