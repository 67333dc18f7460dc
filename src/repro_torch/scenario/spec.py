"""Declarative scenario specification: one spec → one engine.

A :class:`ScenarioSpec` captures everything a co-simulation needs as
plain data — the pipeline DAG (farms + services + who publishes where),
per-service :class:`~repro_torch.scenario.profiles.ServiceProfile`s, the edge
fleet topology, the drift schedule, outage windows, and the DC engine
knobs. ``compile()`` turns it into the unified
:class:`~repro_torch.scenario.engine.ScenarioEngine`; the JITA-4DS framing
("pipelines are dynamically assembled and re-assembled from composable
building blocks") becomes literal: a scenario is a ~20-line declarative
value, not a ~100-line builder script.

Specs round-trip losslessly through JSON (``to_json``/``from_json``), so
benchmark scenarios can be bundled, diffed and re-targeted. Drift is
declared (:class:`RateSpec`), not closed over — which is what makes the
round-trip possible.

Build one directly, or fluently::

    spec = (scenario("light")
            .horizon(600.0)
            .farm(n_things=8, rate=RateSpec.constant(2.0))
            .service("agg", queue="neubotspeed", column="download_speed",
                     agg="max", width_s=120, slide_s=60)
            .slo(soft_latency_s=2.0, hard_latency_s=10.0)
            .service("smooth", queue="agg_out", column="value",
                     agg="mean", width_s=300, slide_s=60)
            .fed_by("agg")
            .build())
    engine = spec.compile()
    result = engine.run_plan(PlacementPlan.all_edge(spec.service_names()))
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch import hardware as hw
from repro_torch.chaos.spec import ChaosSpec
from repro_torch.online import drift as _drift
from repro_torch.online.fleet import FleetSpec, SiteSpec
from repro_torch.pipeline.composition import Pipeline
from repro_torch.pipeline.operators import WindowSpec
from repro_torch.pipeline.service import ServiceConfig, StreamService
from repro_torch.pipeline.store import TimeSeriesStore
from repro_torch.pipeline.streams import Broker
from repro_torch.placement.edge import EdgeSpec
from repro_torch.placement.network import LinkSpec
from repro_torch.placement.plan import SITE_DC, SITE_EDGE
from repro_torch.region.hier import HierFleetSpec, RegionSpec
from repro_torch.scenario.engine import EngineConfig, ScenarioEngine
from repro_torch.scenario.profiles import ServiceProfile, ServiceSLO


# ---------------------------------------------------------------------------
# Drift, declaratively
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RateSpec:
    """A declarative rate curve (JSON-safe stand-in for the closures in
    :mod:`repro_torch.online.drift`). ``horizon_s`` of the enclosing scenario
    parameterizes kinds that need it (poisson_bursts, and diurnal/
    piecewise knots given as fractions would be overkill — absolute
    seconds are used throughout)."""
    kind: str = "constant"   # constant|diurnal|step_bursts|piecewise_linear|poisson_bursts
    base_hz: float = 1.0
    amplitude: float = 0.5
    period_s: float = 3600.0
    phase_s: float = 0.0
    burst_hz: float = 0.0
    windows: Tuple[Tuple[float, float], ...] = ()
    knots: Tuple[Tuple[float, float], ...] = ()
    mean_gap_s: float = 60.0
    mean_len_s: float = 30.0
    seed: int = 0

    @classmethod
    def constant(cls, rate_hz: float) -> "RateSpec":
        return cls(kind="constant", base_hz=rate_hz)

    @classmethod
    def diurnal(cls, base_hz: float, amplitude: float = 0.5,
                period_s: float = 3600.0, phase_s: float = 0.0) -> "RateSpec":
        return cls(kind="diurnal", base_hz=base_hz, amplitude=amplitude,
                   period_s=period_s, phase_s=phase_s)

    @classmethod
    def bursts(cls, base_hz: float, burst_hz: float,
               windows) -> "RateSpec":
        return cls(kind="step_bursts", base_hz=base_hz, burst_hz=burst_hz,
                   windows=tuple(tuple(w) for w in windows))

    @classmethod
    def piecewise(cls, knots) -> "RateSpec":
        return cls(kind="piecewise_linear",
                   knots=tuple(tuple(k) for k in knots))

    @classmethod
    def poisson(cls, base_hz: float, burst_hz: float, mean_gap_s: float,
                mean_len_s: float, seed: int = 0) -> "RateSpec":
        return cls(kind="poisson_bursts", base_hz=base_hz, burst_hz=burst_hz,
                   mean_gap_s=mean_gap_s, mean_len_s=mean_len_s, seed=seed)

    def curve(self, horizon_s: float) -> _drift.RateCurve:
        if self.kind == "constant":
            return _drift.constant(self.base_hz)
        if self.kind == "diurnal":
            return _drift.diurnal(self.base_hz, amplitude=self.amplitude,
                                  period_s=self.period_s,
                                  phase_s=self.phase_s)
        if self.kind == "step_bursts":
            return _drift.step_bursts(self.base_hz, self.burst_hz,
                                      list(self.windows))
        if self.kind == "piecewise_linear":
            return _drift.piecewise_linear(list(self.knots))
        if self.kind == "poisson_bursts":
            return _drift.poisson_bursts(self.base_hz, self.burst_hz,
                                         horizon_s,
                                         mean_gap_s=self.mean_gap_s,
                                         mean_len_s=self.mean_len_s,
                                         seed=self.seed)
        raise ValueError(f"unknown rate kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FarmSpec:
    """One IoT producer farm on one queue."""
    queue: str = "neubotspeed"
    n_things: int = 8
    seed: int = 0
    rate: RateSpec = dataclasses.field(
        default_factory=lambda: RateSpec.constant(1.0))


@dataclasses.dataclass(frozen=True)
class StoreSpec:
    """Post-mortem history store attached to a service."""
    chunk_seconds: float = 3600.0
    edge_budget_chunks: int = 48


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    """One stream service: window shape, operator profile, SLO, and the
    optional queue its results republish into (the DAG edges).
    ``flops_per_record=None`` means "calibrate me" — ``compile()`` will
    refuse unless given a calibrator (see ``repro_torch.scenario.calibrate``)."""
    name: str
    queue: str
    column: str = "value"
    agg: str = "mean"
    window_kind: str = "sliding"     # sliding | landmark
    width_s: float = 120.0
    slide_s: float = 60.0
    buffer_budget: int = 4096
    publishes_to: Optional[str] = None
    store: Optional[StoreSpec] = None
    slo: ServiceSLO = dataclasses.field(default_factory=lambda: ServiceSLO(
        soft_latency_s=2.0, hard_latency_s=10.0))
    flops_per_record: Optional[float] = 1e3
    bytes_per_record: float = 8.0
    operator: str = "window_agg"

    def profile(self) -> ServiceProfile:
        if self.flops_per_record is None:
            raise ValueError(
                f"service {self.name!r}: flops_per_record is None "
                "(declared-cost path); compile with a calibrator or set it")
        return ServiceProfile(slo=self.slo,
                              flops_per_record=self.flops_per_record,
                              bytes_per_record=self.bytes_per_record,
                              operator=self.operator)


# ---------------------------------------------------------------------------
# The scenario itself
# ---------------------------------------------------------------------------
_DEFAULT_SITES = (SiteSpec(SITE_EDGE, EdgeSpec()),)


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """The whole co-simulation, as data. See the module docstring."""
    name: str
    services: Tuple[ServiceSpec, ...] = ()
    farms: Tuple[FarmSpec, ...] = ()
    sites: Tuple[SiteSpec, ...] = _DEFAULT_SITES
    user_site: str = ""
    regions: Tuple[RegionSpec, ...] = ()   # () → flat single-uplink fleet
    horizon_s: float = 600.0
    epoch_s: Optional[float] = None     # None -> one epoch (static co-sim)
    drive_step_s: Optional[float] = None
    outages: Tuple[Tuple[str, Tuple[Tuple[float, float], ...]], ...] = ()
    heuristic: str = "hinted"
    power_cap_w: Optional[float] = None
    records_per_step: int = 5_000
    dc_step_floor_s: float = 1e-3
    mxu_efficiency: float = 0.5
    grid_shape: Tuple[int, int] = (hw.POD_X, hw.POD_Y)
    migration_warmup_s: Optional[float] = None
    state_bytes_per_record: float = 16.0
    # unplanned faults (crashes / partitions / straggling links) plus
    # the migration + ledger semantics applied under them; None keeps
    # every chaos code path dormant (bit-identical runs)
    chaos: Optional[ChaosSpec] = None

    # ------------------------------------------------------------- queries
    def service_names(self) -> List[str]:
        return [s.name for s in self.services]

    def topology(self) -> Dict[str, List[str]]:
        """Service DAG from the declared publishes_to edges."""
        topo: Dict[str, List[str]] = {}
        for s in self.services:
            topo[s.name] = [u.name for u in self.services
                            if u.publishes_to == s.queue]
        return topo

    def profiles(self) -> Dict[str, ServiceProfile]:
        return {s.name: s.profile() for s in self.services}

    def outage_map(self) -> Dict[str, Tuple[Tuple[float, float], ...]]:
        return {site: tuple(tuple(w) for w in wins)
                for site, wins in self.outages}

    # ---------------------------------------------------------- validation
    def validate(self) -> None:
        names = self.service_names()
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate service names: {names}")
        if not self.services:
            raise ValueError("a scenario needs at least one service")
        self.fleet_spec()   # site + region partition checks
        site_names = {s.name for s in self.sites}
        for site, _wins in self.outages:
            if site not in site_names:
                raise ValueError(f"outage for unknown site {site!r}")
        farm_queues = {f.queue for f in self.farms}
        if len(farm_queues) != len(self.farms):
            raise ValueError("one FarmSpec per queue (merge the things)")
        produced = farm_queues | {s.publishes_to for s in self.services
                                  if s.publishes_to}
        for s in self.services:
            if s.queue not in produced:
                raise ValueError(
                    f"service {s.name!r} consumes {s.queue!r} which no "
                    "farm or service publishes")
        for s in self.services:
            if s.publishes_to in farm_queues:
                raise ValueError(
                    f"service {s.name!r} republishes into farm queue "
                    f"{s.publishes_to!r}")
        for f in self.farms:
            if f.n_things < 1:
                raise ValueError(f"farm {f.queue!r}: n_things < 1")
        if self.chaos is not None:
            self.chaos.validate(sorted(site_names))

    def fleet_spec(self) -> FleetSpec:
        """The fleet topology: a :class:`HierFleetSpec` when regions
        are declared, the classic flat :class:`FleetSpec` otherwise
        (existing specs stay bit-identical)."""
        if self.regions:
            return HierFleetSpec(sites=self.sites, user_site=self.user_site,
                                 regions=self.regions)
        return FleetSpec(sites=self.sites, user_site=self.user_site)

    # ------------------------------------------------------------ assembly
    def build_pipeline(self) -> Pipeline:
        """One fresh functional pipeline (broker, farms, services,
        connections) — the engine calls this on every construction."""
        b = Broker()
        pipe = Pipeline(b)
        for f in self.farms:
            pipe.add_farm(_drift.DriftingFarm(
                b, f.rate.curve(self.horizon_s), queue=f.queue,
                n_things=f.n_things, seed=f.seed))
        by_name: Dict[str, StreamService] = {}
        for s in self.services:
            store = (TimeSeriesStore(
                f"{self.name}:{s.name}", chunk_seconds=s.store.chunk_seconds,
                edge_budget_chunks=s.store.edge_budget_chunks)
                if s.store is not None else None)
            svc = StreamService(ServiceConfig(
                name=s.name, queue=s.queue, column=s.column, agg=s.agg,
                window=WindowSpec(s.window_kind, s.width_s, s.slide_s),
                buffer_budget=s.buffer_budget, store=store), b)
            pipe.add_service(svc)
            by_name[s.name] = svc
        for s in self.services:
            if s.publishes_to:
                pipe.connect(by_name[s.name], s.publishes_to)
        return pipe

    def engine_config(self) -> EngineConfig:
        kw: Dict[str, Any] = {}
        if self.migration_warmup_s is not None:
            kw["migration_warmup_s"] = self.migration_warmup_s
        if self.chaos is not None:
            kw["chaos"] = self.chaos
        return EngineConfig(
            fleet=self.fleet_spec(),
            horizon_s=self.horizon_s, epoch_s=self.epoch_s,
            drive_step_s=self.drive_step_s, heuristic=self.heuristic,
            power_cap_w=self.power_cap_w,
            records_per_step=self.records_per_step,
            dc_step_floor_s=self.dc_step_floor_s,
            mxu_efficiency=self.mxu_efficiency, grid_shape=self.grid_shape,
            state_bytes_per_record=self.state_bytes_per_record, **kw)

    def compile(self, calibrator: Optional[Callable[["ServiceSpec"], float]]
                = None) -> ScenarioEngine:
        """Spec → unified engine. ``calibrator`` (e.g. a
        :class:`~repro_torch.scenario.calibrate.KernelCalibrator`, which
        launches the port's kernels on its device: the card unless it was
        built with ``device="cpu"``) replaces every declared
        ``flops_per_record`` with a measured one; it is *required* when
        any service declares ``flops_per_record=None``."""
        self.validate()
        if calibrator is not None:
            from repro_torch.scenario.calibrate import calibrate_profiles
            profiles, _ = calibrate_profiles(self, calibrator)
        else:
            profiles = self.profiles()
        return ScenarioEngine(self.build_pipeline, profiles,
                              self.engine_config(),
                              outages=self.outage_map())

    # ------------------------------------------------------------------ JSON
    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        # dataclasses.asdict already recursed; normalize tuples to lists
        return json.loads(json.dumps(d))

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Mapping) -> "ScenarioSpec":
        def _tt(seq):   # list-of-pairs -> tuple-of-tuples
            return tuple(tuple(x) for x in seq)

        services = tuple(
            ServiceSpec(
                **{**s,
                   "store": StoreSpec(**s["store"]) if s.get("store") else None,
                   "slo": ServiceSLO(**s["slo"])})
            for s in d.get("services", ()))
        farms = tuple(
            FarmSpec(**{**f, "rate": RateSpec(
                **{**f["rate"], "windows": _tt(f["rate"]["windows"]),
                   "knots": _tt(f["rate"]["knots"])})})
            for f in d.get("farms", ()))
        sites = tuple(
            SiteSpec(name=s["name"], edge=EdgeSpec(**s["edge"]),
                     link=LinkSpec(**s["link"]),
                     farm_queues=tuple(s["farm_queues"]))
            for s in d.get("sites", ()))
        regions = tuple(
            RegionSpec(name=r["name"], sites=tuple(r["sites"]),
                       rap=LinkSpec(**r["rap"]))
            for r in d.get("regions", ()))
        return cls(
            name=d["name"], services=services, farms=farms,
            sites=sites or _DEFAULT_SITES,
            user_site=d.get("user_site", ""),
            regions=regions,
            horizon_s=d.get("horizon_s", 600.0),
            epoch_s=d.get("epoch_s"),
            drive_step_s=d.get("drive_step_s"),
            outages=tuple((site, _tt(wins))
                          for site, wins in d.get("outages", ())),
            heuristic=d.get("heuristic", "hinted"),
            power_cap_w=d.get("power_cap_w"),
            records_per_step=d.get("records_per_step", 5_000),
            dc_step_floor_s=d.get("dc_step_floor_s", 1e-3),
            mxu_efficiency=d.get("mxu_efficiency", 0.5),
            grid_shape=tuple(d.get("grid_shape", (hw.POD_X, hw.POD_Y))),
            migration_warmup_s=d.get("migration_warmup_s"),
            state_bytes_per_record=d.get("state_bytes_per_record", 16.0),
            chaos=(ChaosSpec.from_dict(d["chaos"])
                   if d.get("chaos") else None))

    @classmethod
    def from_json(cls, s: str) -> "ScenarioSpec":
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Fluent builder
# ---------------------------------------------------------------------------
class ScenarioBuilder:
    """Fluent construction front for :class:`ScenarioSpec`. Service-
    scoped modifiers (``slo``/``profile``/``fed_by``/``with_store``)
    apply to the most recently declared service."""

    def __init__(self, name: str):
        self._name = name
        self._services: List[ServiceSpec] = []
        self._farms: List[FarmSpec] = []
        self._sites: Dict[str, Dict] = {}
        self._kw: Dict[str, Any] = {}
        self._outages: Dict[str, List[Tuple[float, float]]] = {}
        self._user_site = ""
        self._regions: List[RegionSpec] = []

    # --------------------------------------------------------------- global
    def horizon(self, seconds: float) -> "ScenarioBuilder":
        self._kw["horizon_s"] = float(seconds)
        return self

    def epochs(self, epoch_s: float) -> "ScenarioBuilder":
        self._kw["epoch_s"] = float(epoch_s)
        return self

    def drive_step(self, step_s: float) -> "ScenarioBuilder":
        self._kw["drive_step_s"] = float(step_s)
        return self

    def dc(self, **kw) -> "ScenarioBuilder":
        """DC engine knobs: records_per_step, dc_step_floor_s,
        mxu_efficiency, grid_shape, heuristic, power_cap_w."""
        allowed = {"records_per_step", "dc_step_floor_s", "mxu_efficiency",
                   "grid_shape", "heuristic", "power_cap_w",
                   "migration_warmup_s", "state_bytes_per_record"}
        bad = set(kw) - allowed
        if bad:
            raise TypeError(f"unknown dc() options: {sorted(bad)}")
        self._kw.update(kw)
        return self

    # ---------------------------------------------------------------- sites
    def site(self, name: str, edge: Optional[EdgeSpec] = None,
             link: Optional[LinkSpec] = None,
             user: bool = False) -> "ScenarioBuilder":
        if name == SITE_DC:
            raise ValueError(f"{SITE_DC!r} is reserved for the data center")
        self._sites[name] = {"edge": edge or EdgeSpec(name=name),
                             "link": link or LinkSpec(),
                             "farm_queues": self._sites.get(
                                 name, {}).get("farm_queues", [])}
        if user:
            self._user_site = name
        return self

    def outage(self, site: str, down_s: float, up_s: float
               ) -> "ScenarioBuilder":
        self._outages.setdefault(site, []).append((down_s, up_s))
        return self

    def chaos(self, spec: Optional[ChaosSpec] = None, **kw
              ) -> "ScenarioBuilder":
        """Attach unplanned faults: a prebuilt :class:`ChaosSpec`, or
        its fields as keywords (``crashes=``, ``partitions=``,
        ``straggles=``, ``migration=``, ``ledger_mode=``, ...)."""
        if spec is not None and kw:
            raise ValueError("pass a ChaosSpec or fields, not both")
        self._kw["chaos"] = spec if spec is not None else ChaosSpec(**kw)
        return self

    def region(self, name: str, *sites: str,
               rap: Optional[LinkSpec] = None) -> "ScenarioBuilder":
        """Group ``sites`` into a region behind one RAP trunk
        (declaring any site not yet declared). Regions must partition
        the fleet exactly — ``build()`` validates."""
        for s in sites:
            if s not in self._sites:
                self.site(s)
        from repro_torch.region.hier import DEFAULT_RAP
        self._regions.append(RegionSpec(
            name=name, sites=tuple(sites), rap=rap or DEFAULT_RAP))
        return self

    # ---------------------------------------------------------------- farms
    def farm(self, queue: str = "neubotspeed", n_things: int = 8,
             seed: int = 0, rate: Optional[RateSpec] = None,
             rate_hz: Optional[float] = None,
             site: Optional[str] = None) -> "ScenarioBuilder":
        if rate is not None and rate_hz is not None:
            raise ValueError("pass rate= or rate_hz=, not both")
        r = rate if rate is not None else RateSpec.constant(rate_hz or 1.0)
        self._farms.append(FarmSpec(queue=queue, n_things=n_things,
                                    seed=seed, rate=r))
        if site is not None:
            if site not in self._sites:
                self.site(site)
            self._sites[site]["farm_queues"].append(queue)
        return self

    # ------------------------------------------------------------- services
    def service(self, name: str, queue: str, column: str = "value",
                agg: str = "mean", width_s: float = 120.0,
                slide_s: float = 60.0, buffer_budget: int = 4096,
                window_kind: str = "sliding") -> "ScenarioBuilder":
        self._services.append(ServiceSpec(
            name=name, queue=queue, column=column, agg=agg,
            window_kind=window_kind, width_s=width_s, slide_s=slide_s,
            buffer_budget=buffer_budget))
        return self

    def _amend(self, **kw) -> "ScenarioBuilder":
        if not self._services:
            raise ValueError("declare a service first")
        self._services[-1] = dataclasses.replace(self._services[-1], **kw)
        return self

    def slo(self, **kw) -> "ScenarioBuilder":
        """SLO of the last service (ServiceSLO fields)."""
        return self._amend(slo=ServiceSLO(**kw))

    def profile(self, flops_per_record: Optional[float] = None,
                bytes_per_record: float = 8.0,
                operator: str = "window_agg") -> "ScenarioBuilder":
        """Operator cost of the last service. ``flops_per_record=None``
        defers to kernel calibration at compile time."""
        return self._amend(flops_per_record=flops_per_record,
                           bytes_per_record=bytes_per_record,
                           operator=operator)

    def fed_by(self, *upstreams: str) -> "ScenarioBuilder":
        """Declare that the last service's input queue is published by
        ``upstreams`` (sets their ``publishes_to``)."""
        if not self._services:
            raise ValueError("declare a service first")
        q = self._services[-1].queue
        for i, s in enumerate(self._services[:-1]):
            if s.name in upstreams:
                self._services[i] = dataclasses.replace(s, publishes_to=q)
        known = {s.name for s in self._services[:-1]}
        missing = set(upstreams) - known
        if missing:
            raise ValueError(f"fed_by unknown services: {sorted(missing)}")
        return self

    def with_store(self, chunk_seconds: float = 3600.0,
                   edge_budget_chunks: int = 48) -> "ScenarioBuilder":
        return self._amend(store=StoreSpec(chunk_seconds=chunk_seconds,
                                           edge_budget_chunks=edge_budget_chunks))

    # ------------------------------------------------------------------ build
    def build(self) -> ScenarioSpec:
        sites = (tuple(SiteSpec(name=n, edge=d["edge"], link=d["link"],
                                farm_queues=tuple(d["farm_queues"]))
                       for n, d in self._sites.items())
                 or _DEFAULT_SITES)
        spec = ScenarioSpec(
            name=self._name, services=tuple(self._services),
            farms=tuple(self._farms), sites=sites,
            user_site=self._user_site,
            regions=tuple(self._regions),
            outages=tuple((s, tuple(w)) for s, w in self._outages.items()),
            **self._kw)
        spec.validate()
        return spec


def scenario(name: str) -> ScenarioBuilder:
    """Entry point: ``scenario("my-workload")...build()``."""
    return ScenarioBuilder(name)
