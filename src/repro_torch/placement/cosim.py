"""DEPRECATED shim — the single-site co-simulator now runs on the
unified DES-bridged engine (``repro_torch.scenario.engine``).

This module used to implement a *two-pass* timing scheme: pass 1
collected the DC task trace with optimistic completion estimates for
DC→DC handoffs, pass 2 re-ran the timing with the simulated completion
times. That estimation path is retired: :class:`CoSimulator` below is a
thin adapter that submits every DC-placed fire *incrementally* into one
persistent JITA-4DS :class:`~repro_torch.core.simulator.Simulator` via
:class:`~repro_torch.scenario.engine.ScenarioEngine` — completions, scheduler
drops, VDC composition pressure and power-cap contention are
co-simulated, never estimated, for the single-gateway case exactly as
for multi-site fleets.

New code should use the Scenario API directly::

    from repro_torch.scenario import scenario, ScenarioSpec
    engine = spec.compile()
    result = engine.run_plan(plan)        # == CoSimulator(...).run(plan)

Everything re-exported here (`ServiceSLO`, `ServiceProfile`, the
ledgers, `analytics_cost_model`, `CoSimResult`) lives in
``repro_torch.scenario`` now; the names remain importable from this module for
backward compatibility.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, Optional, Tuple

from repro_torch import hardware as hw
from repro_torch.pipeline.composition import Pipeline
from repro_torch.placement.edge import EdgeSpec
from repro_torch.placement.network import LinkSpec
from repro_torch.placement.plan import PlacementPlan
from repro_torch.scenario.engine import (CoSimResult, EngineConfig,  # noqa: F401
                                         HintedVPTR, ScenarioEngine,
                                         _fresh_heuristic, _infeasible,
                                         analytics_cost_model, single_site_fleet)
from repro_torch.scenario.ledger import (FireRec, RecordLedger,  # noqa: F401
                                         ServiceLedger, _PublisherContext,
                                         _QueueTap, _ServiceTap, _topo_order)
from repro_torch.scenario.profiles import ServiceProfile, ServiceSLO  # noqa: F401

_EPS = 1e-6


@dataclasses.dataclass
class CoSimConfig:
    """Single-gateway engine knobs (legacy surface). ``epoch_s`` here is
    the *drive* granularity of the functional dataflow — the whole
    horizon is always one placement epoch."""
    edge: EdgeSpec = dataclasses.field(default_factory=EdgeSpec)
    link: LinkSpec = dataclasses.field(default_factory=LinkSpec)
    horizon_s: float = 600.0
    epoch_s: Optional[float] = None   # drive granularity; None -> min slide
    heuristic: str = "hinted"         # "hinted" or a HEURISTICS name
    power_cap_w: Optional[float] = None
    records_per_step: int = 5_000     # records one DC task step consumes
    dc_step_floor_s: float = 1e-3     # VDC kernel launch + ICI sync floor
    mxu_efficiency: float = 0.5
    grid_shape: Tuple[int, int] = (hw.POD_X, hw.POD_Y)


class CoSimulator:
    """DEPRECATED: evaluates placement plans for one single-gateway
    pipeline scenario by delegating to the unified
    :class:`~repro_torch.scenario.engine.ScenarioEngine`.

    ``build`` must return a *fresh* Pipeline (broker, farms, services,
    connections) on every call. The functional dataflow is driven once
    and cached — it does not depend on the plan — so a search over many
    plans only pays the per-plan timing/DC simulation. Mutating ``cfg``
    fields that shape the dataflow (``horizon_s``, ``epoch_s``) or the
    DC cost cells (``records_per_step``, ``dc_step_floor_s``,
    ``mxu_efficiency``) after construction requires a new CoSimulator;
    edge/link/heuristic fields may be swapped between runs.
    """

    # cfg fields baked into the cached drive / cost cells at construction
    _FROZEN = ("horizon_s", "epoch_s", "records_per_step",
               "dc_step_floor_s", "mxu_efficiency")

    def __init__(self, build: Callable[[], Pipeline],
                 profiles: Dict[str, ServiceProfile],
                 cfg: Optional[CoSimConfig] = None):
        warnings.warn(
            "repro_torch.placement.cosim.CoSimulator is deprecated and will be "
            "removed in v0.9 (2026-12-01); use the Scenario API instead: "
            "spec.compile().run_plan(plan) (see README, Migration table)",
            DeprecationWarning, stacklevel=2)
        self.build = build
        self.profiles = dict(profiles)
        self.cfg = cfg or CoSimConfig()
        self._frozen = {k: getattr(self.cfg, k) for k in self._FROZEN}
        self._engine = ScenarioEngine(build, self.profiles,
                                      self._engine_config())
        self.topology = self._engine.topology
        self.service_names = list(self._engine.order)
        self.order = self._engine.order
        self.rank = self._engine.rank
        self.cost = self._engine.cost

    def _engine_config(self) -> EngineConfig:
        cfg = self.cfg
        return EngineConfig(
            fleet=single_site_fleet(cfg.edge, cfg.link),
            horizon_s=cfg.horizon_s, epoch_s=None,
            drive_step_s=cfg.epoch_s, heuristic=cfg.heuristic,
            power_cap_w=cfg.power_cap_w,
            records_per_step=cfg.records_per_step,
            dc_step_floor_s=cfg.dc_step_floor_s,
            mxu_efficiency=cfg.mxu_efficiency, grid_shape=cfg.grid_shape)

    def _sync_engine(self) -> ScenarioEngine:
        """Refresh the swappable cfg fields (edge/link/heuristic/power
        cap) on the long-lived engine; the cached functional drive and
        cost cells are untouched — they don't depend on them. Mutating a
        drive/cost-shaping field after construction fails loudly instead
        of silently simulating the stale value."""
        stale = {k: (self._frozen[k], getattr(self.cfg, k))
                 for k in self._FROZEN
                 if getattr(self.cfg, k) != self._frozen[k]}
        if stale:
            raise ValueError(
                "CoSimulator cfg fields baked in at construction were "
                f"mutated (old -> new): {stale}; build a new CoSimulator "
                "(or use the Scenario API: dataclasses.replace(spec, ...)"
                ".compile())")
        e = self._engine
        ecfg = e.cfg
        ecfg.fleet = single_site_fleet(self.cfg.edge, self.cfg.link)
        ecfg.heuristic = self.cfg.heuristic
        ecfg.power_cap_w = self.cfg.power_cap_w
        ecfg.grid_shape = self.cfg.grid_shape
        return e

    def run(self, plan: PlacementPlan) -> CoSimResult:
        return self._sync_engine().run_plan(plan)
