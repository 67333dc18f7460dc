"""Placement routing for the serving runtime.

The router owns the live plan schedule: which site executes each
service in each epoch, the migration stalls a plan switch imposes, and
the DC-side execution model for DC-routed fires. Edge-routed fires run
on the fleet's serial gateway devices (the stage calls
``EdgeSite.execute_fire`` directly, in virtual-time order); DC-routed
fires run here, against an analytic roofline cost
(:func:`repro_torch.scenario.analytics_cost_model` cells — the same cells the
DES prices) under a finite chip pool. The runtime deliberately does
*not* embed the JITA-4DS DES: the gap between this analytic DC model
and the co-simulated scheduler is part of the sim-vs-real gap
``bench_serve`` measures.
"""
from __future__ import annotations

import heapq
import math
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.costmodel import CostModel
from repro_torch.core.elastic import ServiceMigration, plan_replacement
from repro_torch.placement.plan import PlacementPlan, ServicePlacement


class DCPool:
    """Finite virtual-time chip reservation: a DC fire holds its
    placement's chip count for its analytic duration; when the pool is
    exhausted the fire waits for the earliest releases (FIFO in the
    virtual-time order stages reach the pool)."""

    def __init__(self, total_chips: int):
        self.total = total_chips
        self._busy: List[Tuple[float, int]] = []   # (release_t, chips)
        self._used = 0
        self.wait_s = 0.0          # total admission wait across fires
        self.admissions = 0

    def acquire(self, t: float, chips: int, duration: float) -> float:
        """Reserve ``chips`` for ``duration`` starting no earlier than
        ``t``; returns the actual start time."""
        chips = min(chips, self.total)
        while self._busy and self._busy[0][0] <= t:
            self._used -= heapq.heappop(self._busy)[1]
        start = t
        while self.total - self._used < chips:
            rel, c = heapq.heappop(self._busy)
            self._used -= c
            start = max(start, rel)
        self._used += chips
        heapq.heappush(self._busy, (start + duration, chips))
        self.wait_s += start - t
        self.admissions += 1
        return start


class PlacementRouter:
    """Live plan schedule + migration stalls + the DC execution model."""

    def __init__(self, cost: CostModel, grid_chips: int,
                 records_per_step: int,
                 state_bytes: Callable[[str], float],
                 ship_state: Callable[[str, str, float, float], float],
                 warmup_s: float):
        self.cost = cost
        self.records_per_step = records_per_step
        self.dc = DCPool(grid_chips)
        self._state_bytes = state_bytes
        self._ship_state = ship_state
        self.warmup_s = warmup_s
        self._plans: List[PlacementPlan] = []
        self._epoch_plan: List[int] = []    # epoch -> index into _plans
        self._stalls: Dict[str, List[Tuple[float, float]]] = {}

    # ------------------------------------------------------------- schedule
    def push_plan(self, plan: PlacementPlan, t0: float,
                  charge: bool = True, epoch: Optional[int] = None,
                  migrations: Optional[List] = None
                  ) -> List[ServiceMigration]:
        """Adopt ``plan`` for the epoch starting at ``t0``. Site moves
        ship operator state over the contended uplink and stall the
        service for transfer + warm-up (cost math from
        ``repro_torch.core.elastic``, identical to the engine).

        Mid-epoch chaos re-plans pass ``epoch`` (the epoch being
        overridden: fires dispatched after the push route under the new
        plan) and ``migrations`` (pre-computed checkpoint-aware
        :class:`~repro_torch.chaos.migrate.ChaosMigration` costs, which
        replace the raw-state epoch-boundary model)."""
        migs: List[ServiceMigration] = migrations
        if migrations is None:
            migs = []
            if self._plans:
                def _xfer(src: str, dst: str, nbytes: float) -> float:
                    if not charge:
                        return 0.0
                    return self._ship_state(src, dst, nbytes, t0) - t0
                migs = plan_replacement(self._plans[-1].assignments,
                                        plan.assignments,
                                        self._state_bytes, _xfer,
                                        warmup_s=self.warmup_s)
        if charge:
            for m in migs:
                self._stalls.setdefault(m.service, []).append(
                    (t0, t0 + m.stall_s))
        self._plans.append(plan)
        if epoch is None:
            self._epoch_plan.append(len(self._plans) - 1)
        else:
            self._epoch_plan[epoch] = len(self._plans) - 1
        return migs

    @property
    def plans(self) -> List[PlacementPlan]:
        return self._plans

    def placement(self, svc: str, epoch: int) -> ServicePlacement:
        i = self._epoch_plan[min(epoch, len(self._epoch_plan) - 1)]
        return self._plans[i].placement(svc)

    def site(self, svc: str, epoch: int) -> str:
        return self.placement(svc, epoch).site

    def stall_ready(self, svc: str, ts: float) -> float:
        """Earliest time a fire dispatched at ``ts`` may start, given
        migration stalls already imposed on the service."""
        t = 0.0
        for t_mig, ready in self._stalls.get(svc, ()):
            if t_mig <= ts:
                t = max(t, ready)
        return t

    # ------------------------------------------------------------- DC model
    def dc_cost(self, svc: str, n_window: int,
                p: ServicePlacement) -> Tuple[float, float]:
        """(duration_s, energy_j) of one DC fire under its placement's
        VDC sizing/DVFS hints — the analytic roofline price per step
        times the fire's step count (same cells the DES prices)."""
        steps = max(1, math.ceil(n_window / self.records_per_step))
        dur = steps * self.cost.time_per_step(f"svc:{svc}", "window",
                                              p.chips, p.dvfs_f)
        energy = steps * self.cost.energy_per_step(f"svc:{svc}", "window",
                                                   p.chips, p.dvfs_f)
        return dur, energy
