"""Resource-management heuristics (§4.1-4.2).

All heuristics share one interface: given the pending queue, the pod grid,
the cost model and the power budget, return assignments
``[(task, chips, dvfs_f), ...]`` to start now.

  Simple    — FCFS, max allowable config, nominal frequency, no value
              awareness, strict queue order (the paper's baseline).
  VPT       — greedy max value-per-time.
  VPTR      — greedy max Value-Per-Total-Resources (Eq. 3):
              TaR = TeD × (%chips + %HBM).
  VPT-CPC   — VPT under a COMMON power-cap frequency for every new VDC.
  VPT-JSPC  — VPT with a job-specific frequency chosen per assignment.
  Hybrid    — JSPC freedom for high-importance jobs (γ ≥ 4), CPC for the rest.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch import hardware as hw
from repro_torch.core.costmodel import CostModel
from repro_torch.core.tasks import Task
from repro_torch.core.value import task_value
from repro_torch.core.vdc import PodGrid

Assignment = Tuple[Task, int, float]  # (task, chips, dvfs_f)
DVFS_FS = tuple(d.f for d in hw.DVFS_LADDER)


def _feasible_chips(task: Task, grid: PodGrid, cost: CostModel) -> List[int]:
    lo = cost.min_chips(task.ttype.arch, task.ttype.shape)
    return [c for c in task.ttype.allowable_chips
            if c >= lo and c <= grid.total_chips]


def _value_if(task: Task, cost: CostModel, now: float, chips: int,
              f: float) -> Tuple[float, float, float]:
    """(value, exec_duration, energy) if started now on (chips, f)."""
    t_step = cost.time_per_step(task.ttype.arch, task.ttype.shape, chips, f)
    dur = t_step * task.steps
    latency = (now - task.arrival) + dur
    energy = cost.energy_per_step(task.ttype.arch, task.ttype.shape,
                                  chips, f) * task.steps
    return task_value(task.value, latency, energy), dur, energy


class Heuristic:
    name = "base"
    # The system power cap is a HARD constraint enforced on every heuristic
    # (the paper's §4.2 runs all heuristics under the same cap); only the
    # *-CPC/JSPC/Hybrid variants may trade frequency for parallelism.
    can_scale_f = False

    def assign(self, pending: List[Task], grid: PodGrid, cost: CostModel,
               now: float, power_cap_w: Optional[float] = None
               ) -> List[Assignment]:
        raise NotImplementedError

    # -- power helpers ------------------------------------------------------
    def _headroom(self, grid: PodGrid, cost: CostModel,
                  power_cap_w: Optional[float], extra: float = 0.0) -> float:
        if power_cap_w is None:
            return float("inf")
        return power_cap_w - grid.power_w(cost) - extra


class SimpleHeuristic(Heuristic):
    name = "Simple"

    def assign(self, pending, grid, cost, now, power_cap_w=None):
        out = []
        for task in sorted(pending, key=lambda t: t.arrival):
            chips_opts = _feasible_chips(task, grid, cost)
            if not chips_opts:
                continue
            chips = max(chips_opts)
            if chips > grid.free_chips:
                break  # strict FIFO: head-of-line blocks the queue
            out.append((task, chips, 1.0))
            grid_free = grid.free_chips  # noqa: simple bookkeeping below
            # reserve virtually (the simulator composes for real)
            if not self._reserve(grid, chips):
                break
        self._unreserve_all(grid)
        return out

    # Simple keeps a virtual reservation list so multiple FIFO heads can
    # start in one scheduling round.
    def _reserve(self, grid, chips):
        self._res = getattr(self, "_res", 0) + chips
        return self._res <= grid.free_chips

    def _unreserve_all(self, grid):
        self._res = 0


class _GreedyValue(Heuristic):
    """Shared greedy loop: repeatedly pick the argmax-objective assignment."""
    name = "greedy"

    def objective(self, task, value, dur, energy, chips, grid) -> float:
        raise NotImplementedError

    def _freqs(self, task, headroom_fn) -> Tuple[float, ...]:
        return (1.0,)

    def assign(self, pending, grid, cost, now, power_cap_w=None):
        out: List[Assignment] = []
        free = grid.free_chips
        budget = self._headroom(grid, cost, power_cap_w)
        remaining = [t for t in pending]
        while remaining:
            best = None
            for task in remaining:
                for chips in _feasible_chips(task, grid, cost):
                    if chips > free:
                        continue
                    for f in self._freqs(task, None):
                        v, dur, energy = _value_if(task, cost, now, chips, f)
                        if v <= 0:
                            continue
                        if cost.power_w(chips, f) > budget:
                            continue  # hard cap: wait instead of violating
                        obj = self.objective(task, v, dur, energy, chips, grid)
                        if best is None or obj > best[0]:
                            best = (obj, task, chips, f)
            if best is None:
                break
            _, task, chips, f = best
            out.append((task, chips, f))
            remaining.remove(task)
            free -= chips
            budget -= cost.power_w(chips, f)
        return out


class VPTHeuristic(_GreedyValue):
    name = "VPT"

    def objective(self, task, value, dur, energy, chips, grid):
        return value / max(dur, 1e-9)


class VPTRHeuristic(_GreedyValue):
    """Maximum Value-Per-Total-Resources (Eq. 3)."""
    name = "VPTR"

    def objective(self, task, value, dur, energy, chips, grid):
        pct_chips = chips / grid.total_chips
        pct_hbm = min(1.0, task.hbm_bytes /
                      (grid.total_chips * hw.HBM_BYTES))
        tar = dur * (pct_chips + pct_hbm)
        return value / max(tar, 1e-9)


class VPTCPCHeuristic(VPTHeuristic):
    """VPT under a Common Power Cap: one frequency for every new VDC,
    the highest ladder step whose projected total power fits the cap."""
    name = "VPT-CPC"
    can_scale_f = True

    def assign(self, pending, grid, cost, now, power_cap_w=None):
        if power_cap_w is None:
            return super().assign(pending, grid, cost, now, None)
        best, best_n = [], -1
        for f in DVFS_FS:  # highest first
            self._common_f = f
            out = super().assign(pending, grid, cost, now, power_cap_w)
            if len(out) > best_n:
                best, best_n = out, len(out)
        return best

    def _freqs(self, task, headroom_fn):
        return (getattr(self, "_common_f", 1.0),)


class VPTJSPCHeuristic(VPTHeuristic):
    """VPT with Job-Specific Power Capping: frequency chosen per job."""
    name = "VPT-JSPC"
    can_scale_f = True

    def _freqs(self, task, headroom_fn):
        return DVFS_FS


class HybridHeuristic(VPTHeuristic):
    """CPC baseline with JSPC freedom for high-importance jobs ([10,11])."""
    name = "Hybrid"
    can_scale_f = True
    gamma_cut = 4.0

    def _freqs(self, task, headroom_fn):
        if task.value.gamma >= self.gamma_cut:
            return DVFS_FS
        return (0.7,)  # conservative common cap frequency


HEURISTICS = {h.name: h for h in (
    SimpleHeuristic(), VPTHeuristic(), VPTRHeuristic(),
    VPTCPCHeuristic(), VPTJSPCHeuristic(), HybridHeuristic())}
