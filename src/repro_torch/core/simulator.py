"""Discrete-event simulator for JITA-4DS (§4.2).

Events: task arrivals and VDC completions. At every event the active
heuristic maps pending tasks onto freshly composed VDCs; tasks whose
value has decayed to zero under every configuration are dropped
(oversubscription). Completion earns Eq. 1 value; Eq. 2 accumulates.

Two driving modes share one event loop:

  * ``run(trace)`` — the classic one-shot mode: the full trace is
    injected up front and the heap drained to completion.
  * the incremental event-feed API — ``begin()`` / ``inject(task)`` /
    ``run_until(t)`` / ``finalize()`` — lets a co-simulator submit tasks
    *while the simulation is in flight* (the edge→DC bridge produces DC
    tasks as upstream fires resolve), interleaving heap processing with
    external progress. Grid occupancy, pending backlog and the power cap
    persist between ``run_until`` calls, so late arrivals contend with
    the live VDC state instead of an optimistic estimate.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

from repro_torch.core.costmodel import CostModel
from repro_torch.core.heuristics import Heuristic
from repro_torch.core.tasks import Task
from repro_torch.core.value import task_value
from repro_torch.core.vdc import PodGrid


@dataclasses.dataclass
class SimResult:
    heuristic: str
    vos: float                      # Eq. 2 total
    perf_value: float               # Σ γ w_p v_p
    energy_value: float             # Σ γ w_e v_e
    completed: int
    dropped: int
    total_energy_j: float
    makespan: float
    avg_utilization: float
    vos_normalized: float           # vos / Σ_j γ_j (w_p+w_e) v_max
    tasks: List[Task] = dataclasses.field(default_factory=list, repr=False)


class Simulator:
    def __init__(self, heuristic: Heuristic, cost: CostModel,
                 power_cap_w: Optional[float] = None,
                 grid: Optional[PodGrid] = None):
        self.heuristic = heuristic
        self.cost = cost
        self.power_cap_w = power_cap_w
        self.grid = grid or PodGrid()
        self._begun = False

    # ------------------------------------------------- incremental event feed
    def begin(self) -> "Simulator":
        """Reset the event loop for incremental feeding."""
        self._events: List[Tuple[float, int, str, object]] = []
        # pending queue: insertion-ordered, O(1) membership and removal
        # (keyed by object identity — the one-shot hot loop used to pay
        # an O(n) list.remove per scheduled task)
        self._pending: Dict[int, Task] = {}
        # per-task best-possible memo for _drop_dead: duration and
        # energy on the largest allowable config never change, so the
        # cost-model lookups happen once per task instead of once per
        # pending task per event
        self._bp: Dict[int, Tuple[float, float]] = {}
        self._seq = 0
        self._vos = self._perf_v = self._energy_v = 0.0
        self._tot_energy = 0.0
        self._completed = self._dropped = 0
        self._util_area = 0.0
        self._now = 0.0
        self._tasks: List[Task] = []
        self._begun = True
        return self

    @property
    def now(self) -> float:
        """Current simulation clock (last processed/advanced-to time)."""
        return self._now if self._begun else 0.0

    def inject(self, task: Task) -> None:
        """Feed one task into the live event heap. A task whose nominal
        ``arrival`` lies in the simulator's past (the feeder learned of it
        late) is admitted at the current clock — its *value* latency is
        still measured from the true ``arrival``, so late admission costs
        value rather than rewriting history."""
        if not self._begun:
            self.begin()
        self._tasks.append(task)
        heapq.heappush(self._events,
                       (max(task.arrival, self._now), self._seq,
                        "arrive", task))
        self._seq += 1

    def next_event_time(self) -> Optional[float]:
        return self._events[0][0] if self._begun and self._events else None

    def run_until(self, t: float) -> None:
        """Process every event with timestamp <= t, then advance the
        clock to t (idle time accrues zero utilization area)."""
        if not self._begun:
            self.begin()
        while self._events and self._events[0][0] <= t:
            self._step()
        if t > self._now:
            self._util_area += self.grid.used_chips * (t - self._now)
            self._now = t

    def drain(self) -> None:
        """Process every remaining event (no clock advance past the last)."""
        if not self._begun:
            self.begin()
        while self._events:
            self._step()

    def _step(self) -> None:
        now, _, kind, payload = heapq.heappop(self._events)
        self._util_area += self.grid.used_chips * (now - self._now)
        self._now = now
        if kind == "arrive":
            self._pending[id(payload)] = payload
        else:  # complete
            task, vdc = payload
            self.grid.release(vdc)
            latency = task.finish - task.arrival
            v_p = task.value.perf_curve.value(latency)
            v_e = task.value.energy_curve.value(task.energy_j)
            v = task_value(task.value, latency, task.energy_j)
            task.earned = v
            self._vos += v
            if v > 0:
                self._perf_v += task.value.gamma * task.value.w_p * v_p
                self._energy_v += task.value.gamma * task.value.w_e * v_e
            self._tot_energy += task.energy_j
            self._completed += 1

        self._drop_dead(now)
        for task, chips, f in self.heuristic.assign(
                list(self._pending.values()), self.grid, self.cost, now,
                self.power_cap_w):
            vdc = self.grid.compose(chips, f, task.tid)
            if vdc is None:
                continue
            del self._pending[id(task)]
            self._bp.pop(id(task), None)
            t_step = self.cost.time_per_step(task.ttype.arch,
                                             task.ttype.shape, chips, f)
            task.start = now
            task.finish = now + t_step * task.steps
            task.chips, task.dvfs_f = chips, f
            task.energy_j = self.cost.energy_per_step(
                task.ttype.arch, task.ttype.shape, chips, f) * task.steps
            self._seq += 1
            heapq.heappush(self._events,
                           (task.finish, self._seq, "complete", (task, vdc)))

    def _drop_dead(self, now: float) -> None:
        dead: List[int] = []
        for key, task in self._pending.items():
            memo = self._bp.get(key)
            if memo is None:
                best_chips = max(task.ttype.allowable_chips)
                t_step = self.cost.time_per_step(
                    task.ttype.arch, task.ttype.shape, best_chips, 1.0)
                energy = self.cost.energy_per_step(
                    task.ttype.arch, task.ttype.shape, best_chips,
                    1.0) * task.steps
                memo = (t_step * task.steps, energy)
                self._bp[key] = memo
            dur, energy = memo
            if task_value(task.value, (now - task.arrival) + dur,
                          energy) > 0.0:
                continue
            task.dropped = True
            self._dropped += 1
            dead.append(key)
        for key in dead:
            del self._pending[key]
            self._bp.pop(key, None)

    def finalize(self) -> SimResult:
        """Drain outstanding events and close the books. Tasks still
        pending earn nothing (counted dropped, like the one-shot mode)."""
        self.drain()
        dropped = self._dropped + len(self._pending)
        max_vos = sum(t.value.gamma * (t.value.w_p + t.value.w_e)
                      for t in self._tasks) or 1.0
        result = SimResult(
            heuristic=self.heuristic.name, vos=self._vos,
            perf_value=self._perf_v, energy_value=self._energy_v,
            completed=self._completed, dropped=dropped,
            total_energy_j=self._tot_energy, makespan=self._now,
            avg_utilization=self._util_area / max(self._now, 1e-9)
            / self.grid.total_chips,
            vos_normalized=self._vos / max_vos, tasks=self._tasks)
        self._begun = False
        return result

    def pending_tasks(self) -> List[Task]:
        """Tasks admitted but not yet scheduled (live view)."""
        return list(self._pending.values()) if self._begun else []

    def withdraw(self, task: Task) -> bool:
        """Cancel an admitted-but-unscheduled task (the feeder gave up on
        it — e.g. a starved offload with no event left to trigger its
        assignment). Counted as dropped."""
        if self._begun and id(task) in self._pending:
            del self._pending[id(task)]
            self._bp.pop(id(task), None)
            task.dropped = True
            self._dropped += 1
            return True
        return False

    # ------------------------------------------------------ one-shot driving
    def run(self, trace: List[Task]) -> SimResult:
        """Classic mode: inject the whole trace, drain, finalize. For a
        trace in (arrival, tid) order this is event-for-event identical
        to feeding the tasks incrementally."""
        self.begin()
        for t in trace:
            self.inject(t)
        return self.finalize()


def _best_possible(task: Task, cost: CostModel, now: float, chips: int):
    """Optimistic value if started right now on the largest config."""
    t_step = cost.time_per_step(task.ttype.arch, task.ttype.shape, chips, 1.0)
    dur = t_step * task.steps
    latency = (now - task.arrival) + dur
    energy = cost.energy_per_step(task.ttype.arch, task.ttype.shape,
                                  chips, 1.0) * task.steps
    return task_value(task.value, latency, energy), dur, energy


def compare_heuristics(heuristics, cost: CostModel, trace_fn,
                       n_traces: int = 5,
                       power_cap_w: Optional[float] = None
                       ) -> Dict[str, List[SimResult]]:
    """Run each heuristic over n fresh traces (same seeds across heuristics)."""
    import copy
    out: Dict[str, List[SimResult]] = {h.name: [] for h in heuristics}
    for i in range(n_traces):
        base_trace = trace_fn(i)
        for h in heuristics:
            trace = copy.deepcopy(base_trace)
            sim = Simulator(h, cost, power_cap_w=power_cap_w)
            out[h.name].append(sim.run(trace))
    return out
