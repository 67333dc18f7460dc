"""Straggler detection & mitigation.

Per-step host heartbeats feed a rolling deadline-quantile detector; hosts
consistently past the p95×slack deadline are flagged. Mitigation policies:
  - BackupStepPolicy: re-dispatch the straggler's shard to a hot spare
    (speculative execution, MapReduce-style) — modeled.
  - the VoS scheduler (core/) treats a persistent straggler as a failed
    node: checkpoint → recompose the VDC without it → elastic restart.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Deque, Dict, List, Optional, Tuple


@dataclasses.dataclass
class StragglerEvent:
    step: int
    host: int
    t_host: float
    deadline: float


class StragglerMonitor:
    def __init__(self, n_hosts: int, window: int = 20, slack: float = 1.5,
                 min_samples: int = 5):
        self.n_hosts = n_hosts
        self.window = window
        self.slack = slack
        self.min_samples = min_samples
        self.history: Deque[List[float]] = collections.deque(maxlen=window)
        self.events: List[StragglerEvent] = []
        self.flags: Dict[int, int] = collections.defaultdict(int)

    def record_step(self, step: int, host_times: List[float]
                    ) -> List[StragglerEvent]:
        """host_times[i] = wall seconds host i took for this step."""
        self.history.append(list(host_times))
        if len(self.history) < self.min_samples:
            return []
        all_t = [t for row in self.history for t in row]
        all_t.sort()
        # median-based deadline: robust to the stragglers themselves
        # polluting the window (a p95 deadline self-inflates)
        med = all_t[len(all_t) // 2]
        deadline = med * self.slack
        out = []
        for h, t in enumerate(host_times):
            if t > deadline:
                ev = StragglerEvent(step, h, t, deadline)
                self.events.append(ev)
                self.flags[h] += 1
                out.append(ev)
        return out

    def persistent_stragglers(self, threshold: int = 3) -> List[int]:
        return [h for h, n in self.flags.items() if n >= threshold]

    def slowdown_factor(self, host: int) -> float:
        """Estimated slowdown of `host` relative to the window median
        (>= 1.0): the mitigation knob a chaos-aware planner multiplies
        the host's serialization/step model by. Zero samples (an idle
        host) contribute nothing."""
        samples = [row[host] for row in self.history
                   if host < len(row) and row[host] > 0.0]
        if not samples:
            return 1.0
        all_t = sorted(t for row in self.history for t in row if t > 0.0)
        if not all_t:
            return 1.0
        med = all_t[len(all_t) // 2]
        if med <= 0.0:
            return 1.0
        return max(1.0, (sum(samples) / len(samples)) / med)


class BackupStepPolicy:
    """Speculative re-execution: when a host misses the deadline, its shard
    is re-dispatched to a spare; the step completes at the earlier of the
    two. Returns the effective step time under the policy."""

    def __init__(self, n_spares: int = 1, redispatch_cost: float = 0.1):
        self.n_spares = n_spares
        self.redispatch_cost = redispatch_cost
        self.saved_s = 0.0
        self.backups = 0

    def effective_step_time(self, host_times: List[float],
                            deadline: float, typical: float) -> float:
        """Step time = max over hosts, with up to n_spares stragglers
        replaced by (deadline + redispatch + typical)."""
        times = sorted(host_times, reverse=True)
        budget = self.n_spares
        eff = []
        for t in times:
            if t > deadline and budget > 0:
                budget -= 1
                self.backups += 1
                backup = deadline + self.redispatch_cost + typical
                saved = t - min(t, backup)
                self.saved_s += max(0.0, saved)
                eff.append(min(t, backup))
            else:
                eff.append(t)
        return max(eff)
