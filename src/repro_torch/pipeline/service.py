"""The paper's stream-service architecture (Fig. 2): a scheduler drives the
recurrence; Fetch consumes notified streams into a bounded internal buffer
(with a data-management strategy that collaborates with the store when RAM
is short); OperatorLogic applies the analytics operation; Sink forwards
results to connected services.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.pipeline.operators import WindowSpec, aggregate
from repro_torch.pipeline.store import TimeSeriesStore
from repro_torch.pipeline.streams import Broker, Queue, Record


@dataclasses.dataclass
class ServiceConfig:
    name: str
    queue: str                    # input stream queue
    column: str                   # field to aggregate
    agg: str                      # max | min | mean | sum | count
    window: WindowSpec
    buffer_budget: int = 4096     # edge RAM (records) for the internal buffer
    store: Optional[TimeSeriesStore] = None  # post-mortem history source


class StreamService:
    """One big data/stream operator service (edge-resident)."""

    def __init__(self, cfg: ServiceConfig, broker: Broker):
        self.cfg = cfg
        self.q: Queue = broker.queue(cfg.queue)
        self.q.register(cfg.name)
        self.buffer: List[Record] = []
        self.results: List[Dict] = []
        self.sinks: List[Callable[[Dict], None]] = []
        self._next_fire = cfg.window.slide_s
        self.buffer_evictions = 0
        # observers (e.g. the conservation taps) see each eviction batch
        # without re-scanning the buffer; None when nobody listens
        self._spill_hook: Optional[Callable[[List[Record]], None]] = None

    # ---- Fetch: unlimited consumption of notified records ----------------
    def fetch(self) -> int:
        recs = self.q.fetch(self.cfg.name)
        buf = self.buffer
        buf.extend(recs)
        # data-management strategy: records older than the window spill to
        # the store (if attached) instead of being lost (paper §3)
        horizon = buf[-1].ts - self.cfg.window.width_s if buf else 0.0
        keep = [r for r in buf if r.ts >= horizon]
        spill = ([r for r in buf if r.ts < horizon]
                 if len(keep) != len(buf) else [])
        if len(keep) > self.cfg.buffer_budget:
            spill.extend(keep[:-self.cfg.buffer_budget])
            keep = keep[-self.cfg.buffer_budget:]
        if spill:
            self.buffer_evictions += len(spill)
            store = self.cfg.store
            if store is not None:
                for r in spill:
                    store.append(r)
            if self._spill_hook is not None:
                self._spill_hook(spill)
        self.buffer = keep
        return len(recs)

    # ---- OperatorLogic ----------------------------------------------------
    def _window_values(self, now: float) -> np.ndarray:
        w = self.cfg.window
        lo = 0.0 if w.kind == "landmark" else now - w.width_s
        vals = [r.values[self.cfg.column] for r in self.buffer
                if lo <= r.ts < now]
        if self.cfg.store is not None and (not self.buffer
                                           or self.buffer[0].ts > lo):
            # history beyond the buffer comes from the store; clamp to `now`
            # (catch-up fires must not see records from their future)
            hi = min(self.buffer[0].ts, now) if self.buffer else now
            vals = list(self.cfg.store.scan(lo, hi, self.cfg.column)) + vals
        return np.asarray(vals)

    def fire(self, now: float) -> Optional[Dict]:
        vals = self._window_values(now)
        res = {"service": self.cfg.name, "ts": now,
               "agg": self.cfg.agg, "n": len(vals),
               "value": aggregate(vals, self.cfg.agg)}
        self.results.append(res)
        for sink in self.sinks:
            sink(res)
        return res

    # ---- Scheduler: recurrence rate (paper Fig. 2) -------------------------
    def run_until(self, now: float) -> List[Dict]:
        out = []
        self.fetch()
        while self._next_fire <= now:
            out.append(self.fire(self._next_fire))
            self._next_fire += self.cfg.window.slide_s
        return out

    def connect(self, sink: Callable[[Dict], None]) -> None:
        self.sinks.append(sink)
