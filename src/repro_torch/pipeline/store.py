"""Time-indexed columnar store (the paper's Cassandra series stand-in).

Post-mortem observations live in time-chunked column arrays; services
combine range scans over the store with live broker streams (the 120-day
mean query). Chunks can be 'spilled' (dropped to a spill list) to model
the paper's buffer-space collaboration between edge RAM and VDC storage.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.pipeline.streams import Record


@dataclasses.dataclass
class Chunk:
    t0: float
    ts: np.ndarray                  # [n]
    cols: Dict[str, np.ndarray]    # each [n]
    spilled: bool = False


class TimeSeriesStore:
    def __init__(self, series: str, chunk_seconds: float = 3600.0,
                 edge_budget_chunks: int = 48):
        self.series = series
        self.chunk_seconds = chunk_seconds
        self.edge_budget_chunks = edge_budget_chunks
        self.chunks: List[Chunk] = []
        self._open: Optional[Tuple[float, List[Record]]] = None
        self.spill_events = 0

    # ---------------------------------------------------------------- write
    def append(self, rec: Record) -> None:
        c0 = (rec.ts // self.chunk_seconds) * self.chunk_seconds
        if self._open is None or self._open[0] != c0:
            self._flush_open()
            self._open = (c0, [])
        self._open[1].append(rec)

    def _flush_open(self) -> None:
        if self._open is None or not self._open[1]:
            return
        t0, recs = self._open
        keys = recs[0].values.keys()
        self.chunks.append(Chunk(
            t0=t0,
            ts=np.array([r.ts for r in recs]),
            cols={k: np.array([r.values[k] for r in recs]) for k in keys}))
        self._open = None
        # edge RAM budget: oldest chunks spill to "VDC storage"
        resident = [c for c in self.chunks if not c.spilled]
        for c in resident[:-self.edge_budget_chunks]:
            if not c.spilled:
                c.spilled = True
                self.spill_events += 1

    def flush(self) -> None:
        self._flush_open()

    # ----------------------------------------------------------------- read
    def scan(self, t_lo: float, t_hi: float, col: str,
             include_spilled: bool = True) -> np.ndarray:
        """Values of `col` with t_lo <= ts < t_hi (time-ordered)."""
        self.flush()
        out = []
        for c in self.chunks:
            if c.t0 + self.chunk_seconds <= t_lo or c.t0 >= t_hi:
                continue
            if c.spilled and not include_spilled:
                continue
            m = (c.ts >= t_lo) & (c.ts < t_hi)
            out.append(c.cols[col][m])
        return np.concatenate(out) if out else np.array([])

    def count(self, t_lo: float, t_hi: float) -> int:
        return len(self.scan(t_lo, t_hi, next(iter(
            self.chunks[0].cols)) if self.chunks else "x"))

    @property
    def resident_chunks(self) -> int:
        return sum(1 for c in self.chunks if not c.spilled)
