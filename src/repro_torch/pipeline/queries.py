"""The paper's use-case queries (§3) and the just-in-time edge→VDC offload.

  Q1: EVERY 60 s compute the MAX of download_speed over the last 3 min
      FROM cassandra series speedtests AND streaming queue neubotspeed
  Q2: EVERY 5 min compute the MEAN of download_speed over the last 120 d
      FROM the same sources

Both mash a post-mortem store range with the live stream. The
HybridExecutor is the paper's "services interact with the VDC underlying
services only when the process needs more resources": windows whose record
count fits the edge budget aggregate in the service loop (NumPy on host);
larger windows offload to the VDC — here the CUDA card, through the
window_agg kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.window_agg import window_aggregate
from repro_torch.kernels.window_agg.kernel import INIT
from repro_torch.pipeline.operators import WindowSpec, aggregate
from repro_torch.pipeline.service import ServiceConfig, StreamService
from repro_torch.pipeline.store import TimeSeriesStore
from repro_torch.pipeline.streams import Broker

EDGE_WINDOW_BUDGET = 100_000  # records an edge service may aggregate inline
FOLD_COLS = 128               # the offload folds a window into [rows, 128]


def neubot_query_1(broker: Broker, store: TimeSeriesStore) -> StreamService:
    return StreamService(ServiceConfig(
        name="q1_max_speed", queue="neubotspeed", column="download_speed",
        agg="max", window=WindowSpec("sliding", width_s=180.0, slide_s=60.0),
        store=store), broker)


def neubot_query_2(broker: Broker, store: TimeSeriesStore) -> StreamService:
    return StreamService(ServiceConfig(
        name="q2_mean_speed", queue="neubotspeed", column="download_speed",
        agg="mean",
        window=WindowSpec("sliding", width_s=120 * 86400.0, slide_s=300.0),
        store=store), broker)


@dataclasses.dataclass
class OffloadDecision:
    offload: bool
    n_records: int
    reason: str


class HybridExecutor:
    """Runs a service's window either on the edge (numpy on the host) or
    on the VDC path (``device``: the card unless ``device="cpu"``)."""

    def __init__(self, edge_budget: int = EDGE_WINDOW_BUDGET,
                 device: DeviceLike = None):
        self.edge_budget = edge_budget
        self.device = resolve_device(device)
        self.offloads = 0
        self.edge_runs = 0

    def decide(self, n_records: int) -> OffloadDecision:
        if n_records <= self.edge_budget:
            return OffloadDecision(False, n_records,
                                   f"fits edge budget ({self.edge_budget})")
        return OffloadDecision(True, n_records,
                               "window exceeds edge compute/RAM — VDC JIT")

    def run_window(self, values, agg: str) -> float:
        """Aggregate one window (``max``, ``min``, ``sum``, ``mean`` or
        ``count``; an offloaded ``count`` launches nothing). ``values`` is a 1-D numpy array
        or tensor; a float32 tensor already on the device is used as it
        is."""
        d = self.decide(len(values))
        if not d.offload:
            self.edge_runs += 1
            if isinstance(values, torch.Tensor):
                values = values.cpu().numpy()
            return aggregate(values, agg)
        self.offloads += 1
        if agg == "count":
            # a count needs no values, so nothing crosses to the device
            # and no kernel runs: the edge path's answer, len(values).
            # (The JAX package has no count kernel: its offloaded count
            # raises KeyError looking up INIT["count"].)
            return float(len(values))
        # VDC path: fold the 1-D range into 128 columns so the segment
        # kernel reduces rows in parallel, then combine the 128 partials.
        # The values cross to the device once; the fold's padding is
        # written there.
        base = "sum" if agg == "mean" else agg
        n = len(values)
        rows = -(-n // FOLD_COLS)
        src = torch.as_tensor(values)
        if (src.device == self.device and src.dtype == torch.float32
                and n == rows * FOLD_COLS and src.is_contiguous()):
            x = src
        else:
            if src.device.type == "cpu" and src.dtype != torch.float32:
                src = src.float()         # cast on the host: ship 4 B/value
            x = torch.empty(rows * FOLD_COLS, dtype=torch.float32,
                            device=self.device)
            x[:n].copy_(src)
            x[n:].fill_(INIT[base])
        seg = window_aggregate(x.view(rows, FOLD_COLS), agg=base, window=rows,
                               stride=rows)[0]                  # [128]
        if agg == "max":
            return float(seg.amax())
        if agg == "min":
            return float(seg.amin())
        total = float(seg.sum())
        return total / n if agg == "mean" else total
