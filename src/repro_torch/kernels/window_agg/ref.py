"""Plain loop oracle for sliding-window aggregation (torch)."""
from __future__ import annotations

import torch


def window_aggregate_reference(x: torch.Tensor, *, agg: str, window: int,
                               stride: int) -> torch.Tensor:
    T, C = x.shape
    n_out = (T - window) // stride + 1
    reduce = {"max": torch.amax, "min": torch.amin, "sum": torch.sum,
              "mean": torch.mean}[agg]
    outs = [reduce(x[o * stride: o * stride + window].float(), 0)
            for o in range(n_out)]
    return torch.stack(outs).to(x.dtype)
