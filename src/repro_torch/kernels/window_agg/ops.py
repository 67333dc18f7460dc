"""Sliding-window aggregation = segment reduce (the kernel) + a combine
of window // stride consecutive segments (plain torch, as the JAX package
leaves it to XLA outside Pallas)."""
from __future__ import annotations

import torch

from repro_torch.kernels.window_agg.kernel import segment_reduce


def window_aggregate(x: torch.Tensor, *, agg: str, window: int,
                     stride: int) -> torch.Tensor:
    """x: [T, C] → [n_out, C] with out[o] = agg(x[o·stride : o·stride+window]).

    window must be a multiple of stride (the paper's queries are:
    180 s / 60 s, 120 d / 5 min). n_out = (T - window)//stride + 1.
    agg ∈ {max, min, sum, mean}. Runs where ``x`` lies: a CUDA tensor
    goes through the CUDA kernel, a CPU tensor through its plain version.
    """
    if window % stride:
        raise ValueError("window must be a multiple of stride")
    T, C = x.shape
    if T < window:
        raise ValueError("series shorter than window")
    m = window // stride
    base = "sum" if agg == "mean" else agg
    seg = segment_reduce(x.contiguous(), agg=base,
                         stride=stride)                   # [T // stride, C]

    # combine m consecutive segments per output (cheap: n_seg × C)
    n_out = (T - window) // stride + 1
    parts = seg[:n_out + m - 1].unfold(0, m, 1)           # [n_out, C, m]
    if base == "max":
        out = parts.amax(-1)
    elif base == "min":
        out = parts.amin(-1)
    else:
        out = parts.sum(-1)
    if agg == "mean":
        out = out / window
    return out
