"""Sliding-window aggregation = segment reduce (the kernel) + a combine
of window // stride consecutive segments (plain torch, as the JAX package
leaves it to XLA outside Pallas).

``window_aggregate`` is the custom op ``repro_torch::window_aggregate``,
so ``torch.utils.flop_counter.FlopCounterMode`` counts it by its FLOP
formula, not by what it runs inside. Under ``FakeTensorMode`` it gives an
empty tensor of the output's shape; on DTensors it runs on the local
shards under ``window_sharding``'s rule."""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import sharding_rules
from repro_torch.kernels.window_agg.kernel import segment_reduce


@torch.library.custom_op("repro_torch::window_aggregate", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _window_aggregate(x: torch.Tensor, agg: str, window: int,
                      stride: int) -> torch.Tensor:
    T, C = x.shape
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


@_window_aggregate.register_fake
def _(x, agg, window, stride):
    T, C = x.shape
    return x.new_empty(((T - window) // stride + 1, C))


def window_sharding(x, agg, window, stride):
    """Per mesh dim: replicated; columns split (each column is its own
    series); rows split only where each window is one segment (window ==
    stride) and, by ``_window_valid``, every shard holds whole segments."""
    r = Replicate()
    out = [([r], [r, None, None, None]),
           ([Shard(1)], [Shard(1), None, None, None])]
    if window == stride:
        out.append(([Shard(0)], [Shard(0), None, None, None]))
    return out


def _window_valid(specs, args) -> bool:
    x, stride = specs[0], args[3]
    n = sharding_rules.shard_count(x, 0)
    return n == 1 or (x.shape[0] % n == 0
                      and (x.shape[0] // n) % stride == 0)


sharding_rules.register([torch.ops.repro_torch.window_aggregate.default],
                        window_sharding, _window_valid)


@register_flop_formula(torch.ops.repro_torch.window_aggregate)
def _flops(x_shape, agg, window, stride, *args, **kwargs) -> int:
    """The function's work: one compare or add per row of the segment
    pass (n_seg·stride·C, which is T·C when stride divides T), m − 1 per
    output for the combine ((m − 1)·n_out·C), and one divide per output
    for the mean (n_out·C)."""
    T, C = x_shape
    m = window // stride
    n_out = (T - window) // stride + 1
    flops = (T // stride) * stride * C + (m - 1) * n_out * C
    return flops + (n_out * C if agg == "mean" else 0)


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
    if x.shape[0] < window:
        raise ValueError("series shorter than window")
    return torch.ops.repro_torch.window_aggregate(x, agg, window, stride)
