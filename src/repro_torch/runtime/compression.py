"""Gradient compression for the slow inter-pod all-reduce.

The port of the JAX package's ``runtime/compression.py``. Two composable
schemes with error feedback (residual carry, Karimireddy et al. '19
style):
  - int8 uniform quantization (4× over fp32, 2× over bf16)
  - top-k sparsification (magnitude), k as a fraction

``compressed_allreduce`` wires them around the mean over a process group
(the JAX package's ``pmean`` inside ``shard_map``): an all-reduce SUM
divided by the group's size, since gloo has no AVG. Rounding is half to
even in both packages (``jnp.round``, ``torch.round``), so int8 codes
match bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist


# ---------------------------------------------------------------- int8
def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


# ---------------------------------------------------------------- top-k
def topk_compress(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the top `frac` fraction by magnitude (dense mask form: the
    wire format would transmit (indices, values); the mask form keeps the
    math identical)."""
    flat = x.reshape(-1)
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    return torch.where(torch.abs(x) >= thresh, x, torch.zeros_like(x))


# ------------------------------------------------------- error feedback
@dataclasses.dataclass
class ErrorFeedbackState:
    residual: Any

    @classmethod
    def init(cls, tree: Dict[str, torch.Tensor]):
        return cls(residual={k: torch.zeros(x.shape, dtype=torch.float32,
                                            device=x.device)
                             for k, x in tree.items()})


def _sent(gf: torch.Tensor, scheme: str, topk_frac: float) -> torch.Tensor:
    if scheme == "int8":
        return decompress_int8(*compress_int8(gf))
    if scheme == "topk":
        return topk_compress(gf, topk_frac)
    if scheme == "int8+topk":
        return decompress_int8(*compress_int8(topk_compress(gf, topk_frac)))
    return gf


def compressed_allreduce(grads: Dict[str, torch.Tensor],
                         ef: ErrorFeedbackState, group=None, *,
                         scheme: str = "int8", topk_frac: float = 0.05):
    """The mean of ``grads`` over ``group`` (the default group if None),
    each rank sending its compressed gradient plus its residual, keeping
    what compression dropped as its next residual. Every rank of the
    group calls it. Returns (mean_grads, new_ef)."""
    n = dist.get_world_size(group)
    out, res = {}, {}
    for k, g in grads.items():
        gf = g.to(torch.float32) + ef.residual[k]
        sent = _sent(gf, scheme, topk_frac)
        res[k] = gf - sent
        total = sent.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        out[k] = (total / n).to(g.dtype)
    return out, ErrorFeedbackState(residual=res)
