"""Mixture-of-Experts: top-k router and capacity-bounded dispatch.

The port of the JAX package's ``models/moe.py`` on one device: tokens are
packed into a per-expert [E, C, d] buffer in GShard's sequential-choice
order, run through batched expert products, and gathered back, so that
the same tokens are dropped at the same capacity. The JAX package's
expert-parallel ``shard_map`` branch needs a mesh, which the port does
not have yet; ``moe_fwd`` is the single-device path over all experts.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import MoEConfig
from repro_torch.models.layers import _dense_init

CAPACITY_FACTOR = 1.25


class MoE(nn.Module):
    def __init__(self, generator: torch.Generator, d_model: int,
                 cfg: MoEConfig):
        super().__init__()
        g = generator
        E, F_ = cfg.n_experts, cfg.d_ff_expert
        self.cfg = cfg
        self.router = _dense_init(g, (d_model, E), d_model)
        self.w_gate = _dense_init(g, (E, d_model, F_), d_model)
        self.w_up = _dense_init(g, (E, d_model, F_), d_model)
        self.w_down = _dense_init(g, (E, F_, d_model), F_)


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(math.ceil(tokens / cfg.n_experts * cfg.top_k * CAPACITY_FACTOR))
    c = max(cfg.top_k, ((c + 3) // 4) * 4)
    return min(c, tokens * cfg.top_k)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of each row, ties to the lower index (as
    ``lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _moe_local(moe: MoE, xf: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route all tokens through all experts. xf: [T, d] → (y [T, d], aux
    loss scalar)."""
    cfg = moe.cfg
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    dtype, dev = xf.dtype, xf.device
    C = _capacity(T, cfg)

    logits = torch.einsum("td,de->te", xf, moe.router.to(dtype))
    probs = torch.softmax(logits.float(), dim=-1)              # [T, E]
    top_p, top_e = _top_k(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True)

    # load-balance aux loss (Switch): E · Σ_e f_e · p̄_e
    me = probs.mean(0)                                         # [E]

    # sequential-choice positions within each expert (GShard order)
    buf = torch.zeros((E, C, d), dtype=dtype, device=dev)
    base = torch.zeros(E, dtype=torch.int64, device=dev)
    ce = torch.zeros(E, dtype=torch.float32, device=dev)
    experts = torch.arange(E, device=dev)
    gathers = []
    for j in range(k):
        e_j = top_e[:, j]                                      # [T]
        onehot = (e_j[:, None] == experts[None, :]).long()     # [T, E]
        pos_full = base[None, :] + onehot.cumsum(0) - 1
        base = base + onehot.sum(0)
        pos_j = pos_full.gather(1, e_j[:, None])[:, 0]
        keep = pos_j < C
        ce = ce + onehot.sum(0).float() / (T * k)
        # a kept (expert, position) is taken by one token only
        buf[e_j[keep], pos_j[keep]] = xf[keep]
        gathers.append((torch.where(keep, e_j, 0),
                        torch.where(keep, pos_j, 0), top_p[:, j], keep))

    g = torch.einsum("ecd,edf->ecf", buf, moe.w_gate.to(dtype))
    u = torch.einsum("ecd,edf->ecf", buf, moe.w_up.to(dtype))
    ye = torch.einsum("ecf,efd->ecd", F.silu(g) * u,
                      moe.w_down.to(dtype))                    # [E, C, d]

    y = torch.zeros((T, d), dtype=dtype, device=dev)
    for el, pc, w, keep in gathers:
        contrib = ye[el, pc]                                   # [T, d]
        y = y + torch.where(keep[:, None], contrib * w[:, None].to(dtype),
                            torch.zeros((), dtype=dtype, device=dev))

    aux = E * (me * ce).sum() * cfg.aux_loss_weight
    return y, aux


def moe_fwd(moe: MoE, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] → (y, aux_loss), every expert on this device."""
    B, S, d = x.shape
    y, aux = _moe_local(moe, x.reshape(B * S, d))
    return y.reshape(B, S, d), aux
