"""Mixture-of-Experts: top-k router and capacity-bounded dispatch.

The port of the JAX package's ``models/moe.py``: tokens are packed into a
per-expert [E, C, d] buffer in GShard's sequential-choice order, run
through batched expert products, and gathered back, so that the same
tokens are dropped at the same capacity. One slot map (token → slot and
its inverse, ``kernels/moe_dispatch``) carries the dispatch, the combine
and both of their backwards as gathers: no scatter accumulates anywhere.

Expert parallelism is explicit, as in the JAX package: when a mesh with a
"model" axis that divides the experts is active
(``repro_torch.sharding.current_mesh``), each rank of the "model" axis
routes all of its data shard's tokens, packs and runs only its own
E / m experts, and the partial outputs are summed over "model" (the EP
all-reduce). The sum is a DTensor ``Partial`` placement, so its gradient
is the output's, on every rank. Without a mesh the same local function
runs over all experts.

A layer may hold only a share of the experts its router scores (one
chip's share of an expert-parallel deployment; ``ArchConfig``'s
``routed_experts``): it routes over all of them, computes its own, and
what the absent ones would add is left out. A shared expert
(``shared_expert_ff``), a SwiGLU every token passes through, is added to
the routed part once, outside any sum over the "model" axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import tracing
from repro_torch.configs import MoEConfig
from repro_torch.kernels.moe_dispatch import (gather_dot, gather_rows,
                                             gather_sum, slot_map)
from repro_torch.models.layers import MLP, _dense_init, cast, mlp_axes

CAPACITY_FACTOR = 1.25


class MoE(nn.Module):
    """The experts held here (``cfg.n_experts``: the first ones), the
    router over all ``routed`` (0: those held) and, with ``shared_ff``,
    the shared expert ``shared``. ``routed`` is ``cfg`` with the routed
    count as its ``n_experts``, as ``_moe_local`` reads it."""

    def __init__(self, generator: torch.Generator, d_model: int,
                 cfg: MoEConfig, routed: int = 0, shared_ff: int = 0):
        super().__init__()
        g = generator
        E, F_ = cfg.n_experts, cfg.d_ff_expert
        self.cfg = cfg
        self.routed = (dataclasses.replace(cfg, n_experts=routed)
                       if routed and routed != E else cfg)
        self.router = _dense_init(g, (d_model, self.routed.n_experts),
                                  d_model)
        self.w_gate = _dense_init(g, (E, d_model, F_), d_model)
        self.w_up = _dense_init(g, (E, d_model, F_), d_model)
        self.w_down = _dense_init(g, (E, F_, d_model), F_)
        self.shared = MLP(g, d_model, shared_ff) if shared_ff else None


def moe_axes(shared: bool = False):
    ax = {
        "router": ("embed", None),
        "w_gate": ("experts", "embed", None),
        "w_up": ("experts", "embed", None),
        "w_down": ("experts", None, "embed"),
    }
    if shared:
        ax["shared"] = mlp_axes()
    return ax


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    c = int(math.ceil(tokens / cfg.n_experts * cfg.top_k * CAPACITY_FACTOR))
    c = max(cfg.top_k, ((c + 3) // 4) * 4)
    return min(c, tokens * cfg.top_k)


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of each row, ties to the lower index (as
    ``lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as contiguous rows [..., d] → [N, d]."""
    return t.reshape(-1, t.shape[-1]).contiguous()


class _Dispatch(torch.autograd.Function):
    """buf[s] = x[tok[s]], zero in an empty slot. The gradient is a
    gather too: dx[t] = Σ_j dbuf[slot[t, j]] over the kept choices."""

    @staticmethod
    def forward(ctx, x, tok, slot):
        ctx.save_for_backward(slot)
        return gather_rows(_rows(x), tok)

    @staticmethod
    def backward(ctx, dbuf):
        (slot,) = ctx.saved_tensors
        return gather_sum(_rows(dbuf), slot), None, None


class _Combine(torch.autograd.Function):
    """y[t] = Σ_j p[t, j] · ye[slot[t, j]] over the kept choices. The
    gradient goes back through the inverse map, by gathers:
    dye[s] = p[choice[s]] · dy[tok[s]] (p flat) and
    dp[t, j] = ⟨dy[t], ye[slot[t, j]]⟩, zero where dropped."""

    @staticmethod
    def forward(ctx, ye, p, slot, tok, choice):
        p = p.contiguous()
        ctx.save_for_backward(ye, p, slot, tok, choice)
        return gather_sum(_rows(ye), slot, p)

    @staticmethod
    def backward(ctx, dy):
        ye, p, slot, tok, choice = ctx.saved_tensors
        dy = dy.contiguous()
        dye = gather_rows(dy, tok, p.view(-1), choice).view(ye.shape)
        return dye, gather_dot(_rows(ye), slot, dy), None, None, None


def _moe_local(w: Dict[str, torch.Tensor], cfg: MoEConfig,
               xf: torch.Tensor, n_local: int, e0: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route all tokens over ``cfg.n_experts`` experts, compute only
    experts [e0, e0 + n_local), whose weights are ``w["w_gate"]`` etc.
    ([n_local, ...]; ``w["router"]`` is the whole router). xf: [T, d] →
    (partial y [T, d], the aux loss's part over those experts)."""
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    dtype = xf.dtype
    C = _capacity(T, cfg)

    with tracing.span("moe.route") as sp:
        logits = torch.einsum("td,de->te", sp.input(xf),
                              cast(w["router"], dtype))
        probs = torch.softmax(logits.float(), dim=-1)          # [T, E]
        top_p, top_e = _top_k(probs, k)
        top_p = sp.output(top_p / top_p.sum(-1, keepdim=True))

        # load-balance aux loss (Switch): E · Σ_e f_e · p̄_e, over the
        # local experts; the sum over the "model" axis restores the whole
        local = slice(e0, e0 + n_local)
        me = probs.mean(0)[local]                              # [n_local]

    # each choice's slot and each slot's token, in GShard order; the
    # buffer is filled by one gather, an empty slot with zeros
    with tracing.span("moe.dispatch") as sp:
        xd = sp.input(xf)
        m = slot_map(top_e, C, E, n_local, e0)
        buf = sp.output(_Dispatch.apply(xd, m.tok, m.slot).view(n_local, C, d))
    # every expert's assignments (base): those past C at a local expert
    # are the dropped ones
    tracing.count("moe.expert_load", m.base, capacity=C, assignments=T * k,
                  first=e0, experts=n_local)
    ce = m.base[local].float() / (T * k)

    with tracing.span("moe.experts") as sp:
        xe = sp.input(buf)
        g = torch.einsum("ecd,edf->ecf", xe, cast(w["w_gate"], dtype))
        u = torch.einsum("ecd,edf->ecf", xe, cast(w["w_up"], dtype))
        ye = sp.output(torch.einsum("ecf,efd->ecd", F.silu(g) * u,
                                    cast(w["w_down"], dtype)))  # [nl, C, d]

    with tracing.span("moe.combine") as sp:
        yc = sp.input(ye)
        y = sp.output(_Combine.apply(yc, top_p, m.slot, m.tok, m.choice))

    aux = E * (me * ce).sum() * cfg.aux_loss_weight
    return y, aux


_WEIGHTS = ("router", "w_gate", "w_up", "w_down")


def moe_fwd(moe: MoE, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, d] → (y, aux_loss). Expert-parallel over the mesh "model"
    axis when one is active and divides the held experts; tokens stay
    sharded over the data axes. The shared expert, if any, is the
    ``moe.shared`` span."""
    from repro_torch import sharding as shd

    B, S, d = x.shape
    E = moe.cfg.n_experts
    mesh = shd.current_mesh()
    names = mesh.mesh_dim_names if mesh is not None else ()
    if "model" not in names or E % mesh.size(names.index("model")):
        w = {k: getattr(moe, k) for k in _WEIGHTS}
        if mesh is None:
            y, aux = _moe_local(w, moe.routed, x.reshape(B * S, d), E, 0)
            y = y.reshape(B, S, d)
        else:
            y, aux = _moe_gathered(w, moe.routed, E, x, mesh)
    else:
        y, aux = _moe_expert_parallel(moe, x, mesh)
    if moe.shared is not None:
        with tracing.span("moe.shared") as sp:
            ys = sp.output(moe.shared(sp.input(x)))
        y = y + ys
    return y, aux


def _as_dtensor(t: torch.Tensor, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _moe_gathered(w, cfg: MoEConfig, held: int, x: torch.Tensor, mesh):
    """A mesh whose "model" axis does not divide the held experts: every
    rank routes all tokens through all ``held`` experts (the JAX package
    leaves this case to its partitioner, over the global tokens), and
    keeps its shard of y."""
    from torch.distributed.tensor import DTensor, Replicate
    B, S, d = x.shape
    xd = _as_dtensor(x, mesh)
    full = {k: _as_dtensor(v, mesh).full_tensor() for k, v in w.items()}
    y, aux = _moe_local(full, cfg, xd.full_tensor().reshape(B * S, d),
                        held, 0)
    rep = [Replicate()] * mesh.ndim
    y = DTensor.from_local(y.reshape(B, S, d), mesh, rep, run_check=False)
    aux = DTensor.from_local(aux, mesh, rep, run_check=False)
    if not isinstance(x, DTensor):
        return y.to_local(), aux.to_local()
    return y.redistribute(mesh, xd.placements), aux


def _moe_expert_parallel(moe: MoE, x: torch.Tensor, mesh):
    """Each rank of "model" runs held experts [idx·E/m, (idx + 1)·E/m) on
    its data shard's tokens; y and aux are ``Partial`` over "model" (summed
    where they are read). The local weights and tokens take ``Partial``
    gradients over the axes whose ranks read them with different tokens
    or experts. aux is each data shard's, averaged over the data axes
    (the JAX package's keeps one shard's)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch import sharding as shd

    B, S, d = x.shape
    names = list(mesh.mesh_dim_names)
    mi = names.index("model")
    n_local = moe.cfg.n_experts // mesh.size(mi)
    idx = mesh.get_local_rank("model")
    b_ax = shd.batch_axes_for(mesh, B)
    b_names = () if b_ax is None else (
        b_ax if isinstance(b_ax, tuple) else (b_ax,))
    x_pl = shd.placements_for(mesh, shd.P(b_ax, None, None), 3)
    xd = _as_dtensor(x, mesh).redistribute(mesh, x_pl)
    # the gradient of a rank's local copy: partial over "model" (each
    # rank's experts) and over the data axes that split the tokens
    partial_over = {mi} | {names.index(a) for a in b_names}
    x_grad = [Partial() if i == mi else p for i, p in enumerate(x_pl)]
    xl = xd.to_local(grad_placements=x_grad)

    w = {}
    for k in _WEIGHTS:
        spec = shd.P() if k == "router" else shd.P("model")
        pl = shd.placements_for(mesh, spec, getattr(moe, k).ndim)
        wd = _as_dtensor(getattr(moe, k), mesh).redistribute(mesh, pl)
        grad = [Partial() if i in partial_over and not isinstance(p, Shard)
                else p for i, p in enumerate(pl)]
        w[k] = wd.to_local(grad_placements=grad)

    Bl = xl.shape[0]
    y, aux = _moe_local(w, moe.routed, xl.reshape(Bl * S, d), n_local,
                        idx * n_local)
    y_pl = [Partial() if i == mi else p for i, p in enumerate(x_pl)]
    # the mean over the data shards as a sum of each shard's aux / n (a
    # Partial("avg") would take the whole gradient on every shard)
    n_data = 1
    for a in b_names:
        n_data *= mesh.size(names.index(a))
    aux_pl = [Partial() if i == mi or names[i] in b_names else Replicate()
              for i in range(mesh.ndim)]
    y = DTensor.from_local(y.reshape(Bl, S, d), mesh, y_pl, run_check=False)
    aux = DTensor.from_local(aux / n_data, mesh, aux_pl, run_check=False)
    if not isinstance(x, DTensor):
        rep = [Replicate()] * mesh.ndim
        return (y.redistribute(mesh, rep).to_local(),
                aux.redistribute(mesh, rep).to_local())
    return y, aux
