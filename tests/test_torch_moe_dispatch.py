"""The MoE's slot map, dispatch and combine on the CPU, against the
formulation they replaced: a loop over the top-k choices that scans a
one-hot of each choice's experts for positions, writes the buffer with
``index_put`` and gathers back choice by choice.

* the slot map keeps the same (expert, position) pairs and drops the
  same choices as that loop, for random and crowded routings, the whole
  expert range and a local one, at the default capacity and at k; its
  slot→token and slot→choice maps invert the token→slot map, and
  ``base`` is each expert's count of assignments;
* ``moe_fwd``'s output, aux loss and gradients equal the loop's autograd
  within 1e-5 in fp32, with and without drops, and the backward graph
  holds no accumulating ``index_put`` and no indexing backward.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.configs import MoEConfig, get_arch
from repro_torch.kernels.moe_dispatch import slot_map
from repro_torch.models import moe as MOE

D = 64
ROUTINGS = [(4, 1), (4, 2), (32, 1), (32, 2), (32, 8)]
TOKENS = (1, 2, 3, 17, 64, 129, 300)


def loop_slots(top_e: torch.Tensor, C: int, E: int, n_local: int, e0: int):
    """The old dispatch's positions, choice by choice in GShard's order →
    ([k, T] kept slots, n_local·C where dropped; [E] assignments)."""
    T, k = top_e.shape
    base = torch.zeros(E, dtype=torch.int64)
    experts = torch.arange(E)
    slots = torch.full((k, T), n_local * C, dtype=torch.int64)
    for j in range(k):
        e_j = top_e[:, j]
        onehot = (e_j[:, None] == experts[None, :]).long()
        pos_j = (base[None, :] + onehot.cumsum(0) - 1).gather(
            1, e_j[:, None])[:, 0]
        base = base + onehot.sum(0)
        keep = (pos_j < C) & (e_j >= e0) & (e_j < e0 + n_local)
        slots[j] = torch.where(keep, (e_j - e0) * C + pos_j, n_local * C)
    return slots, base


def routing(T: int, E: int, k: int, crowd: float, g: torch.Generator):
    """k distinct experts a token, the low ids favoured by ``crowd``."""
    score = torch.rand(T, E, generator=g) + crowd * torch.linspace(1, 0, E)
    return MOE._top_k(torch.softmax(score, -1), k)[1]


@pytest.mark.parametrize("capacity", ["k", "default"])
@pytest.mark.parametrize("experts", ["all", "local"])
@pytest.mark.parametrize("E,k", ROUTINGS)
def test_slot_map_keeps_and_drops_as_the_loop(E, k, experts, capacity):
    cfg = MoEConfig(n_experts=E, top_k=k, d_ff_expert=8)
    e0, n_local = (0, E) if experts == "all" else (E // 4, E // 2)
    g = torch.Generator().manual_seed(E * 10 + k)
    dropped = 0
    for T in TOKENS:
        for crowd in (0.0, 2.0):
            C = k if capacity == "k" else MOE._capacity(T, cfg)
            top_e = routing(T, E, k, crowd, g)
            m = slot_map(top_e, C, E, n_local, e0)
            slots, base = loop_slots(top_e, C, E, n_local, e0)
            assert torch.equal(m.slot, slots.t())
            assert torch.equal(m.base, base)
            assert torch.equal(base, torch.bincount(top_e.reshape(-1),
                                                    minlength=E))
            # the slot→token and slot→choice maps invert the kept slots
            tok = torch.full((n_local * C,), T, dtype=torch.int64)
            choice = torch.full((n_local * C,), k * T, dtype=torch.int64)
            j, t = torch.nonzero(slots < n_local * C, as_tuple=True)
            assert len(set(slots[j, t].tolist())) == len(t)
            tok[slots[j, t]] = t
            choice[slots[j, t]] = t * k + j
            assert torch.equal(m.tok, tok)
            assert torch.equal(m.choice, choice)
            local = (top_e >= e0) & (top_e < e0 + n_local)
            dropped += int(local.sum()) - len(t)
    if capacity == "k":
        assert dropped > 0


def loop_moe_local(w, cfg, xf, n_local, e0):
    """The old ``_moe_local``: a k-loop of one-hot scans and
    ``index_put`` writes, and a k-loop of gathers back."""
    T, d = xf.shape
    E, k = cfg.n_experts, cfg.top_k
    dtype = xf.dtype
    C = MOE._capacity(T, cfg)
    logits = torch.einsum("td,de->te", xf, w["router"].to(dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_e = MOE._top_k(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    local = slice(e0, e0 + n_local)
    me = probs.mean(0)[local]
    buf = torch.zeros((n_local + 1, C, d), dtype=dtype)
    base = torch.zeros(E, dtype=torch.int64)
    ce = torch.zeros(n_local, dtype=torch.float32)
    experts = torch.arange(E)
    gathers = []
    for j in range(k):
        e_j = top_e[:, j]
        onehot = (e_j[:, None] == experts[None, :]).long()
        pos_j = (base[None, :] + onehot.cumsum(0) - 1).gather(
            1, e_j[:, None])[:, 0]
        base = base + onehot.sum(0)
        keep = (pos_j < C) & (e_j >= e0) & (e_j < e0 + n_local)
        ce = ce + onehot.sum(0)[local].float() / (T * k)
        el = torch.where(keep, e_j - e0, n_local)
        pc = torch.where(keep, pos_j, 0)
        buf = buf.index_put((el, pc), xf)
        gathers.append((torch.where(keep, el, 0), pc, top_p[:, j], keep))
    buf = buf[:n_local]
    gt = torch.einsum("ecd,edf->ecf", buf, w["w_gate"].to(dtype))
    u = torch.einsum("ecd,edf->ecf", buf, w["w_up"].to(dtype))
    ye = torch.einsum("ecf,efd->ecd", torch.nn.functional.silu(gt) * u,
                      w["w_down"].to(dtype))
    y = torch.zeros((T, d), dtype=dtype)
    for el, pc, p, keep in gathers:
        y = y + torch.where(keep[:, None], ye[el, pc] * p[:, None].to(dtype),
                            torch.zeros((), dtype=dtype))
    return y, E * (me * ce).sum() * cfg.aux_loss_weight


def backward_ops(*roots) -> set:
    seen, todo, names = set(), [r.grad_fn for r in roots], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def value_and_grads(fn, moe, x, r):
    x = x.clone().requires_grad_(True)
    w = {n: getattr(moe, n).detach().clone().requires_grad_(True)
         for n in MOE._WEIGHTS}
    y, aux = fn(w, x)
    ((y * r).sum() + aux).backward()
    return y.detach(), aux.detach(), {"x": x.grad, **{
        n: w[n].grad for n in MOE._WEIGHTS}}, backward_ops(y, aux)


@pytest.mark.parametrize("experts", ["all", "local"])
@pytest.mark.parametrize("capacity_factor", [1.25, 1000.0])
@pytest.mark.parametrize("moe_cfg", [
    get_arch("granite-moe-1b-a400m").reduced().moe,
    MoEConfig(n_experts=32, top_k=8, d_ff_expert=32)], ids=["e4k2", "e32k8"])
def test_gradients_match_the_loop(moe_cfg, capacity_factor, experts,
                                  monkeypatch):
    monkeypatch.setattr(MOE, "CAPACITY_FACTOR", capacity_factor)
    E = moe_cfg.n_experts
    g = torch.Generator().manual_seed(3)
    moe = MOE.MoE(g, D, moe_cfg)
    # tokens leaning toward expert 0's router column crowd it
    lean = (moe.router[:, 0] / moe.router[:, 0].norm()).detach()
    x = torch.randn(2, 48, D, generator=g) + 2.0 * lean
    r = torch.randn(2, 48, D, generator=g)
    T = 2 * 48
    if experts == "all":
        new = lambda w, x: MOE.moe_fwd(_with(moe, w), x)     # noqa: E731
        old = lambda w, x: tuple(                              # noqa: E731
            v.reshape(x.shape) if v.ndim else v
            for v in loop_moe_local(w, moe_cfg, x.reshape(T, D), E, 0))
    else:
        e0, nl = E // 4, E // 2
        part = lambda w: {n: v if n == "router" else v[e0:e0 + nl]  # noqa
                          for n, v in w.items()}
        new = lambda w, x: MOE._moe_local(                     # noqa: E731
            part(w), moe_cfg, x.reshape(T, D), nl, e0)
        old = lambda w, x: loop_moe_local(                     # noqa: E731
            part(w), moe_cfg, x.reshape(T, D), nl, e0)
        r = r.reshape(T, D)
    y1, a1, g1, ops = value_and_grads(new, moe, x, r)
    y0, a0, g0, ops0 = value_and_grads(old, moe, x, r)
    torch.testing.assert_close(y1, y0, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(a1, a0, atol=1e-5, rtol=1e-5)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-5, rtol=1e-5)
    assert not any(o.startswith(("IndexPutBackward", "IndexBackward"))
                   for o in ops), ops
    assert any(o.startswith("IndexBackward") for o in ops0)
    # drops at 1.25, none at 1000
    probs = torch.softmax(x.reshape(T, D) @ moe.router, -1)
    slots, _ = loop_slots(MOE._top_k(probs, moe_cfg.top_k)[1],
                          MOE._capacity(T, moe_cfg), E, E, 0)
    assert bool((slots == E * MOE._capacity(T, moe_cfg)).any()) == (
        capacity_factor == 1.25)


class _with:
    """The MoE module's configs and shared expert with the weights ``w``
    in its place."""

    def __init__(self, moe, w):
        self.cfg, self.routed, self.shared = moe.cfg, moe.routed, moe.shared
        for n, v in w.items():
            setattr(self, n, v)
