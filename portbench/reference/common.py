"""Plain PyTorch pieces that every reference model shares: the products
(exact float32, or the lower-precision control), norms, rotary
positions, attention, the tied logits, the loss and AdamW.

Nothing here imports the program under test. A configuration is the
dict read from ``portbench/configs/<name>.json``; parameters are a dict
name -> tensor under the names and layouts that file's family gives
(``reference/<family>.py``). Float32 products run with TF32 off: a
float32 product on the card would otherwise round its operands to TF32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]



def exact_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


FP8 = {"fp8_e4m3": torch.float8_e4m3fn, "fp8_e5m2": torch.float8_e5m2}


def fp8_round(t: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the float8 type ``fmt`` under one scale for the
    whole tensor (its largest magnitude to the type's largest), as a
    per-tensor scaled fp8 product reads its operands; back in t's type.
    A straight-through estimator in autograd."""
    big = torch.finfo(fmt).max
    scale = t.detach().abs().amax().clamp(min=1e-30) / big
    q = (t.detach() / scale).to(fmt).to(t.dtype) * scale
    return t + (q - t.detach())


class _GradFp8(torch.autograd.Function):
    """Identity forward; the incoming gradient rounded as ``fp8_round``
    rounds, as an fp8 backward reads it."""

    @staticmethod
    def forward(ctx, t, fmt):
        ctx.fmt = fmt
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, ctx.fmt), None


class Products:
    """The products of a reference: ``mm(equation, a, b)``. ``"fp32"`` is
    the exact reference; ``"fp8_e4m3"`` and ``"fp8_e5m2"`` round both
    operands of every projection and of the logits to per-tensor scaled
    float8 of that format, sum the product in float32, and in the
    backward round the product's incoming gradient to the same format.
    They are the step below the configuration's bf16, which the
    benchmark's controls put in the program's place: a cell's limits
    have to fail both."""

    def __init__(self, precision: str = "fp32"):
        if precision != "fp32" and precision not in FP8:
            raise ValueError(f"precision must be fp32 or one of "
                             f"{sorted(FP8)}, got {precision!r}")
        self.fmt = FP8.get(precision)

    def __call__(self, eq: str, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
        if self.fmt is not None:
            return _GradFp8.apply(torch.einsum(eq, fp8_round(a, self.fmt),
                                               fp8_round(b, self.fmt)),
                                  self.fmt)
        return torch.einsum(eq, a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..S-1 on x [B, S, heads, d]: the first and the
    second half of each head rotated as pairs."""
    S, d = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Softmax attention of q [B, S, H, d] over k, v [B, S, KV, d], query
    head h reading key head h // (H / KV), each query seeing the keys at
    and before its position."""
    B, S, H, d = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def logits(cfg: dict, p: Params, h: torch.Tensor,
           mm: Products) -> torch.Tensor:
    """The final norm, then the tied unembedding over the real
    vocabulary (the padded rows are never a token): [B, S, V] float32."""
    h = rmsnorm(h, p["final_norm.scale"], cfg["norm_eps"])
    return mm("bsd,vd->bsv", h, p["embed"][:cfg["vocab_size"]])


def cross_entropy(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over every position."""
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1))


def checkpointed(fn: Callable, *args):
    """``fn(*args)``, its activations recomputed in the backward when
    autograd records (so that a full-depth fp32 step fits the card)."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# The optimizer: clipping by global norm, the warmup-cosine schedule, AdamW
# ---------------------------------------------------------------------------
def learning_rate(step: int, opt: dict) -> float:
    """Linear warmup to ``peak_lr`` over ``warmup_steps`` (step s gets
    (s + 1) / warmup of it), then a cosine to ``final_lr_frac`` of it at
    ``total_steps``. ``step`` counts from 0."""
    peak, warm, total = opt["peak_lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return peak * min(1.0, (step + 1) / max(1, warm))
    t = min(1.0, max(0.0, (step - warm) / max(1, total - warm)))
    frac = opt["final_lr_frac"]
    return peak * (frac + (1 - frac) * 0.5 * (1 + math.cos(math.pi * t)))


class AdamW:
    """AdamW with decoupled weight decay over float32 tensors:
    m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
    p -= lr ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p)."""

    def __init__(self, params: Params, opt: dict):
        self.opt, self.t = opt, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: Params, grads: Params, lr: float) -> None:
        o = self.opt
        b1, b2, eps, wd = o["b1"], o["b2"], o["eps"], o["weight_decay"]
        self.t += 1
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in params.items():
            g, m, v = grads[k], self.m[k], self.v[k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (m / bc1) / ((v / bc2).sqrt() + eps) + wd * p
            p.sub_(lr * upd)


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    total = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    scale = min(1.0, max_norm / (float(total) + 1e-9))
    return {k: g * scale for k, g in grads.items()}


def leaf_norms(tensors: Params, names: List[str]) -> torch.Tensor:
    """The float64 norm of each named tensor, in ``names``' order."""
    return torch.stack([tensors[n].double().norm() for n in names])


def moe_capacity(tokens: int, moe: dict) -> int:
    """Slots per expert for ``tokens`` routed together: ceil(tokens / E ·
    k · capacity_factor) rounded up to a multiple of 4, at least k and at
    most tokens · k."""
    E, k = moe["n_experts"], moe["top_k"]
    c = int(math.ceil(tokens / E * k * moe["capacity_factor"]))
    c = max(k, ((c + 3) // 4) * 4)
    return min(c, tokens * k)


def moe_layer(moe: dict, p: Params, pre: str, x: torch.Tensor,
              mm: Products):
    """A top-k MoE over the tokens of x [T, d] routed together (one
    capacity group) -> (y [T, d], aux loss). Each token takes the k
    experts of highest router probability (ties to the lower index) with
    the probabilities renormalised over the k; expert e takes at most
    ``moe_capacity(T)`` assignments, in GShard's order (all first
    choices in token order, then all second choices, ...), and drops the
    rest. The aux loss is E · sum_e mean_prob_e · assigned_share_e ·
    aux_loss_weight, over every assignment, dropped or not."""
    T, d = x.shape
    E, k = moe["n_experts"], moe["top_k"]
    probs = torch.softmax(mm("td,de->te", x, p[pre + "router"]), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    order = top_e.t().reshape(-1)                      # (choice, token)
    onehot = F.one_hot(order, E)
    pos = (onehot.cumsum(0) - 1).gather(1, order[:, None])[:, 0]
    keep = pos < moe_capacity(T, moe)
    token = torch.arange(k * T, device=x.device) % T
    weight = top_p.t().reshape(-1)
    y = torch.zeros_like(x)
    for e in range(E):
        sel = torch.nonzero((order == e) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        xe = x[token[sel]]
        h = (F.silu(mm("td,df->tf", xe, p[pre + "w_gate"][e]))
             * mm("td,df->tf", xe, p[pre + "w_up"][e]))
        out = mm("tf,fd->td", h, p[pre + "w_down"][e])
        y = y.index_add(0, token[sel], out * weight[sel, None])
    share = onehot.sum(0).float() / (T * k)
    aux = E * (probs.mean(0) * share).sum() * moe["aux_loss_weight"]
    return y, aux


def group_positions(S: int, groups: Optional[List[int]]) -> List[slice]:
    """The positions 0..S-1 cut at ``groups`` (the positions where a new
    forward call of the program starts: the prompt, then each decode
    step), as slices; None is one group."""
    cuts = [0] + list(groups or []) + [S]
    return [slice(a, b) for a, b in zip(cuts[:-1], cuts[1:]) if b > a]
