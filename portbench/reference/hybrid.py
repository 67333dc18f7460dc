"""The plain reference of the ``hybrid`` family: IBM Granite 4.0-H
(``granitemoehybrid``). Each layer is a pre-norm mixer with a residual,
then a pre-norm mixture of experts with a residual; the mixer is
Mamba-2 (``reference/ssm.py``'s mixer, with the convolution's bias where
``mamba_conv_bias`` is true) or grouped-query attention without
positional encoding, as the configuration's ``layer_types`` give them
for the first ``n_layers`` layers. The muP multipliers scale the
embedded tokens (``embedding_multiplier``), each residual branch
(``residual_multiplier``) and attention's scores
(``attention_multiplier``, the softmax scale); the logits are
``reference/common.py``'s, unscaled, so ``logits_scaling`` has to be 1.
Tied embeddings. Float32, no kernels, no cache.

The MoE is one chip's share of an expert-parallel layer: the router
scores all ``moe.routed_experts`` experts and each token takes its
``top_k`` (ties to the lower index), the probabilities renormalised over
the k; each expert takes at most ``capacity(T)`` assignments (over the
routed count) in GShard's order; only the first ``moe.n_experts``
experts are held and computed, and what the others would add is left
out. A shared SwiGLU expert of width ``moe.shared_ff`` is added for
every token. The aux loss is the held experts' part of the Switch loss,
routed · Σ_{e held} mean_prob_e · assigned_share_e · aux_loss_weight.
As in ``reference/moe.py``, ``hidden`` routes the positions of each
forward call of the program together (``groups``).

Parameter names and layouts: ``embed`` [V, D], ``final_norm.scale``, and
for layer i ``blocks.i.ln1.scale``; a Mamba-2 layer's ``blocks.i.ssm.*``
as in ``reference/ssm.py``, and with the bias ``conv_x_bias`` [d_inner]
and ``conv_BC_bias`` [2·G·N]; an attention layer's ``blocks.i.attn.wq``
[D, H, d], ``wk``, ``wv`` [D, KV, d], ``wo`` [H, d, D]; then
``blocks.i.ln2.scale``, ``blocks.i.moe.router`` [D, routed],
``w_gate``, ``w_up`` [held, D, F], ``w_down`` [held, F, D] and
``blocks.i.moe.shared.w_gate``, ``shared.w_up`` [D, Fs],
``shared.w_down`` [Fs, D].
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from portbench.reference import common as R
from portbench.reference import ssm as SSM

Q_BLOCK = 1024        # queries a block of the attention (memory, not math)
_EXPERT = ("w_gate", "w_up", "w_down")


def mixers(cfg: dict) -> List[str]:
    """Each layer's mixer, "attention" or "mamba"."""
    return list(cfg["layer_types"][:cfg["n_layers"]])


def param_spec(cfg: dict) -> list:
    """[(name, shape, init)] as ``reference/ssm.py`` gives them; every
    projection N(0, 1/fan-in)."""
    D, V, K = cfg["d_model"], cfg["padded_vocab"], cfg["ssm"]["d_conv"]
    H, KV, d = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    din, Hs, G, N = SSM.sizes(cfg)
    m = cfg["moe"]
    E, R_, F_, Fs = (m["n_experts"], m["routed_experts"], m["d_ff_expert"],
                     m["shared_ff"])
    spec = [("embed", (V, D), ("embed",)),
            ("final_norm.scale", (D,), ("ones",))]
    for i, mixer in enumerate(mixers(cfg)):
        b = f"blocks.{i}."
        spec.append((b + "ln1.scale", (D,), ("ones",)))
        if mixer == "attention":
            spec += [(b + "attn.wq", (D, H, d), ("normal", D)),
                     (b + "attn.wk", (D, KV, d), ("normal", D)),
                     (b + "attn.wv", (D, KV, d), ("normal", D)),
                     (b + "attn.wo", (H, d, D), ("normal", H * d))]
        else:
            s = b + "ssm."
            spec += [(s + "w_z", (D, din), ("normal", D)),
                     (s + "w_x", (D, din), ("normal", D)),
                     (s + "w_B", (D, G * N), ("normal", D)),
                     (s + "w_C", (D, G * N), ("normal", D)),
                     (s + "w_dt", (D, Hs), ("normal", D)),
                     (s + "conv_x", (K, din), ("normal", K)),
                     (s + "conv_BC", (K, 2 * G * N), ("normal", K)),
                     *([(s + "conv_x_bias", (din,), ("normal", K)),
                        (s + "conv_BC_bias", (2 * G * N,), ("normal", K))]
                       if cfg["mamba_conv_bias"] else []),
                     (s + "A_log", (Hs,), ("a_log",)),
                     (s + "dt_bias", (Hs,), ("dt_bias",)),
                     (s + "D", (Hs,), ("ones",)),
                     (s + "norm", (din,), ("ones",)),
                     (s + "out_proj", (din, D), ("normal", din))]
        e = b + "moe."
        spec += [(b + "ln2.scale", (D,), ("ones",)),
                 (e + "router", (D, R_), ("normal", D)),
                 (e + "w_gate", (E, D, F_), ("normal", D)),
                 (e + "w_up", (E, D, F_), ("normal", D)),
                 (e + "w_down", (E, F_, D), ("normal", F_)),
                 (e + "shared.w_gate", (D, Fs), ("normal", D)),
                 (e + "shared.w_up", (D, Fs), ("normal", D)),
                 (e + "shared.w_down", (Fs, D), ("normal", Fs))]
    return spec


def _causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            start: int, scale: float) -> torch.Tensor:
    """Softmax attention of the queries at positions start.. (q [B, Sq, H,
    d]) over the keys at positions 0.. (k, v [B, Sk, KV, d]) with scores
    q·k × ``scale``, query head h reading key head h // (H / KV), each
    query seeing the keys at and before its position; no positional
    encoding."""
    B, Sq, H, d = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    pos_q = start + torch.arange(Sq, device=q.device)
    seen = torch.arange(k.shape[1], device=q.device)[None, :] <= pos_q[:, None]
    p = torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attention(cfg: dict, p: R.Params, pre: str, x: torch.Tensor,
              mm: R.Products) -> torch.Tensor:
    """NoPE grouped-query attention over x [B, S, D] at the softmax scale
    ``attention_multiplier``, the queries in blocks of ``Q_BLOCK``, each
    recomputed in the backward."""
    q = mm("bsd,dhk->bshk", x, p[pre + "wq"])
    k = mm("bsd,dhk->bshk", x, p[pre + "wk"])
    v = mm("bsd,dhk->bshk", x, p[pre + "wv"])
    S, scale = x.shape[1], cfg["attention_multiplier"]
    o = torch.cat([R.checkpointed(_causal, q[:, a:a + Q_BLOCK],
                                  k[:, :a + Q_BLOCK], v[:, :a + Q_BLOCK], a,
                                  scale)
                   for a in range(0, S, Q_BLOCK)], dim=1)
    return mm("bshk,hkd->bsd", o, p[pre + "wo"])


def _conv(u: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """silu of the depthwise causal convolution sum_i u_{t-i} w_{K-1-i}
    plus the bias ``b`` (or none)."""
    K = w.shape[0]
    out = u * w[K - 1]
    for i in range(1, K):
        out = out + F.pad(u, (0, 0, i, 0))[:, :u.shape[1]] * w[K - 1 - i]
    return F.silu(out if b is None else out + b)


def mamba(cfg: dict, p: R.Params, pre: str, x: torch.Tensor,
          mm: R.Products) -> torch.Tensor:
    """``reference/ssm.py``'s mixer with the convolution's bias, where
    the configuration has one."""
    s = cfg["ssm"]
    b, L, _ = x.shape
    din, H, G, N = SSM.sizes(cfg)
    bias = cfg["mamba_conv_bias"]
    z = mm("bld,de->ble", x, p[pre + "w_z"])
    xr = mm("bld,de->ble", x, p[pre + "w_x"])
    BCr = torch.cat([mm("bld,de->ble", x, p[pre + "w_B"]),
                     mm("bld,de->ble", x, p[pre + "w_C"])], dim=-1)
    dt = F.softplus(mm("bld,de->ble", x, p[pre + "w_dt"]) + p[pre + "dt_bias"])
    xs = _conv(xr, p[pre + "conv_x"], p[pre + "conv_x_bias"] if bias else None)
    xs = xs.reshape(b, L, H, s["head_dim"])
    BC = _conv(BCr, p[pre + "conv_BC"], p[pre + "conv_BC_bias"] if bias
               else None)
    Bm = BC[..., :G * N].reshape(b, L, G, N)
    Cm = BC[..., G * N:].reshape(b, L, G, N)
    y = SSM.ssd(xs, dt, -torch.exp(p[pre + "A_log"]), Bm, Cm, s["chunk_size"])
    y = (y + xs * p[pre + "D"][:, None]).reshape(b, L, din) * F.silu(z)
    y = R.rmsnorm(y, p[pre + "norm"], 1e-6)
    return mm("bld,de->ble", y, p[pre + "out_proj"])


def capacity(tokens: int, moe: dict) -> int:
    """Slots per expert for ``tokens`` routed together: ceil(tokens /
    routed · k · capacity_factor) rounded up to a multiple of 4, at least
    k and at most tokens · k."""
    E, k = moe["routed_experts"], moe["top_k"]
    c = int(math.ceil(tokens / E * k * moe["capacity_factor"]))
    c = max(k, ((c + 3) // 4) * 4)
    return min(c, tokens * k)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, mm: R.Products) -> torch.Tensor:
    h = F.silu(mm("td,df->tf", x, w_gate)) * mm("td,df->tf", x, w_up)
    return mm("tf,fd->td", h, w_down)


def moe_share(moe: dict, p: R.Params, pre: str, x: torch.Tensor,
              mm: R.Products, shared: bool = True):
    """The held experts' part of the MoE over x [T, d] (one capacity
    group), plus the shared expert with ``shared`` -> (y [T, d], the aux
    loss's part over the held experts)."""
    T, d = x.shape
    E, held, k = moe["routed_experts"], moe["n_experts"], moe["top_k"]
    probs = torch.softmax(mm("td,de->te", x, p[pre + "router"]), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    order = top_e.t().reshape(-1)                      # (choice, token)
    onehot = F.one_hot(order, E)
    pos = (onehot.cumsum(0) - 1).gather(1, order[:, None])[:, 0]
    keep = pos < capacity(T, moe)
    token = torch.arange(k * T, device=x.device) % T
    weight = top_p.t().reshape(-1)
    y = torch.zeros_like(x)
    for e in range(held):
        sel = torch.nonzero((order == e) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        out = swiglu(x[token[sel]], *(p[pre + w][e] for w in _EXPERT), mm)
        y = y.index_add(0, token[sel], out * weight[sel, None])
    if shared:
        y = y + swiglu(x, *(p[pre + "shared." + w] for w in _EXPERT), mm)
    share = onehot[:, :held].sum(0).float() / (T * k)
    aux = E * (probs[:, :held].mean(0) * share).sum() * moe["aux_loss_weight"]
    return y, aux


def hidden(cfg: dict, p: R.Params, tokens: torch.Tensor, mm: R.Products,
           groups: Optional[List[int]] = None):
    """The last layer's output [B, S, D] over ``tokens`` [B, S] and the
    summed aux loss. ``groups``: the positions at which a new forward
    call starts (see the module's docstring); None is one call. The
    mixers are causal, so only the MoE's capacity reads the groups."""
    if cfg["logits_scaling"] != 1:
        raise ValueError("the reference's logits (reference/common.py) "
                         "take no scale: logits_scaling has to be 1")
    B, S = tokens.shape
    D, eps = cfg["d_model"], cfg["norm_eps"]
    r = cfg["residual_multiplier"]
    cuts = R.group_positions(S, groups)
    kinds = mixers(cfg)
    h = p["embed"][tokens] * cfg["embedding_multiplier"]

    def layer(h, aux, i):
        pre = f"blocks.{i}."
        x = R.rmsnorm(h, p[pre + "ln1.scale"], eps)
        if kinds[i] == "attention":
            h = h + r * attention(cfg, p, pre + "attn.", x, mm)
        else:
            h = h + r * mamba(cfg, p, pre + "ssm.", x, mm)
        x = R.rmsnorm(h, p[pre + "ln2.scale"], eps)
        ys = []
        for sl in cuts:
            y, a = moe_share(cfg["moe"], p, pre + "moe.",
                             x[:, sl].reshape(-1, D), mm)
            ys.append(y.reshape(B, -1, D))
            aux = aux + a
        return h + r * torch.cat(ys, dim=1), aux
    aux = torch.zeros((), device=h.device)
    for i in range(cfg["n_layers"]):
        h, aux = R.checkpointed(layer, h, aux, i)
    return h, aux
