"""The plain reference of the ``moe`` family: a decoder of grouped-query
attention with rotary positions and a top-k mixture of experts in every
layer, pre-norm residuals, tied embeddings (IBM Granite 3.0 MoE without
its muP multipliers, as the configuration file states). Float32, no
kernels, no cache.

The experts follow the program's stated semantics, which differ from the
published dropless model: a capacity of ``moe_capacity(T)`` slots per
expert for the T tokens of one forward call, filled in GShard's order.
So ``hidden`` routes the positions of each call together: the whole
sequence in training, the prompt and then each decode position in
serving (``groups``).

Parameter names and layouts: ``embed`` [V, D], ``final_norm.scale``,
and for layer i ``blocks.i.ln1.scale``, ``blocks.i.attn.wq`` [D, H, d],
``wk``, ``wv`` [D, KV, d], ``wo`` [H, d, D], ``blocks.i.ln2.scale``,
``blocks.i.moe.router`` [D, E], ``w_gate``, ``w_up`` [E, D, F],
``w_down`` [E, F, D].
"""
from __future__ import annotations

from typing import List, Optional

import torch

from portbench.reference import common as R


def param_spec(cfg: dict) -> list:
    """[(name, shape, init)] in the order the weights are drawn; see
    ``reference/ssm.py`` for the inits."""
    D, V = cfg["d_model"], cfg["padded_vocab"]
    H, KV, d = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    m = cfg["moe"]
    E, F_ = m["n_experts"], m["d_ff_expert"]
    spec = [("embed", (V, D), ("embed",)),
            ("final_norm.scale", (D,), ("ones",))]
    for i in range(cfg["n_layers"]):
        b = f"blocks.{i}."
        spec += [(b + "ln1.scale", (D,), ("ones",)),
                 (b + "attn.wq", (D, H, d), ("normal", D)),
                 (b + "attn.wk", (D, KV, d), ("normal", D)),
                 (b + "attn.wv", (D, KV, d), ("normal", D)),
                 (b + "attn.wo", (H, d, D), ("normal", H * d)),
                 (b + "ln2.scale", (D,), ("ones",)),
                 (b + "moe.router", (D, E), ("normal", D)),
                 (b + "moe.w_gate", (E, D, F_), ("normal", D)),
                 (b + "moe.w_up", (E, D, F_), ("normal", D)),
                 (b + "moe.w_down", (E, F_, D), ("normal", F_))]
    return spec


def attention(cfg: dict, p: R.Params, pre: str, x: torch.Tensor,
              mm: R.Products) -> torch.Tensor:
    q = R.rope(mm("bsd,dhk->bshk", x, p[pre + "wq"]), cfg["rope_theta"])
    k = R.rope(mm("bsd,dhk->bshk", x, p[pre + "wk"]), cfg["rope_theta"])
    v = mm("bsd,dhk->bshk", x, p[pre + "wv"])
    return mm("bshk,hkd->bsd", R.causal_attention(q, k, v), p[pre + "wo"])


def hidden(cfg: dict, p: R.Params, tokens: torch.Tensor, mm: R.Products,
           groups: Optional[List[int]] = None):
    """The last layer's output [B, S, D] over ``tokens`` [B, S] and the
    summed aux loss. ``groups``: the positions at which a new forward
    call starts (see the module's docstring); None is one call."""
    B, S = tokens.shape
    D = cfg["d_model"]
    cuts = R.group_positions(S, groups)
    h = p["embed"][tokens]

    def layer(h, aux, i):
        pre = f"blocks.{i}."
        h = h + attention(cfg, p, pre + "attn.",
                          R.rmsnorm(h, p[pre + "ln1.scale"],
                                    cfg["norm_eps"]), mm)
        x = R.rmsnorm(h, p[pre + "ln2.scale"], cfg["norm_eps"])
        ys = []
        for sl in cuts:
            y, a = R.moe_layer(cfg["moe"], p, pre + "moe.",
                               x[:, sl].reshape(-1, D), mm)
            ys.append(y.reshape(B, -1, D))
            aux = aux + a
        return h + torch.cat(ys, dim=1), aux
    aux = torch.zeros((), device=h.device)
    for i in range(cfg["n_layers"]):
        h, aux = R.checkpointed(layer, h, aux, i)
    return h, aux
