"""Plain torch oracle for the flash attention kernel: exact softmax
attention in fp32, materialising the scores."""
from __future__ import annotations

import math

import torch


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: [B, Sq, H, d]; k/v: [B, Skv, KV, d] (GQA: head h reads kv head
    h // (H // KV)) → [B, Sq, H, d] in q's dtype. The causal mask is
    right-aligned: query i sees key j <= i + Skv - Sq.

    A query row that sees no key (causal with Sq > Skv) gives 0, as the
    TPU kernel does (its ``safe_l``) and the CUDA kernel does; the JAX
    package's oracle gives NaN there."""
    B, Sq, H, d = q.shape
    _, Skv, KV, _ = k.shape
    rep = H // KV
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if causal:
        mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device).tril(
            diagonal=Skv - Sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    if causal:
        p = p.masked_fill(~mask.any(-1, keepdim=True), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)
