"""int8 KV-cache quantization.

The port of the JAX package's ``models/kvquant.py``: per-(position, head)
absmax scales (KIVI/KVQuant style, arXiv:2402.02750), post-RoPE, int8
values and bf16 scales, and decode attention over such a cache with the
key scales folded into the scores and the value scales into the
probabilities.

A quantized cache is {"k": int8 [.., S, KV, dh], "k_s": bf16
[.., S, KV, 1], and the same for v}.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [..., dh] → (int8 values, bf16 scale [..., 1]); absmax per row."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True) / 127.0 + 1e-8
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def init_quant_kv_cache(batch: int, cache_len: int, n_kv: int,
                        head_dim: int, device=None) -> Dict[str, torch.Tensor]:
    def zeros(last, dtype):
        return torch.zeros((batch, cache_len, n_kv, last), dtype=dtype,
                           device=device)
    return {"k": zeros(head_dim, torch.int8), "k_s": zeros(1, torch.bfloat16),
            "v": zeros(head_dim, torch.int8), "v_s": zeros(1, torch.bfloat16)}


def update_quant_cache(cache: Dict[str, torch.Tensor], k_new: torch.Tensor,
                       v_new: torch.Tensor, pos: int
                       ) -> Dict[str, torch.Tensor]:
    """A new cache with k_new/v_new [B, 1, KV, dh] quantized at ``pos``."""
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    out = {name: t.clone() for name, t in cache.items()}
    for name, t in (("k", kq), ("k_s", ks), ("v", vq), ("v_s", vs)):
        out[name][:, pos] = t[:, 0]
    return out


def attend_quant(q: torch.Tensor, cache: Dict[str, torch.Tensor], pos: int,
                 *, dtype=torch.bfloat16) -> torch.Tensor:
    """Decode attention over an int8 cache. q: [B, 1, H, dh] (post-RoPE)
    → [B, 1, H, dh] in ``dtype``. Positions after ``pos`` are masked."""
    dh = q.shape[-1]
    rep = q.shape[2] // cache["k"].shape[2]
    kq, ks = cache["k"], cache["k_s"]
    vq, vs = cache["v"], cache["v_s"]
    if rep > 1:
        kq, ks, vq, vs = (t.repeat_interleave(rep, dim=2)
                          for t in (kq, ks, vq, vs))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          kq.float()) * (1.0 / math.sqrt(dh))
    scores = scores * ks[..., 0].float().permute(0, 2, 1)[:, :, None, :]
    Smax = kq.shape[1]
    invalid = torch.arange(Smax, device=q.device)[None, None, None, :] > pos
    scores = scores.masked_fill(invalid, -1e30)
    probs = torch.softmax(scores, dim=-1)
    # (p·s_v)·v_q: the value scales fold into the probabilities
    pv = probs * vs[..., 0].float().permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum("bhqk,bkhd->bqhd", pv, vq.float())
    return out.to(dtype)
