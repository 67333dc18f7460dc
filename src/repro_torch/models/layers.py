"""Core model layers: norms, positions, attention, MLP.

The port of the JAX package's ``models/layers.py``. Each layer is an
``nn.Module`` that holds its parameters in float32 under the JAX
package's names and layouts (``wq`` [D, H, dh], ``wo`` [H, dh, D], ...),
with plain functions on tensors beside it. The arithmetic is the
reference's, cast where it casts: weights to the compute type at use,
norms and softmax in float32.

Attention over a whole sequence (forward, prefill, the encoder, the
decoder's cross-attention) goes through the port's flash attention op
(``repro_torch::flash_attention``), which on the card runs the flash
kernel and on the CPU its plain version. The JAX package computes the
same function with its blockwise ``chunked_attention``. Decode reads a
cache one query at a time and stays plain torch, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding as shd
from repro_torch import tracing
from repro_torch.kernels.flash_attention.ops import flash_attention


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def _dense_init(generator: torch.Generator, shape, in_axis_size: int
                ) -> nn.Parameter:
    """A standard normal of ``shape`` times 1/sqrt(fan-in), float32, drawn
    on the generator's device."""
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    w = torch.randn(shape, generator=generator, device=generator.device)
    return nn.Parameter(w * scale)


def cast(w: torch.Tensor, dtype) -> torch.Tensor:
    """A parameter in ``dtype``; a cast that changes its type is a
    ``weight_cast`` span."""
    if w.dtype == dtype:
        return w
    with tracing.span("weight_cast") as sp:
        return sp.node(w.to(dtype))


def weight(w: torch.Tensor, dtype) -> torch.Tensor:
    """A parameter as a product reads it: in ``dtype``, and under a mesh
    gathered over the data axes (FSDP's gather at use; its gradient is
    the reduce-scatter), its tensor-parallel split over "model" kept."""
    return shd.gather_data_axes(cast(w, dtype))


def _ones(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(d, device=device))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------
def rmsnorm_axes():
    return {"scale": ("embed",)}


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _ones(d, device)

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        return rmsnorm_nc(x, weight(self.scale, self.scale.dtype), eps)


def rmsnorm_nc(x: torch.Tensor, scale: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with an explicit scale vector, in float32, back in x's type."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(dtype)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                  # [head_dim // 2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs   # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, offset=0,
                         device=None) -> torch.Tensor:
    pos = (torch.arange(seq, dtype=torch.float32, device=device)
           + offset)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angles = pos / torch.pow(10000.0, dim / d)
    pe = torch.zeros(seq, d, dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles[:, : (d - d // 2)])
    return pe


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    """Grouped-query attention: ``wq`` [D, H, dh], ``wk``/``wv``
    [D, KV, dh], ``wo`` [H, dh, D], and with qk-norm ``q_norm``/``k_norm``
    [dh]."""

    def __init__(self, generator: torch.Generator, d_model: int,
                 n_heads: int, n_kv: int, head_dim: int, qk_norm: bool):
        super().__init__()
        g, dev = generator, generator.device
        self.wq = _dense_init(g, (d_model, n_heads, head_dim), d_model)
        self.wk = _dense_init(g, (d_model, n_kv, head_dim), d_model)
        self.wv = _dense_init(g, (d_model, n_kv, head_dim), d_model)
        self.wo = _dense_init(g, (n_heads, head_dim, d_model),
                              n_heads * head_dim)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = _ones(head_dim, dev)
            self.k_norm = _ones(head_dim, dev)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        q = torch.einsum("bsd,dhk->bshk", x, weight(self.wq, x.dtype))
        return rmsnorm_nc(q, self.q_norm) if self.qk_norm else q

    def qkv(self, x: torch.Tensor, positions: torch.Tensor, theta: float,
            use_rope: bool, q_scale: float = 1.0
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """q, k, v at ``positions``; q times ``q_scale``, which moves the
        attention's 1/sqrt(head_dim) to another softmax scale."""
        dtype = x.dtype
        q = torch.einsum("bsd,dhk->bshk", x, weight(self.wq, dtype))
        k = torch.einsum("bsd,dhk->bshk", x, weight(self.wk, dtype))
        v = torch.einsum("bsd,dhk->bshk", x, weight(self.wv, dtype))
        if self.qk_norm:
            q = rmsnorm_nc(q, self.q_norm)
            k = rmsnorm_nc(k, self.k_norm)
        if use_rope:
            q = apply_rope(q, positions, theta)
            k = apply_rope(k, positions, theta)
        if q_scale != 1.0:
            q = q * q_scale
        return q, k, v

    def out(self, o: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bshk,hkd->bsd", o, weight(self.wo, o.dtype))


def attention_axes(qk_norm: bool):
    p = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if qk_norm:
        p["q_norm"] = ("head_dim",)
        p["k_norm"] = ("head_dim",)
    return p


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    """Softmax attention of q [B, Sq, H, dh] over k/v [B, Skv, KV, dh]
    through the port's flash attention op (the kernel on the card, its
    plain version on the CPU)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal)


def attention_fwd(attn: Attention, x: torch.Tensor, *, theta: float,
                  causal: bool = True, use_rope: bool = True,
                  kv_override: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                  q_scale: float = 1.0) -> torch.Tensor:
    """Full-sequence attention (forward / encoder / cross) at positions
    0..S-1. With ``kv_override`` the keys and values are given
    (cross-attention) and only q is projected. ``q_scale`` as in
    ``Attention.qkv``."""
    if kv_override is not None:
        q = attn.q(x)
        k, v = kv_override
    else:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        q, k, v = attn.qkv(x, positions, theta, use_rope, q_scale)
    return attn.out(attend(q, k, v, causal))


def attention_prefill(attn: Attention, x: torch.Tensor, *, theta: float,
                      use_rope: bool, cache_len: int, q_scale: float = 1.0):
    """Like ``attention_fwd`` (causal), and also returns k/v written into
    zeroed caches of ``cache_len`` positions."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = attn.qkv(x, positions, theta, use_rope, q_scale)
    out = attn.out(attend(q, k, v, True))
    k_c = k.new_zeros((B, cache_len) + k.shape[2:])
    v_c = v.new_zeros((B, cache_len) + v.shape[2:])
    k_c[:, :S] = k
    v_c[:, :S] = v
    return out, (k_c, v_c)


def _decode_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B, 1, H, dh] against k [B, S, KV, dh], GQA by repeating kv
    heads, scaled: [B, H, 1, S] in q's type."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
    return torch.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(
        q.shape[-1]))


def _decode_values(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    rep = probs.shape[1] // v.shape[2]
    if rep > 1:
        v = v.repeat_interleave(rep, dim=2)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_decode(attn: Attention, x: torch.Tensor, cache_kv,
                     pos: Union[int, torch.Tensor], *, theta: float,
                     use_rope: bool = True, q_scale: float = 1.0):
    """Single-token decode. x: [B, 1, D]; cache k/v: [B, Smax, KV, dh];
    pos: the write index (tokens 0..pos-1 are valid), an int or a 0-d
    integer tensor on x's device, which a CUDA graph reads anew at each
    replay (nothing of it comes to the host). Writes k/v at pos into the
    cache tensors in place and returns them."""
    dtype = x.dtype
    k_cache, v_cache = cache_kv
    Smax = k_cache.shape[1]
    positions = torch.as_tensor(pos, dtype=torch.int64,
                                device=x.device).reshape(1, 1)
    q, k, v = attn.qkv(x, positions, theta, use_rope, q_scale)
    if shd._is_dtensor(k_cache):
        # DTensor's index_copy_ breaks a cache sharded on the sequence
        # (the dry-run's long-context decode): its callers write at an int
        k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
        v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    else:
        k_cache.index_copy_(1, positions[0], k.to(k_cache.dtype))
        v_cache.index_copy_(1, positions[0], v.to(v_cache.dtype))
    scores = _decode_scores(q, k_cache).float()
    invalid = (torch.arange(Smax, device=x.device)[None, None, None, :]
               > positions)
    scores = scores.masked_fill(invalid, -1e30)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return attn.out(_decode_values(probs, v_cache)), (k_cache, v_cache)


def attention_readonly(attn: Attention, x: torch.Tensor,
                       cache_kv) -> torch.Tensor:
    """Cross-attention during decode: attend over a fixed cache, no write,
    no positional encoding on q (whisper-style)."""
    k_cache, v_cache = cache_kv
    q = attn.q(x)
    probs = torch.softmax(_decode_scores(q, k_cache).float(),
                          dim=-1).to(x.dtype)
    return attn.out(_decode_values(probs, v_cache))


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------
def mlp_axes():
    return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
            "w_down": ("mlp", "embed")}


class MLP(nn.Module):
    def __init__(self, generator: torch.Generator, d_model: int, d_ff: int):
        super().__init__()
        self.w_gate = _dense_init(generator, (d_model, d_ff), d_model)
        self.w_up = _dense_init(generator, (d_model, d_ff), d_model)
        self.w_down = _dense_init(generator, (d_ff, d_model), d_ff)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        g = torch.einsum("bsd,df->bsf", x, weight(self.w_gate, dtype))
        u = torch.einsum("bsd,df->bsf", x, weight(self.w_up, dtype))
        h = F.silu(g) * u
        return torch.einsum("bsf,fd->bsd", h, weight(self.w_down, dtype))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embedding(generator: torch.Generator, vocab: int,
                   d_model: int) -> nn.Parameter:
    return nn.Parameter(torch.randn((vocab, d_model), generator=generator,
                                    device=generator.device) * 0.02)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    """The rows of ``tokens``, in ``dtype`` (the gather before the cast,
    which gives the same values as the reference's cast of the table).
    A table whose rows are split over mesh axes is looked up
    vocab-parallel (``_embed_vocab_parallel``)."""
    if shd.rows_split(table):
        return _embed_vocab_parallel(table, tokens).to(dtype)
    return F.embedding(tokens, table).to(dtype)


def _embed_vocab_parallel(table: torch.Tensor,
                          tokens: torch.Tensor) -> torch.Tensor:
    """Each rank looks up the tokens that fall in its rows of the table
    (zeros for the others); the sum over the axes that split the rows is
    a DTensor ``Partial``, whose gradient reaches each rank's rows
    whole. (DTensor's own lookup gives a masked partial, whose backward
    torch 2.11 cannot take from a summed gradient.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    split = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    tok = tokens if isinstance(tokens, DTensor) else DTensor.from_local(
        tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    tok_pl = [Replicate() if i in split else p
              for i, p in enumerate(tok.placements)]
    tok = tok.redistribute(mesh, tok_pl)
    idx, n = 0, 1
    for i in split:
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
        n *= mesh.size(i)
    rows = table.shape[0] // n
    lo = idx * rows
    # the local rows' gradient: partial over the axes whose ranks look up
    # different tokens with the same rows
    grad_pl = [p if i in split else
               Partial() if isinstance(tok_pl[i], Shard) else Replicate()
               for i, p in enumerate(table.placements)]
    local = table.to_local(grad_placements=grad_pl)
    t = tok.to_local()
    mine = (t >= lo) & (t < lo + rows)
    out = F.embedding((t - lo).clamp(0, rows - 1), local) \
        * mine[..., None].to(local.dtype)
    out_pl = [Partial() if i in split else p for i, p in enumerate(tok_pl)]
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def logits_fwd(table_or_unembed: torch.Tensor, x: torch.Tensor, tied: bool,
               real_vocab: int) -> torch.Tensor:
    """Project to the (padded) vocab; padded rows masked to -1e30; fp32."""
    w = weight(table_or_unembed, x.dtype)
    if tied:
        logits = torch.einsum("bsd,vd->bsv", x, w)
    else:
        logits = torch.einsum("bsd,dv->bsv", x, w)
    logits = logits.float()
    V = logits.shape[-1]
    if V > real_vocab:
        pad = torch.arange(V, device=logits.device) >= real_vocab
        logits.masked_fill_(pad, -1e30)
    return logits
