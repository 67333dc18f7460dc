"""Model assembly: decoder-only LMs (dense, MoE, hybrid, SSM, VLM) and the
whisper encoder-decoder, as ``nn.Module``s.

The port of the JAX package's ``models/model.py``. Where the reference
stacks each pattern position's parameters [R, ...] and scans over the
groups, the port holds one module per layer in an ``nn.ModuleList``, in
``cfg.layer_kinds()`` order, and loops over them; caches are one dict per
layer. Parameter names follow the reference's tree (``blocks.3.attn.wq``
is ``params["blocks"][3 % P]["attn"]["wq"][3 // P]`` for a pattern of P
layers), which ``convert.lm_params_from_jax`` relies on. ``param_axes``
gives each parameter's logical axes for the sharding rules. The JAX
package's batch constraints sit where it puts them (the embedded input,
the end of each layer group, the logits): under a mesh they redistribute
DTensor activations, otherwise they are the identity.

``forward`` runs the full sequence (training's logits), with each layer
optionally rematerialized in the backward (``remat``); ``loss_fn`` is
the training loss over it; ``prefill`` ingests a prompt into the caches
and returns the last position's logits; ``decode_step`` takes one token
per sequence. Attention over a sequence runs the port's flash attention
op and the Mamba-2 scan its SSD op, both kernels on the card, in the
forward and again in a rematerialized layer's recompute; their
gradients are the ops' own formulas in torch ops.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import sharding as shd
from repro_torch import tracing
from repro_torch.configs import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Batch = Dict[str, torch.Tensor]
Cache = List[Dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class Block(nn.Module):
    """One decoder layer of kind ``"<mixer>+<ff>"``: attn or ssm, then
    mlp, moe or none."""

    def __init__(self, cfg: ArchConfig, kind: str,
                 generator: torch.Generator):
        super().__init__()
        g, dev = generator, generator.device
        self.kind = kind
        mixer, ff = kind.split("+")
        self.ln1 = L.RMSNorm(cfg.d_model, dev)
        if mixer == "attn":
            self.attn = L.Attention(g, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim, cfg.qk_norm)
        else:
            self.ssm = SSM.SSM(g, cfg.d_model, cfg.ssm, cfg.ssm_conv_bias)
        if ff in ("mlp", "moe"):
            self.ln2 = L.RMSNorm(cfg.d_model, dev)
        if ff == "mlp":
            self.mlp = L.MLP(g, cfg.d_model, cfg.d_ff)
        elif ff == "moe":
            self.moe = MOE.MoE(g, cfg.d_model, cfg.moe, cfg.routed_experts,
                               cfg.shared_expert_ff)


class DecXBlock(nn.Module):
    """Whisper decoder layer: self-attention, cross-attention, MLP."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        g, dev = generator, generator.device
        self.kind = "attn+mlp"

        def attn():
            return L.Attention(g, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.qk_norm)
        self.ln1 = L.RMSNorm(cfg.d_model, dev)
        self.attn = attn()
        self.ln_x = L.RMSNorm(cfg.d_model, dev)
        self.xattn = attn()
        self.ln2 = L.RMSNorm(cfg.d_model, dev)
        self.mlp = L.MLP(g, cfg.d_model, cfg.d_ff)


class LM(nn.Module):
    """The parameters of one architecture, float32, on the generator's
    device."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator):
        super().__init__()
        g, dev = generator, generator.device
        self.cfg = cfg
        self.embed = L.init_embedding(g, cfg.padded_vocab, cfg.d_model)
        self.final_norm = L.RMSNorm(cfg.d_model, dev)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(torch.randn(
                (cfg.d_model, cfg.padded_vocab), generator=g, device=dev)
                * (cfg.d_model ** -0.5))
        if cfg.frontend is not None:
            self.frontend_proj = L._dense_init(g, (cfg.d_model, cfg.d_model),
                                               cfg.d_model)
        if cfg.enc_dec is not None:
            self.enc_blocks = nn.ModuleList(
                Block(cfg, "attn+mlp", g)
                for _ in range(cfg.enc_dec.n_enc_layers))
            self.enc_norm = L.RMSNorm(cfg.d_model, dev)
            self.blocks = nn.ModuleList(DecXBlock(cfg, g)
                                        for _ in range(cfg.n_layers))
        else:
            self.blocks = nn.ModuleList(Block(cfg, kind, g)
                                        for kind in cfg.layer_kinds())

    def unembedding(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.unembed


def _block_axes(cfg: ArchConfig, kind: str) -> Dict[str, dict]:
    mixer, ff = kind.split("+")
    p = {"ln1": L.rmsnorm_axes()}
    if mixer == "attn":
        p["attn"] = L.attention_axes(cfg.qk_norm)
    else:
        p["ssm"] = SSM.ssm_axes(cfg.ssm_conv_bias)
    if ff in ("mlp", "moe"):
        p["ln2"] = L.rmsnorm_axes()
        p["mlp" if ff == "mlp" else "moe"] = (
            L.mlp_axes() if ff == "mlp"
            else MOE.moe_axes(shared=cfg.shared_expert_ff > 0))
    return p


def _dec_xblock_axes(cfg: ArchConfig) -> Dict[str, dict]:
    return {
        "ln1": L.rmsnorm_axes(), "attn": L.attention_axes(cfg.qk_norm),
        "ln_x": L.rmsnorm_axes(), "xattn": L.attention_axes(cfg.qk_norm),
        "ln2": L.rmsnorm_axes(), "mlp": L.mlp_axes(),
    }


def _flat_axes(tree: dict, prefix: str, out: Dict[str, tuple]) -> None:
    for name, v in tree.items():
        if isinstance(v, dict):
            _flat_axes(v, f"{prefix}{name}.", out)
        else:
            out[prefix + name] = v


def param_axes(cfg: ArchConfig) -> Dict[str, tuple]:
    """{parameter name of ``LM(cfg)``: its logical axes}, one name per
    entry of ``state_dict``. The JAX package's tree stacks each pattern
    position's layers with a leading "layers" axis, which no profile
    shards; the port's layers are one module each, without it."""
    ax = {"embed": ("vocab_in", "embed_in"),
          "final_norm": L.rmsnorm_axes()}
    if not cfg.tie_embeddings:
        ax["unembed"] = ("embed", "vocab")
    if cfg.frontend is not None:
        ax["frontend_proj"] = ("embed", None)
    if cfg.enc_dec is not None:
        ax["enc_blocks"] = {str(i): _block_axes(cfg, "attn+mlp")
                            for i in range(cfg.enc_dec.n_enc_layers)}
        ax["enc_norm"] = L.rmsnorm_axes()
        ax["blocks"] = {str(i): _dec_xblock_axes(cfg)
                        for i in range(cfg.n_layers)}
    else:
        ax["blocks"] = {str(i): _block_axes(cfg, kind)
                        for i, kind in enumerate(cfg.layer_kinds())}
    out: Dict[str, tuple] = {}
    _flat_axes(ax, "", out)
    return out


def init_params(cfg: ArchConfig, generator: torch.Generator) -> LM:
    """The model of ``cfg`` with its weights drawn from ``generator`` (on
    the generator's device), as the JAX package draws them: normal ·
    1/sqrt(fan-in) for projections, 0.02 · normal for the embedding,
    ones for norms."""
    return LM(cfg, generator)


# ---------------------------------------------------------------------------
# Embedding front
# ---------------------------------------------------------------------------
def _scaled(t: torch.Tensor, m: float) -> torch.Tensor:
    """t times a muP multiplier ``m`` (``ArchConfig``); t itself at 1."""
    return t if m == 1.0 else t * m


def _attn_kw(cfg: ArchConfig) -> dict:
    """The positional encoding and the factor on q that gives the
    attention ``cfg.attention_multiplier`` as its softmax scale."""
    m = cfg.attention_multiplier
    return dict(theta=cfg.rope_theta, use_rope=cfg.positional == "rope",
                q_scale=m * math.sqrt(cfg.head_dim) if m else 1.0)


def _embed(cfg: ArchConfig, model: LM, batch: Batch, dtype,
           pos: Union[int, torch.Tensor, None] = None) -> torch.Tensor:
    """The embedded tokens times ``cfg.embedding_multiplier``: over a
    sequence (``pos`` None) behind the patch stub's projected patches and
    constrained to the batch; in decode, of the token at ``pos``."""
    h = _scaled(L.embed_tokens(model.embed, batch["tokens"], dtype),
                cfg.embedding_multiplier)
    if cfg.frontend == "patch_stub" and pos is None:
        n = cfg.n_prefix_tokens
        patches = torch.einsum("bnd,de->bne", batch["patches"].to(dtype),
                               L.weight(model.frontend_proj, dtype))
        h = torch.cat([patches, h[:, n:]], dim=1)
    if cfg.positional == "sinusoidal":
        h = h + L.sinusoidal_positions(h.shape[1], cfg.d_model,
                                       offset=0 if pos is None else pos,
                                       device=h.device).to(dtype)
    return h if pos is not None else shd.constrain_batch(h)


def _residual(h: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """h + out, kept batch-sharded under a mesh: a row-parallel product
    (attention's or the MLP's output over heads or hidden units split
    over "model") leaves a partial sum, which is reduced here, once per
    residual add, rather than wherever DTensor would next need it."""
    return shd.constrain_batch(h + out)


def _group_end(cfg: ArchConfig, i: int) -> bool:
    """Whether layer i ends a group of the layer pattern (where the JAX
    package's scan body constrains the activations to the batch)."""
    return (i + 1) % len(cfg.scan_groups()[0]) == 0


def _logits(cfg: ArchConfig, model: LM, h: torch.Tensor) -> torch.Tensor:
    h = model.final_norm(h, cfg.norm_eps)
    return L.logits_fwd(model.unembedding(), h, cfg.tie_embeddings,
                        cfg.vocab_size)


# ---------------------------------------------------------------------------
# The layer walker: any layer in any mode
# ---------------------------------------------------------------------------
SEQUENCE, PREFILL, DECODE = "sequence", "prefill", "decode"


def _layer(cfg: ArchConfig, blk: nn.Module, h: torch.Tensor, aux, i: int,
           mode: str, *, enc_h: Optional[torch.Tensor] = None,
           cache: Optional[Dict[str, torch.Tensor]] = None,
           pos: Union[int, torch.Tensor] = 0, cache_len: int = 0):
    """Layer ``i``, a ``Block`` or whisper's ``DecXBlock``, over ``h`` in
    ``mode``: ``SEQUENCE`` (the forward and the loss), ``PREFILL`` (also
    the layer's new cache of ``cache_len`` positions) or ``DECODE`` (one
    token at ``pos``, an int or a 0-d device tensor, updating ``cache``
    in place) → (h, aux, the
    layer's cache; None over a sequence). The mixer and the feed-forward
    part, each with its norm and residual add (the part's output times
    ``cfg.residual_multiplier``), are spans named by their kind
    (``attn``, ``ssm``, ``mlp``, ``moe``) with ``layer=i``; whisper's
    cross-attention sits between them, outside both. Only a sequence or a
    prefill sums the aux loss (decode gains no add a MoE layer) and ends
    a ``Block`` group with the batch constraint; whisper's cross keys come
    from ``enc_h`` there and from the cache in decode."""
    mixer, ff = blk.kind.split("+")
    r = cfg.residual_multiplier
    kw = _attn_kw(cfg)
    new = None
    with tracing.span(mixer, layer=i) as sp:
        h = sp.input(h)
        x = blk.ln1(h, cfg.norm_eps)
        if mixer == "ssm" and mode == DECODE:
            out, new = SSM.ssm_decode(blk.ssm, x, cache)
        elif mixer == "ssm" and mode == PREFILL:
            out, new = SSM.ssm_fwd(blk.ssm, x, return_state=True)
        elif mixer == "ssm":
            out = SSM.ssm_fwd(blk.ssm, x)
        elif mode == DECODE:
            out, (k, v) = L.attention_decode(
                blk.attn, x, (cache["k"], cache["v"]), pos, **kw)
            new = {**cache, "k": k, "v": v}
        elif mode == PREFILL:
            out, (k, v) = L.attention_prefill(blk.attn, x,
                                              cache_len=cache_len, **kw)
            new = {"k": k, "v": v}
        else:
            out = L.attention_fwd(blk.attn, x, causal=True, **kw)
        h = sp.output(_residual(h, _scaled(out, r)))
    if isinstance(blk, DecXBlock):
        x = blk.ln_x(h, cfg.norm_eps)
        if mode == DECODE:
            y = L.attention_readonly(blk.xattn, x, (cache["xk"], cache["xv"]))
        else:
            kx, vx = (torch.einsum("bsd,dhk->bshk", enc_h,
                                   L.weight(w, enc_h.dtype))
                      for w in (blk.xattn.wk, blk.xattn.wv))
            y = L.attention_fwd(blk.xattn, x, causal=False,
                                kv_override=(kx, vx), **kw)
            if mode == PREFILL:
                new.update(xk=kx, xv=vx)
        h = _residual(h, y)
    if ff in ("mlp", "moe"):
        with tracing.span(ff, layer=i) as sp:
            h = sp.input(h)
            x = blk.ln2(h, cfg.norm_eps)
            if ff == "mlp":
                y, a = blk.mlp(x), None
            else:
                y, a = MOE.moe_fwd(blk.moe, x)
            h = sp.output(_residual(h, _scaled(y, r)))
            if a is not None and mode != DECODE:
                aux = aux + a
    if mode != DECODE and isinstance(blk, Block) and _group_end(cfg, i):
        h = shd.constrain_batch(h)
    return h, aux, new


def _encoder_fwd(cfg: ArchConfig, model: LM, batch: Batch, dtype,
                 remat: str = "none") -> torch.Tensor:
    frames = batch["frames"].to(dtype)
    h = torch.einsum("bsd,de->bse", frames, L.weight(model.frontend_proj, dtype))
    h = h + L.sinusoidal_positions(h.shape[1], cfg.d_model,
                                   device=h.device).to(dtype)

    def layer(h, blk):
        x = blk.ln1(h, cfg.norm_eps)
        h = _residual(h, L.attention_fwd(blk.attn, x, theta=cfg.rope_theta,
                                         causal=False, use_rope=False))
        return _residual(h, blk.mlp(blk.ln2(h, cfg.norm_eps)))
    for blk in model.enc_blocks:
        h = _remat(functools.partial(layer, blk=blk), remat)(h)
    return model.enc_norm(h, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Rematerialization
# ---------------------------------------------------------------------------
REMAT = ("none", "dots", "full")
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                  torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``"dots"``: keep the matrix products' outputs, recompute the rest
    (the JAX package's ``dots_with_no_batch_dims_saveable``; the flash and
    SSD ops are recomputed)."""
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat: str):
    """``fn`` under the remat policy: ``"none"`` keeps every activation;
    ``"full"`` keeps only the layer's inputs and reruns the layer in the
    backward (``torch.utils.checkpoint``, non-reentrant); ``"dots"`` is
    selective checkpointing that keeps the matmul outputs. Without grad
    there is nothing to save and ``fn`` runs as it is. The recompute runs
    under the mesh of the call (``sharding.use_mesh``): on the card the
    backward runs in autograd's device thread, which does not see the
    caller's context. The layers draw no random numbers, so no generator
    state is stashed for the recompute (reading the card's generator is
    refused while a CUDA graph captures the train step)."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    mesh = shd.current_mesh()
    if mesh is not None:
        fn = functools.partial(_under_mesh, fn, mesh)
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 preserve_rng_state=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False, preserve_rng_state=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _dots_policy))


def _under_mesh(fn, mesh, *args):
    with shd.use_mesh(mesh):
        return fn(*args)


# ---------------------------------------------------------------------------
# Forward — logits over the full sequence
# ---------------------------------------------------------------------------
def forward(cfg: ArchConfig, model: LM, batch: Batch, *,
            compute_dtype=torch.bfloat16, remat: str = "none"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (logits [B, S, V] float32, aux loss). ``remat`` ("none", "dots"
    or "full") applies to each layer."""
    h, aux = _trunk(cfg, model, batch, compute_dtype, remat)
    with tracing.span("head") as sp:
        logits = sp.output(_seq_logits(cfg, model, sp.input(h)))
    return logits, aux


def _trunk(cfg: ArchConfig, model: LM, batch: Batch, dtype, remat: str
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layers over the sequence → (h before the final norm, aux
    loss)."""
    h = _embed(cfg, model, batch, dtype)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    enc_h = (_encoder_fwd(cfg, model, batch, dtype, remat)
             if cfg.enc_dec is not None else None)

    def layer(h, aux, enc_h, blk, i):
        return _layer(cfg, blk, h, aux, i, SEQUENCE, enc_h=enc_h)[:2]
    for i, blk in enumerate(model.blocks):
        h, aux = _remat(functools.partial(layer, blk=blk, i=i),
                        remat)(h, aux, enc_h)
    return h, aux


def _seq_logits(cfg: ArchConfig, model: LM, h: torch.Tensor) -> torch.Tensor:
    """The logits over the sequence, batch-sharded under a mesh."""
    return shd.constrain_batch(_logits(cfg, model, h), extra=("model",))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def loss_fn(cfg: ArchConfig, model: LM, batch: Batch, *,
            compute_dtype=torch.bfloat16, remat: str = "none"):
    """Mean next-token cross-entropy over the positions whose label is
    not negative, plus the MoE aux loss → (loss + aux, {"loss",
    "aux_loss", "n_tokens"}), as the JAX package's ``loss_fn``. Each
    position's log-sum-exp less its label's logit comes from
    ``F.cross_entropy``, without the reference's [B, S, V] one-hot. The
    final norm, the logits and the loss are the ``head`` span."""
    h, aux = _trunk(cfg, model, batch, compute_dtype, remat)
    with tracing.span("head") as sp:
        logits = _seq_logits(cfg, model, sp.input(h))
        labels = batch["labels"].long()
        valid = labels >= 0
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              safe.reshape(-1), reduction="none"
                              ).reshape(labels.shape)
        n_valid = valid.sum().clamp(min=1)
        loss = sp.output(torch.where(valid, nll, torch.zeros_like(nll)
                                     ).sum() / n_valid)
    return loss + aux, {"loss": loss, "aux_loss": aux,
                        "n_tokens": n_valid.float()}


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype,
               device=None) -> Cache:
    """Zeroed caches, one dict per layer: attention {"k", "v"} [B,
    cache_len, KV, dh], SSM {"conv", "h"}, whisper's decoder also its
    cross-attention {"xk", "xv"} over the encoder's positions."""
    def kv(s):
        return torch.zeros((batch, s, cfg.n_kv_heads, cfg.head_dim),
                           dtype=dtype, device=device)
    if cfg.enc_dec is not None:
        e = cfg.enc_dec
        return [{"k": kv(cache_len), "v": kv(cache_len), "xk": kv(e.enc_seq),
                 "xv": kv(e.enc_seq)} for _ in range(cfg.n_layers)]
    caches = []
    for kind in cfg.layer_kinds():
        if kind.startswith("attn"):
            caches.append({"k": kv(cache_len), "v": kv(cache_len)})
        else:
            caches.append(SSM.init_ssm_cache(batch, cfg.d_model, cfg.ssm,
                                             dtype, device))
    return caches


# ---------------------------------------------------------------------------
# Prefill — the full forward, writing the caches; the last logits
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(cfg: ArchConfig, model: LM, batch: Batch, cache_len: int, *,
            compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Cache]:
    """→ (logits [B, V] of the last position, caches of ``cache_len``
    positions). The whole call is the ``serve.prefill`` span."""
    with tracing.span("serve.prefill"):
        h = _embed(cfg, model, batch, compute_dtype)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        enc_h = (_encoder_fwd(cfg, model, batch, compute_dtype)
                 if cfg.enc_dec is not None else None)
        caches = []
        for i, blk in enumerate(model.blocks):
            h, aux, c = _layer(cfg, blk, h, aux, i, PREFILL, enc_h=enc_h,
                               cache_len=cache_len)
            caches.append(c)
        with tracing.span("head"):
            return _logits(cfg, model, h[:, -1:])[:, 0], caches


# ---------------------------------------------------------------------------
# Decode — one token with the caches
# ---------------------------------------------------------------------------
@torch.no_grad()
def decode_step(cfg: ArchConfig, model: LM, cache: Cache,
                token: torch.Tensor, pos: Union[int, torch.Tensor], *,
                compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Cache]:
    """token: [B, 1]; pos: the write index, an int or a 0-d integer
    tensor on the device (the same bits either way) → (logits [B, V],
    caches). Every cache tensor is updated in place (attention's k/v
    written at ``pos``, the SSM's conv window and state) and returned
    itself, so that a CUDA graph of the call keeps its caches in its own
    tensors. The whole call is the ``serve.decode`` span, each layer's
    parts spans of their kind as in ``_layer``."""
    with tracing.span("serve.decode"):
        h = _embed(cfg, model, {"tokens": token}, compute_dtype, pos)
        new_caches = []
        for i, (blk, c) in enumerate(zip(model.blocks, cache)):
            h, _, c = _layer(cfg, blk, h, None, i, DECODE, cache=c, pos=pos)
            new_caches.append(c)
        with tracing.span("head"):
            return _logits(cfg, model, h)[:, 0], new_caches
