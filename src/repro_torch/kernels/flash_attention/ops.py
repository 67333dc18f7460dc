"""The public flash attention entry point, as the custom op
``repro_torch::flash_attention``: on a CUDA tensor it runs the kernel
(``kernel.flash_attention_bshd``), on a CPU tensor the plain version
(``ref.attention_reference``). ``torch.utils.flop_counter.FlopCounterMode``
counts the op by ``flash_attention_flops``, not by what either
implementation runs inside. Its gradient is the op
``repro_torch::flash_attention_backward`` (``backward.py``): on a CUDA
tensor in bf16 the backward kernel (``kernel.flash_attention_backward_wgmma``),
else the formula in torch ops. Under ``FakeTensorMode`` the op gives
an empty tensor of q's shape; on DTensors it runs on the local shards
under ``flash_sharding``'s rule."""
from __future__ import annotations

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import sharding_rules
from repro_torch.kernels.flash_attention import backward
from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd
from repro_torch.kernels.flash_attention.ref import attention_reference


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool) -> torch.Tensor:
    return attention_reference(q, k, v, causal=causal).contiguous()


@_flash_attention.register_kernel("cuda")
def _(q, k, v, causal):
    return flash_attention_bshd(q, k, v, causal=causal)


@_flash_attention.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


def flash_sharding(q, k, v, causal):
    """Per mesh dim: all replicated; batch-sharded; or heads-sharded,
    q's heads and k/v's kv heads on the same mesh dim. q sharded with k/v
    replicated is never offered: local q head j of rank r needs kv head
    (j + r·H/m)/g, where the kernel takes j/g."""
    r, b, h = Replicate(), Shard(0), Shard(2)
    return [([r], [r, r, r, None]), ([b], [b, b, b, None]),
            ([h], [h, h, h, None])]


def flash_backward_sharding(q, k, v, do, causal):
    """The backward's dq, dk, dv split as q, k, v (and dO as q)."""
    return [([p] * 3, [p] * 4 + [None])
            for ([p], _) in flash_sharding(q, k, v, causal)]


def _flash_valid(specs, args) -> bool:
    """Heads split n ways need n | H and n | KV (whole GQA groups per
    shard), and q, k, v (and dO) split alike."""
    q, k = specs[:2]
    n = sharding_rules.shard_count(q, 2)
    return (q.shape[2] % n == 0 and k.shape[2] % n == 0
            and len({tuple(s.placements) for s in specs}) == 1)


sharding_rules.register([torch.ops.repro_torch.flash_attention.default],
                        flash_sharding, _flash_valid)
sharding_rules.register(
    [torch.ops.repro_torch.flash_attention_backward.default],
    flash_backward_sharding, _flash_valid)


def flash_attention_flops(q_shape, k_shape, causal: bool) -> int:
    """The function's work: 4·d flops (q·k and p·v) for each (query, key)
    pair the mask keeps, over B·H heads. With the right-aligned causal mask
    query i keeps max(0, i + Skv - Sq + 1) keys. It does not depend on how
    a kernel tiles the work."""
    B, Sq, H, d = q_shape
    Skv = k_shape[1]
    if causal:
        rows = min(Sq, Skv)            # the rows that see at least one key
        pairs = rows * (rows + 1) // 2 + rows * max(0, Skv - Sq)
    else:
        pairs = Sq * Skv
    return 4 * d * B * H * pairs


backward.register()


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    return flash_attention_flops(q_shape, k_shape, causal)


@register_flop_formula(torch.ops.repro_torch.flash_attention_backward)
def _backward_flops(q_shape, k_shape, v_shape, do_shape, causal, *args,
                    **kwargs) -> int:
    """2.5 times the forward's: S recomputed, then dP, dV, dQ and dK, one
    product each per kept (query, key) pair."""
    return 5 * flash_attention_flops(q_shape, k_shape, causal) // 2


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q: [B, Sq, H, d]; k/v: [B, Skv, KV, d] (GQA) → [B, Sq, H, d] of q's
    type. Runs where the tensors lie. ``block_q`` and ``block_k`` are
    accepted only to keep the JAX package's signature: they are checked
    for being positive and change nothing, since the CUDA kernel uses its
    own tiles and the result does not depend on them."""
    if block_q < 1 or block_k < 1:
        raise ValueError(f"block sizes must be positive, got {block_q}, "
                         f"{block_k}")
    return torch.ops.repro_torch.flash_attention(q, k, v, causal)
