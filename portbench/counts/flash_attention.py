"""``repro_torch::flash_attention(q, k, v, causal)``: q [B, Sq, H, d],
k, v [B, Skv, KV, d] -> o of q's shape and type.

Operations: q·kᵀ and p·v, 4·d for each (query, key) pair the mask keeps,
over B·H heads: the program's registered formula
(``flash_attention_flops``, frozen here), which is also the least work.
Bytes: q, k, v read, o written."""
from __future__ import annotations

from portbench.counts._common import causal_pairs, tensor_bytes


def registered_flops(q_shape, k_shape, causal: bool) -> int:
    B, Sq, H, d = q_shape
    Skv = k_shape[1]
    pairs = causal_pairs(Sq, Skv) if causal else Sq * Skv
    return 4 * d * B * H * pairs


def flops(shapes, causal: bool = True) -> int:
    return registered_flops(shapes[0], shapes[1], causal)


def nbytes(shapes, dtypes) -> int:
    q, k, v = shapes[:3]
    return (2 * tensor_bytes(q, dtypes[0]) + tensor_bytes(k, dtypes[1])
            + tensor_bytes(v, dtypes[2]))
