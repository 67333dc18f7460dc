"""``repro_torch::flash_attention_backward(q, k, v, do, causal)`` ->
dq, dk, dv of q's, k's and v's shapes and types.

Operations: 2.5 times the forward's, the program's registered formula
(frozen here): S recomputed (P is not an input), then dP, dV, dQ and dK,
one product each per kept pair. Bytes: q, k, v, dO read; dq, dk, dv
written."""
from __future__ import annotations

from portbench.counts import flash_attention as fwd
from portbench.counts._common import tensor_bytes


def registered_flops(q_shape, k_shape, causal: bool) -> int:
    return 5 * fwd.registered_flops(q_shape, k_shape, causal) // 2


def flops(shapes, causal: bool = True) -> int:
    return registered_flops(shapes[0], shapes[1], causal)


def nbytes(shapes, dtypes) -> int:
    q, k, v, do = shapes[:4]
    return (2 * (tensor_bytes(q, dtypes[0]) + tensor_bytes(k, dtypes[1])
                 + tensor_bytes(v, dtypes[2])) + tensor_bytes(do, dtypes[3]))
