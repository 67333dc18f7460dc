"""``repro_torch::ssd_scan(x, dt, A, B, C, chunk)``: x [B, L, H, P], dt
[B, L, H], A [H], B, C [B, L, G, N] -> y of x's shape and type.

Operations: the least work, that of the recurrence h <- e^(dt·A)·h +
dt·x·Bᵀ, y = C·h: 4·N·P per step and head. The program registers the
chunked form's count at the caller's chunk (``registered_flops``, frozen
here), which is more than a kernel over shorter chunks does, so it is
not a roofline's count. Bytes: x, dt, A, B, C read, y written."""
from __future__ import annotations

from portbench.counts._common import tensor_bytes


def registered_flops(x_shape, b_shape, chunk: int) -> int:
    Bb, L, H, P = x_shape
    N, Q = b_shape[3], chunk
    per_chunk = 2 * Q * Q * N + 2 * Q * Q * P + 4 * Q * N * P
    return Bb * H * (-(-L // Q)) * per_chunk


def flops(shapes) -> int:
    Bb, L, H, P = shapes[0]
    return 4 * shapes[3][3] * P * Bb * L * H


def nbytes(shapes, dtypes) -> int:
    return (sum(tensor_bytes(s, d) for s, d in zip(shapes[:5], dtypes[:5]))
            + tensor_bytes(shapes[0], dtypes[0]))
