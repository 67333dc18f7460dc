"""``repro_torch::ssd_scan_backward(x, dt, A, B, C, chunk, dy)`` -> dx,
ddt, dA, dB, dC of their inputs' shapes and types.

Operations: three times the forward's, as the program registers it
(``registered_flops``, frozen here) and as the recurrence's least work
is: the states recomputed (2·N·P a step and head), the state's adjoint
carried back (2·N·P), and dx, dB, dC and the decay's gradient read from
it (2·N·P each), against the forward's 4·N·P. Bytes: x, dt, A, B, C, dy
read; the five gradients written."""
from __future__ import annotations

from portbench.counts import ssd_scan
from portbench.counts._common import tensor_bytes


def registered_flops(x_shape, b_shape, chunk: int) -> int:
    return 3 * ssd_scan.registered_flops(x_shape, b_shape, chunk)


def flops(shapes) -> int:
    return 3 * ssd_scan.flops(shapes)


def nbytes(shapes, dtypes) -> int:
    ins = [(s, d) for s, d in zip(shapes, dtypes) if s][:5]
    dy = (shapes[6], dtypes[6])
    return 2 * sum(tensor_bytes(s, d) for s, d in ins) + tensor_bytes(*dy)
