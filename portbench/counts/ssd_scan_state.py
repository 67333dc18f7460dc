"""``repro_torch::ssd_scan_state(x, dt, A, B, C, chunk)`` -> y and the
final state, float32 [B, H, P, N]: ``ssd_scan``'s work and bytes, and the
state written."""
from __future__ import annotations

from portbench.counts import ssd_scan
from portbench.counts._common import tensor_bytes

registered_flops = ssd_scan.registered_flops
flops = ssd_scan.flops


def nbytes(shapes, dtypes) -> int:
    Bb, _, H, P = shapes[0]
    return ssd_scan.nbytes(shapes, dtypes) + tensor_bytes(
        (Bb, H, P, shapes[3][3]), "float")
