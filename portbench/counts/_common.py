"""Bytes of an op call from its inputs' shapes and types (as the
profiler records them), each byte read once and each result byte
written once."""
from __future__ import annotations

import math

from portbench.harness.trace import ITEMSIZE


def tensor_bytes(shape, dtype: str) -> int:
    return math.prod(shape) * ITEMSIZE[dtype]


def causal_pairs(Sq: int, Skv: int) -> int:
    """(query, key) pairs a right-aligned causal mask keeps."""
    rows = min(Sq, Skv)
    return rows * (rows + 1) // 2 + rows * max(0, Skv - Sq)
