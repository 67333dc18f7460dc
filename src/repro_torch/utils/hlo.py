"""HLO-text collective analysis.

``cost_analysis()`` has no collective-traffic entry, so the roofline's
collective term is derived by parsing the compiled (post-SPMD, per-device)
HLO: every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute op contributes ring-model bytes-on-the-wire.

Shapes in the compiled module are already per-partition, so the sums are
per-device traffic — exactly what the per-chip link bandwidth divides.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "f8e4m3": 1, "f8e4m3b11fnuz": 1, "f8e5m2fnuz": 1,
    "f8e4m3fnuz": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

# e.g. "bf16[16,4096,128]{2,1,0}" or "f32[]"
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)
# matches "%name = <shape or tuple> kind(" — kind may have -start suffix
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(.+?)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start|-done)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\{?\{([\d,\s]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(shape_str: str) -> int:
    """Sum bytes over all array shapes appearing in a (possibly tuple) type."""
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dtype, dims = m.group(1), m.group(2)
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        return len([x for x in m.group(1).split(",") if x.strip()])
    return 2


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Ring-model per-device bytes moved for each collective op.

    all-reduce: 2·size·(g−1)/g (reduce-scatter + all-gather phases);
    all-gather: out·(g−1)/g; reduce-scatter: in·(g−1)/g;
    all-to-all: size·(g−1)/g; collective-permute: size.
    """
    counts: Dict[str, int] = {k: 0 for k in _COLLECTIVE_KINDS}
    nbytes: Dict[str, float] = {k: 0.0 for k in _COLLECTIVE_KINDS}
    for line in hlo_text.splitlines():
        if "-done(" in line:  # async pair: count the -start only
            continue
        m = _OP_RE.match(line)
        if not m:
            continue
        shape_str, kind = m.group(1), m.group(2)
        size = _shape_bytes(shape_str)
        g = _group_size(line)
        frac = (g - 1) / g if g > 0 else 1.0
        if kind == "all-reduce":
            moved = 2 * size * frac
        elif kind == "collective-permute":
            moved = size
        else:
            moved = size * frac
        counts[kind] += 1
        nbytes[kind] += moved
    return CollectiveStats(counts=counts, bytes_by_kind=nbytes)


def count_op(hlo_text: str, opname: str) -> int:
    return len(re.findall(rf"\b{re.escape(opname)}\(", hlo_text))
