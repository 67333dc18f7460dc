"""The MoE's dispatch and combine (``models/moe.py``): the slot map and
the row gathers through it.

``slot_map(top_e, C, n_experts, n_local, e0)`` places the routing
choices in GShard's sequential-choice order (``SlotMap``). The gathers
read rows of a source ``src`` [R, d], where an index outside [0, R)
reads nothing (a dropped choice, an empty slot):

* ``gather_sum(src, idx, w)``: out[t] = Σ_j w[t, j] · src[idx[t, j]],
  idx [n, k] → [n, d] (w absent: 1);
* ``gather_rows(src, idx, w, widx)``: out[s] = w[widx[s]] · src[idx[s]],
  idx [S] → [S, d], zero where the row or the weight is missing (w
  absent: 1);
* ``gather_dot(src, idx, b)``: out[t, j] = ⟨src[idx[t, j]], b[t]⟩ →
  [n, k] float32.

Products and sums in fp32, rounded to ``src``'s type once. On CUDA
tensors each launches ``kernels/csrc/moe_dispatch.cu`` (counted in
``<function>.launches``), or raises; on CPU tensors it runs the same
function in plain torch (``*_plain``). The kernels replace no TPU
kernel: the JAX package's MoE is plain JAX.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LOAD_BYTES, _MAX_THREADS = 16, 128
# the slot map's block (csrc/moe_dispatch.cu kChunk) and its shared
# memory, (2 + 32) ints an expert, within the default 48 KB
_CHUNK, _MAX_EXPERTS = 1024, 48 * 1024 // (34 * 4)


class SlotMap(NamedTuple):
    """Where each routing choice goes in the [n_local, C] expert buffer,
    and back; choice ``t·k + j`` is token t's j-th. An index one past the
    last means none (dropped, empty)."""
    slot: torch.Tensor    # [T, k]: (e − e0)·C + position, or n_local·C
    tok: torch.Tensor     # [n_local·C]: the token in each slot, or T
    choice: torch.Tensor  # [n_local·C]: the choice in each slot, or T·k
    base: torch.Tensor    # [E]: assignments per expert, dropped ones too


def slot_map_plain(top_e: torch.Tensor, C: int, n_experts: int,
                   n_local: int, e0: int) -> SlotMap:
    """An assignment's position is its rank in a stable sort of the
    assignments (choice-major, then token) by expert, less its expert's
    first rank."""
    T, k = top_e.shape
    dev = top_e.device
    n = k * T
    ef = top_e.t().reshape(-1)                       # a = j·T + t
    se, order = torch.sort(ef, stable=True)
    start = torch.searchsorted(se, torch.arange(n_experts + 1, device=dev))
    base = start[1:] - start[:-1]
    ranks = torch.arange(n, device=dev)
    pos = torch.empty_like(ranks).scatter_(0, order, ranks - start[se])
    keep = (pos < C) & (ef >= e0) & (ef < e0 + n_local)
    slot = torch.where(keep, (ef - e0) * C + pos, n_local * C)
    # the c-th slot of a local expert holds its c-th assignment, if any
    c = torch.arange(C, device=dev)
    filled = (c < base[e0:e0 + n_local, None]).reshape(-1)
    a = order[(start[e0:e0 + n_local, None] + c).clamp(max=n - 1).reshape(-1)]
    t = a % T
    return SlotMap(slot.view(k, T).t().contiguous(),
                   torch.where(filled, t, T),
                   torch.where(filled, t * k + a // T, n), base)


def _padded(src: torch.Tensor) -> torch.Tensor:
    """src with a row of zeros after its last, read by index R."""
    return torch.cat([src, src.new_zeros(1, src.shape[1])])


def gather_sum_plain(src, idx, w=None):
    rows = _padded(src).float()[idx.clamp(0, src.shape[0])]   # [n, k, d]
    if w is not None:
        rows = rows * w[..., None]
    return rows.sum(1).to(src.dtype)


def gather_rows_plain(src, idx, w=None, widx=None):
    rows = _padded(src)[idx.clamp(0, src.shape[0])]
    if w is None:
        return rows
    ws = torch.cat([w, w.new_zeros(1)])[widx.clamp(0, w.numel())]
    return (rows.float() * ws[:, None]).to(src.dtype)


def gather_dot_plain(src, idx, b):
    rows = _padded(src).float()[idx.clamp(0, src.shape[0])]   # [n, k, d]
    return (rows * b.float()[:, None]).sum(-1)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("moe_dispatch")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.moe_slot_map.argtypes = [p, i64, i64, i32, i32, i64, i32, i32,
                                 p, p, p, p, p, p]
    lib.moe_gather_sum.argtypes = [p, i64, i32, p, p, i64, i32, p,
                                   i32, i32, i32, p]
    lib.moe_gather_rows.argtypes = [p, i64, i32, p, p, p, i64, i64, p,
                                    i32, i32, i32, p]
    lib.moe_gather_dot.argtypes = [p, i64, i32, p, p, i64, i32, p,
                                   i32, i32, i32, p]
    for fn in (lib.moe_slot_map, lib.moe_gather_sum, lib.moe_gather_rows,
               lib.moe_gather_dot):
        fn.restype = ctypes.c_int
    lib.moe_dispatch_error_string.argtypes = [ctypes.c_int]
    lib.moe_dispatch_error_string.restype = ctypes.c_char_p
    return lib


def _call(name: str, device: torch.device, *args) -> None:
    """``moe_<name>(*args, stream)`` on ``device``'s current stream."""
    lib = _library()
    with torch.cuda.device(device):
        err = getattr(lib, f"moe_{name}")(
            *args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"moe_{name} launch failed: "
                           f"{lib.moe_dispatch_error_string(err).decode()}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def slot_map(top_e: torch.Tensor, C: int, n_experts: int, n_local: int,
             e0: int) -> SlotMap:
    """top_e [T, k] int64, each row's experts → ``SlotMap``. No host
    sync: decode runs it every token."""
    if top_e.device.type == "cpu":
        return slot_map_plain(top_e, C, n_experts, n_local, e0)
    T, k = top_e.shape
    if top_e.dtype != torch.int64 or top_e.stride(1) != 1:
        raise ValueError("slot_map: top_e must be int64 with unit column "
                         "stride")
    if not (0 < n_experts <= _MAX_EXPERTS and T * k < 2**31):
        raise ValueError(f"slot_map takes up to {_MAX_EXPERTS} experts and "
                         f"2**31 assignments, got {n_experts} and {T * k}")
    dev = top_e.device
    i64 = dict(dtype=torch.int64, device=dev)
    hist = torch.empty((-(-T * k // _CHUNK), n_experts), dtype=torch.int32,
                       device=dev)
    m = SlotMap(torch.empty((T, k), **i64), torch.empty(n_local * C, **i64),
                torch.empty(n_local * C, **i64),
                torch.empty(n_experts, **i64))
    _call("slot_map", dev, top_e.data_ptr(), top_e.stride(0), T, k,
          n_experts, C, e0, n_local, hist.data_ptr(), *map(_ptr, m))
    slot_map.launches += 1
    return m


def _gather(name: str, src: torch.Tensor, operands, *args) -> None:
    """Checks src and the other operands, picks the load width and the
    block, and launches ``moe_gather_<name>(src, *args, ...)``."""
    if src.dtype not in _DTYPE_CODE or src.dim() != 2:
        raise ValueError(f"gather_{name}: src must be a [R, d] float32 or "
                         f"bfloat16 tensor, got {src.dtype} "
                         f"{tuple(src.shape)}")
    present = [t for t in (src, *operands) if t is not None]
    if any(t.dtype not in (src.dtype, torch.int64, torch.float32)
           or t.device != src.device or not t.is_contiguous()
           for t in present):
        raise ValueError(f"gather_{name}: indices int64, weights float32, "
                         f"all contiguous and on {src.device}")
    d, size = src.shape[1], src.element_size()
    wide = d * size % _LOAD_BYTES == 0 and all(
        t.data_ptr() % _LOAD_BYTES == 0 for t in present
        if t.dtype == src.dtype)
    loads = -(-d // (_LOAD_BYTES // size if wide else 1))   # one a thread
    _call(f"gather_{name}", src.device, src.data_ptr(), *args,
          _DTYPE_CODE[src.dtype], int(wide),
          min(_MAX_THREADS, 32 * -(-loads // 32)))


def gather_sum(src: torch.Tensor, idx: torch.Tensor,
               w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """src [R, d], idx [n, k] int64, w [n, k] float32 or None → [n, d]."""
    if src.device.type == "cpu":
        return gather_sum_plain(src, idx, w)
    (n, k), (R, d) = idx.shape, src.shape
    out = torch.empty((n, d), dtype=src.dtype, device=src.device)
    if n:
        _gather("sum", src, (idx, w, out), R, d, _ptr(idx), _ptr(w), n, k,
                _ptr(out))
        gather_sum.launches += 1
    return out


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                w: Optional[torch.Tensor] = None,
                widx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """src [R, d], idx [S] int64, w [n_w] float32 and widx [S] int64, or
    neither → [S, d]."""
    if src.device.type == "cpu":
        return gather_rows_plain(src, idx, w, widx)
    (S,), (R, d) = idx.shape, src.shape
    out = torch.empty((S, d), dtype=src.dtype, device=src.device)
    if S:
        _gather("rows", src, (idx, w, widx, out), R, d, _ptr(idx), _ptr(w),
                _ptr(widx), 0 if w is None else w.numel(), S, _ptr(out))
        gather_rows.launches += 1
    return out


def gather_dot(src: torch.Tensor, idx: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """src [R, d], idx [n, k] int64, b [n, d] of src's type → [n, k]
    float32."""
    if src.device.type == "cpu":
        return gather_dot_plain(src, idx, b)
    (n, k), (R, d) = idx.shape, src.shape
    if b.dtype != src.dtype or b.shape != (n, d):
        raise ValueError(f"gather_dot: b must be [{n}, {d}] {src.dtype}")
    out = torch.empty((n, k), dtype=torch.float32, device=src.device)
    if n:
        _gather("dot", src, (idx, b, out), R, d, _ptr(idx), _ptr(b), n, k,
                _ptr(out))
        gather_dot.launches += 1
    return out


slot_map.launches = 0
gather_sum.launches = 0
gather_rows.launches = 0
gather_dot.launches = 0
