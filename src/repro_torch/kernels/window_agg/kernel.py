"""Segment reduction — the hot loop of the paper's stream services and of
the VDC offload (``pipeline/queries.py``).

``segment_reduce(x, agg=, stride=)`` maps ``x[T, C]`` to
``[T // stride, C]``: the max, min or sum of each run of ``stride`` rows,
accumulated in fp32 and rounded to ``x.dtype`` once per segment. Rows
after ``(T // stride) · stride`` are ignored.

On a CUDA tensor it launches the CUDA C++ kernel of
``kernels/csrc/window_agg.cu`` (the port of the JAX package's Pallas
``segment_reduce_tc``), or raises; on a CPU tensor it runs
``segment_reduce_plain``, the same function in plain torch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

# fill values of the reductions (the JAX package's padding constants)
INIT = {"max": -3.4e38, "min": 3.4e38, "sum": 0.0}

_AGG_CODE = {"max": 0, "min": 1, "sum": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_COLS, _ROWS = 32, 8            # the block of csrc/window_agg.cu (kCols, kRows)
_BLOCKS_PER_SM = 2048 // (_COLS * _ROWS)
_MIN_ROWS_PER_SPLIT = 4 * _ROWS  # one unrolled step for every row lane
_MAX_GRID_X, _MAX_GRID_Y = 2**31 - 1, 65535


def _check(x: torch.Tensor, agg: str, stride: int) -> None:
    if agg not in _AGG_CODE:
        raise ValueError(f"agg must be one of {sorted(_AGG_CODE)}, got {agg!r}")
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be [T, C] with C >= 1, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if stride < 1 or x.shape[0] < stride:
        raise ValueError(f"need 1 <= stride <= T, got stride={stride}, "
                         f"T={x.shape[0]}")


def segment_reduce_plain(x: torch.Tensor, *, agg: str, stride: int
                         ) -> torch.Tensor:
    """The kernel's function in plain torch: a view to [n_seg, stride, C],
    then amax, amin or sum in fp32."""
    _check(x, agg, stride)
    n_seg = x.shape[0] // stride
    v = x[:n_seg * stride].reshape(n_seg, stride, x.shape[1]).float()
    r = {"max": torch.amax, "min": torch.amin, "sum": torch.sum}[agg](v, 1)
    return r.to(x.dtype)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_rows(stride: int, blocks: int, sms: int) -> tuple:
    """(n_split, rows_per_split): cut each segment's ``stride`` rows so
    that the grid has about one full wave of blocks (``blocks`` without
    the split) on ``sms`` SMs, with at least one unrolled step per row
    lane in each split. Every split is non-empty."""
    want = -(-_BLOCKS_PER_SM * sms // blocks)
    most = max(1, stride // _MIN_ROWS_PER_SPLIT)
    n_split = max(1, min(want, most, _MAX_GRID_Y))
    rows = -(-stride // n_split)
    return -(-stride // rows), rows


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("window_agg")
    fn = lib.window_agg_segment_reduce
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.window_agg_error_string.argtypes = [ctypes.c_int]
    lib.window_agg_error_string.restype = ctypes.c_char_p
    return lib


def segment_reduce(x: torch.Tensor, *, agg: str, stride: int) -> torch.Tensor:
    """x: [T, C] float32 or bfloat16 → [T // stride, C] of x.dtype;
    agg ∈ {max, min, sum}. CUDA tensors go to the kernel (counted in
    ``segment_reduce.launches``), CPU tensors to the plain version."""
    if x.device.type == "cpu":
        return segment_reduce_plain(x, agg=agg, stride=stride)
    if x.device.type != "cuda":
        raise ValueError(f"segment_reduce takes CPU or CUDA tensors, got "
                         f"{x.device}")
    _check(x, agg, stride)
    if not x.is_contiguous():
        raise ValueError("segment_reduce's kernel needs a contiguous x")
    T, C = x.shape
    n_seg = T // stride
    tiles = -(-C // _COLS)
    if n_seg * tiles > _MAX_GRID_X:
        raise ValueError(f"[{T}, {C}] with stride {stride} is too many "
                         f"segments for one launch")
    n_split, rows = split_rows(stride, n_seg * tiles,
                               _sm_count(x.device.index))
    out = torch.empty((n_seg, C), dtype=x.dtype, device=x.device)
    part = torch.empty((n_split, n_seg, C), dtype=torch.float32,
                       device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.window_agg_segment_reduce(
            x.data_ptr(), out.data_ptr(), part.data_ptr(),
            _DTYPE_CODE[x.dtype], _AGG_CODE[agg], C, stride, n_seg, n_split,
            rows, stream)
    if err:
        raise RuntimeError("window_agg kernel launch failed: "
                           f"{lib.window_agg_error_string(err).decode()}")
    segment_reduce.launches += 1
    return out


segment_reduce.launches = 0
