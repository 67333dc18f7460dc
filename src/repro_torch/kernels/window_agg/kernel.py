"""Segment reduction — the hot loop of the paper's stream services and of
the VDC offload (``pipeline/queries.py``).

``segment_reduce(x, agg=, stride=)`` maps ``x[T, C]`` to
``[T // stride, C]``: the max, min or sum of each run of ``stride`` rows,
accumulated in fp32 and rounded to ``x.dtype`` once per segment. Rows
after ``(T // stride) · stride`` are ignored.

On a CUDA tensor it launches the CUDA C++ kernel of
``kernels/csrc/window_agg.cu`` (the port of the JAX package's Pallas
``segment_reduce_tc``), or raises; on a CPU tensor it runs
``segment_reduce_plain``, the same function in plain torch. How the
kernel covers a shape (load width, warps per item, splits) is
``launch_plan``, a pure function of the shape.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build

# fill values of the reductions (the JAX package's padding constants)
INIT = {"max": -3.4e38, "min": 3.4e38, "sum": 0.0}

_AGG_CODE = {"max": 0, "min": 1, "sum": 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's constants (csrc/window_agg.cu): warps of a block, loads in
# flight per thread, bytes of a wide load
_WARPS, _UNROLL, _LOAD_BYTES = 8, 8, 16
# the plan's choices: at or above this many (segment, column tile) items
# per SM each warp owns whole items; below it a block's warps share one
# item, with about _BLOCKS_PER_SM blocks an SM once the rows are split
_WARP_ITEMS_PER_SM = 16
_BLOCKS_PER_SM = 4
_MAX_GRID_X, _MAX_GRID_Y = 2**31 - 1, 65535


class LaunchPlan(NamedTuple):
    """How ``csrc/window_agg.cu`` covers one call: ``vec`` columns per
    thread (one 16-byte load, or 1 element), ``lanes`` warps per (segment,
    column tile) item, each segment's rows cut into ``n_split`` splits of
    ``rows``, ``grid`` = (blocks along the items, n_split). With
    ``n_split == 1`` the pass writes the output and there are no
    partials."""
    vec: int
    lanes: int
    n_split: int
    rows: int
    grid: Tuple[int, int]

    @property
    def partials(self) -> bool:
        return self.n_split > 1


def launch_plan(T: int, C: int, stride: int, elsize: int, aligned: bool,
                sms: int) -> LaunchPlan:
    """The launch of ``segment_reduce`` on x [T, C] of ``elsize`` bytes an
    element, whose pointer is 16-byte aligned or not, on ``sms`` SMs: a
    pure function of these, so that the CPU tests cover it.

    16-byte loads when every row starts 16-byte aligned. Many items (the
    fleet): a warp per item, no split. Few (the Q2 fold): the block's
    warps share an item, and each segment is split so that about
    ``_BLOCKS_PER_SM`` blocks run on each SM, every row lane with at least
    one unrolled step in each split; every split is non-empty."""
    vec = (_LOAD_BYTES // elsize
           if aligned and C * elsize % _LOAD_BYTES == 0 else 1)
    items = (T // stride) * -(-C // (32 * vec))
    if items >= _WARP_ITEMS_PER_SM * sms:
        return LaunchPlan(vec, 1, 1, stride,
                          (min(-(-items // _WARPS), _MAX_GRID_X), 1))
    want = -(-_BLOCKS_PER_SM * sms // items)
    most = max(1, stride // (_WARPS * _UNROLL))
    n_split = max(1, min(want, most, _MAX_GRID_Y))
    rows = -(-stride // n_split)
    n_split = -(-stride // rows)
    return LaunchPlan(vec, _WARPS, n_split, rows, (items, n_split))


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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("window_agg")
    fn = lib.window_agg_segment_reduce
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_int64] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.window_agg_error_string.argtypes = [ctypes.c_int]
    lib.window_agg_error_string.restype = ctypes.c_char_p
    return lib


def segment_reduce(x: torch.Tensor, *, agg: str, stride: int) -> torch.Tensor:
    """x: [T, C] float32 or bfloat16 → [T // stride, C] of x.dtype;
    agg ∈ {max, min, sum}. CUDA tensors go to the kernel, counted in
    ``segment_reduce.launches`` and, by load width, in
    ``segment_reduce.vector_launches`` (16-byte loads) or
    ``segment_reduce.scalar_launches`` (one element per load); CPU tensors
    go to the plain version."""
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
    plan = launch_plan(T, C, stride, x.element_size(), x.data_ptr() % 16 == 0,
                       _sm_count(x.device.index))
    out = torch.empty((n_seg, C), dtype=x.dtype, device=x.device)
    part = (torch.empty((plan.n_split, n_seg, C), dtype=torch.float32,
                        device=x.device) if plan.partials else None)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.window_agg_segment_reduce(
            x.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), _DTYPE_CODE[x.dtype],
            _AGG_CODE[agg], int(plan.vec > 1), plan.lanes, C, stride, n_seg,
            plan.n_split, plan.rows, plan.grid[0], stream)
    if err:
        raise RuntimeError("window_agg kernel launch failed: "
                           f"{lib.window_agg_error_string(err).decode()}")
    segment_reduce.launches += 1
    if plan.vec > 1:
        segment_reduce.vector_launches += 1
    else:
        segment_reduce.scalar_launches += 1
    return out


segment_reduce.launches = 0
segment_reduce.vector_launches = 0
segment_reduce.scalar_launches = 0
