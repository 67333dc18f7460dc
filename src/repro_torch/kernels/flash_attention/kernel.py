"""Causal flash attention on the card.

``flash_attention_bshd(q, k, v, causal=)`` launches one of two CUDA C++
kernels, the ports of the JAX package's Pallas ``flash_attention_bhsd``,
both on the tensor cores (wgmma fed by TMA): bf16 goes to
``kernels/csrc/flash_attention_sm90.cu`` (``flash_attention_wgmma``),
float32 to ``kernels/csrc/flash_attention_sm90_f32.cu``
(``flash_attention_3xtf32``), which splits each fp32 operand into two
TF32 parts and sums three TF32 products, so that it stays within the
JAX package's fp32 tolerance (2e-5) where one TF32 product would not.
Both read the model layout (q [B, Sq, H, d], k/v [B, Skv, KV, d]) where
it lies, resolve GQA by index and mask ``Skv`` themselves, so nothing is
repeated or padded first; the fp32 kernel's pre-pass writes the split
parts of K and of V transposed into scratch that the wrapper allocates.
They take CUDA tensors only and raise on what the kernels do not take;
the plain version is ``ref.attention_reference``.

Head dim 16 (every ``reduced()`` configuration's): bf16 runs on the wgmma
kernel with 32-column tiles whose 16 columns past d TMA fills with zeros,
float32 on the kernel of ``kernels/csrc/flash_d16.cuh``
(``flash_attention_d16``): 3xTF32 on warp-level ``mma.sync``, its
operands split in registers and K/V staged by ``cp.async``, so it needs
neither the pre-pass nor its scratch.

``flash_attention_backward_wgmma(q, k, v, do, causal)`` launches the bf16
backward, ``kernels/csrc/flash_attention_bwd_sm90.cu`` (two passes on
wgmma fed by TMA: lse, D and dq, then dk and dv), at every head dim the
forward takes; its plain version is ``backward.flash_attention_backward``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535
# the tile queries of flash_attention_sm90_f32.cu
_F32_TILES = ("query", "key", "d16_query")


@functools.cache
def _library(name: str, n_ptrs: int, tiles: tuple,
             entry: str = "forward") -> ctypes.CDLL:
    """The built ``csrc/<name>.cu``, bound by ``_bind``."""
    return _bind(build.load(name), name, n_ptrs, tiles, entry)


def _bind(lib: ctypes.CDLL, name: str, n_ptrs: int, tiles: tuple,
          entry: str = "forward") -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/<name>.cu``) with its ``<name>_<entry>``
    (``n_ptrs`` device pointers, then B, H, KV, Sq, Skv, d, causal, scale,
    stream), its ``<name>_error_string`` and its ``<name>_<tile>_tile``
    queries bound."""
    fn = getattr(lib, f"{name}_{entry}")
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int64] * 6 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    for tile in tiles:
        query = getattr(lib, f"{name}_{tile}_tile")
        query.argtypes = []
        query.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           dtype: torch.dtype) -> None:
    """Raises unless q, k, v are what the kernel of ``dtype`` takes."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B, Sq, H, d] and k, v [B, Skv, KV, d], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or Sq < 1 or k.shape[1] < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if k.shape[2] < 1 or H % k.shape[2]:
        raise ValueError(f"H = {H} must be a multiple of KV = {k.shape[2]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim must be one of {HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dtype != dtype:
        raise ValueError(f"this kernel takes {dtype}, got {q.dtype}")
    tensors = (q, k, v)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_attention_bshd's kernels take CUDA tensors on "
                         f"one device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("flash_attention_bshd's kernels need contiguous, "
                         "16-byte aligned q, k, v")


def _check_grid(q: torch.Tensor, grid_y: int) -> None:
    if grid_y > _MAX_GRID_Y:
        raise ValueError(f"q {tuple(q.shape)} needs {grid_y} > {_MAX_GRID_Y} "
                         "blocks along one launch dimension")


def _launch(lib: ctypes.CDLL, name: str, kernel: str, ptrs: tuple, q, k,
            causal: bool, entry: str = "forward") -> None:
    """Calls ``<name>_<entry>`` on ``ptrs`` and q's and k's shapes on the
    current stream of q's device; raises with the library's message."""
    B, Sq, H, d = q.shape
    _, Skv, KV, _ = k.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{name}_{entry}")(
            *ptrs, B, H, KV, Sq, Skv, d, int(causal), 1.0 / math.sqrt(d),
            stream)
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")


def flash_attention_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The bf16 kernel (wgmma + TMA) on bf16 q, k, v as
    ``flash_attention_bshd`` takes them. Counted in
    ``flash_attention_wgmma.launches``."""
    _check(q, k, v, torch.bfloat16)
    lib = _library("flash_attention_sm90", 4, ("query",))
    _check_grid(q, -(-q.shape[1] // lib.flash_attention_sm90_query_tile()))
    out = torch.empty_like(q)
    _launch(lib, "flash_attention_sm90", "flash_attention_wgmma",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()), q, k,
            causal)
    flash_attention_wgmma.launches += 1
    return out


def flash_attention_3xtf32(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, causal: bool = True
                           ) -> torch.Tensor:
    """The float32 kernel (3xTF32 on wgmma + TMA) on float32 q, k, v as
    ``flash_attention_bshd`` takes them. Its pre-pass writes K's tf32 hi
    and lo parts and V's, transposed to [B, KV, d, Skv_pad], into scratch
    allocated here (twice the bytes of k and v). Counted in
    ``flash_attention_3xtf32.launches``."""
    _check(q, k, v, torch.float32)
    lib = _library("flash_attention_sm90_f32", 8, _F32_TILES)
    B, Sq, H, d = q.shape
    _, Skv, KV, _ = k.shape
    _check_grid(q, max(-(-Sq // lib.flash_attention_sm90_f32_query_tile()),
                       B * KV))
    key_tile = lib.flash_attention_sm90_f32_key_tile()
    skv_pad = -(-Skv // key_tile) * key_tile
    out = torch.empty_like(q)
    k_parts = torch.empty((2, *k.shape), dtype=k.dtype, device=k.device)
    vt_parts = torch.empty((2, B, KV, d, skv_pad), dtype=v.dtype,
                           device=v.device)
    _launch(lib, "flash_attention_sm90_f32", "flash_attention_3xtf32",
            (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             k_parts[0].data_ptr(), k_parts[1].data_ptr(),
             vt_parts[0].data_ptr(), vt_parts[1].data_ptr()), q, k, causal)
    flash_attention_3xtf32.launches += 1
    return out


def flash_attention_d16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """The head-dim-16 kernel (``csrc/flash_d16.cuh``: 3xTF32 on
    ``mma.sync``) on float32 q, k, v as ``flash_attention_bshd`` takes
    them (bf16 runs d 16 on ``flash_attention_wgmma``); it needs no
    scratch. Counted in ``flash_attention_d16.launches``."""
    if q.dim() != 4 or q.shape[3] != 16:
        raise ValueError(f"flash_attention_d16 takes head dim 16, got q "
                         f"{tuple(q.shape)}")
    _check(q, k, v, torch.float32)
    name = "flash_attention_sm90_f32"
    lib = _library(name, 8, _F32_TILES)
    _check_grid(q, -(-q.shape[1]
                     // lib.flash_attention_sm90_f32_d16_query_tile()))
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    _launch(lib, name, "flash_attention_d16", ptrs + (None,) * 4, q, k,
            causal)
    flash_attention_d16.launches += 1
    return out


def flash_attention_backward_wgmma(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, do: torch.Tensor,
                                   causal: bool = True):
    """The bf16 backward kernel (wgmma + TMA) on bf16 q, k, v as
    ``flash_attention_bshd`` takes them and dO of q's shape, type and
    layout → (dq, dk, dv) in the layouts of q, k and v. Counted in
    ``flash_attention_backward_wgmma.launches``; ``backward_launch`` does
    the work."""
    _check_backward(q, k, v, do)
    out = backward_launch(_library("flash_attention_bwd_sm90", 9,
                                   ("query", "key"), "backward"),
                          q, k, v, do, causal)
    flash_attention_backward_wgmma.launches += 1
    return out


def backward_launch(lib: ctypes.CDLL, q, k, v, do, causal: bool):
    """The backward on ``lib``, a bound build of
    ``csrc/flash_attention_bwd_sm90.cu``, on inputs that
    ``_check_backward`` passed, counting nothing. The row statistics that
    pass 1 hands to pass 2 (lse and D, float32 [B, H, Sq_pad], Sq_pad =
    Sq rounded up to the query tile) go to scratch allocated here. Both
    passes run on the current stream of q's device; reruns are
    bit-identical."""
    name = "flash_attention_bwd_sm90"
    B, Sq, H, _ = q.shape
    Skv = k.shape[1]
    tile = lib.flash_attention_bwd_sm90_query_tile()
    _check_grid(q, max(-(-Sq // tile),
                       -(-Skv // lib.flash_attention_bwd_sm90_key_tile())))
    sq_pad = -(-Sq // tile) * tile
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stats = torch.empty((2, B, H, sq_pad), dtype=torch.float32,
                        device=q.device)
    _launch(lib, name, "flash_attention_backward_wgmma",
            tuple(t.data_ptr() for t in (q, k, v, do, dq, dk, dv, stats[0],
                                         stats[1])), q, k, causal,
            entry="backward")
    return dq, dk, dv


def _check_backward(q, k, v, do) -> None:
    """Raises unless q, k, v, dO are what the backward kernel takes."""
    _check(q, k, v, torch.bfloat16)
    if (do.shape != q.shape or do.dtype != q.dtype or do.device != q.device
            or not do.is_contiguous() or do.data_ptr() % 16):
        raise ValueError(f"dO must be a contiguous, 16-byte aligned tensor "
                         f"of q's shape, type and device, got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}")


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q: [B, Sq, H, d]; k/v: [B, Skv, KV, d], contiguous CUDA tensors of
    one type (float32 or bfloat16), d ∈ {16, 32, 64, 128} → [B, Sq, H, d]
    of q's type: bf16 through ``flash_attention_wgmma``, float32 at d 16
    through ``flash_attention_d16``, anything else through
    ``flash_attention_3xtf32``, which raises unless it is float32. Counted in
    ``flash_attention_bshd.launches`` as well as in the kernel's own
    counter."""
    if q.dtype == torch.bfloat16:
        kernel = flash_attention_wgmma
    elif q.dim() == 4 and q.shape[3] == 16:
        kernel = flash_attention_d16
    else:
        kernel = flash_attention_3xtf32
    out = kernel(q, k, v, causal)
    flash_attention_bshd.launches += 1
    return out


flash_attention_bshd.launches = 0
flash_attention_wgmma.launches = 0
flash_attention_3xtf32.launches = 0
flash_attention_d16.launches = 0
flash_attention_backward_wgmma.launches = 0
