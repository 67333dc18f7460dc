"""Causal flash attention on the card.

``flash_attention_bshd(q, k, v, causal=)`` launches one of two CUDA C++
kernels, the ports of the JAX package's Pallas ``flash_attention_bhsd``:
bf16 goes to ``kernels/csrc/flash_attention_sm90.cu`` (wgmma fed by TMA,
``flash_attention_wgmma``), float32 to ``kernels/csrc/flash_attention.cu``
(FMA on the CUDA cores, ``flash_attention_fma``). Both read the model layout
(q [B, Sq, H, d], k/v [B, Skv, KV, d]) where it lies, resolve GQA by index
and mask ``Skv`` themselves, so nothing is transposed, repeated or padded
first. They take CUDA tensors only and raise on what the kernels do not
take; the plain version is ``ref.attention_reference``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535


def _bind(name: str, entry: str) -> ctypes.CDLL:
    lib = build.load(name)
    fn = getattr(lib, f"{entry}_forward")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{entry}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_fma() -> ctypes.CDLL:
    return _bind("flash_attention", "flash_attention")


@functools.cache
def _library_wgmma() -> ctypes.CDLL:
    lib = _bind("flash_attention_sm90", "flash_attention_sm90")
    lib.flash_attention_sm90_query_tile.argtypes = []
    lib.flash_attention_sm90_query_tile.restype = ctypes.c_int
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


def _launch(lib: ctypes.CDLL, entry: str, q, k, v, causal: bool):
    B, Sq, H, d = q.shape
    _, Skv, KV, _ = k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"{entry}_forward")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
            Sq, Skv, d, int(causal), 1.0 / math.sqrt(d), stream)
    if err:
        msg = getattr(lib, f"{entry}_error_string")(err).decode()
        raise RuntimeError(f"{entry} kernel launch failed: {msg} ({err})")
    return out


def flash_attention_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The bf16 kernel (wgmma + TMA) on bf16 q, k, v as
    ``flash_attention_bshd`` takes them. Counted in
    ``flash_attention_wgmma.launches``."""
    _check(q, k, v, torch.bfloat16)
    lib = _library_wgmma()
    _check_grid(q, -(-q.shape[1] // lib.flash_attention_sm90_query_tile()))
    out = _launch(lib, "flash_attention_sm90", q, k, v, causal)
    flash_attention_wgmma.launches += 1
    return out


def flash_attention_fma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """The float32 kernel (CUDA-core FMA) on float32 q, k, v as
    ``flash_attention_bshd`` takes them. Counted in
    ``flash_attention_fma.launches``."""
    _check(q, k, v, torch.float32)
    _check_grid(q, q.shape[0] * q.shape[2])
    out = _launch(_library_fma(), "flash_attention", q, k, v, causal)
    flash_attention_fma.launches += 1
    return out


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q: [B, Sq, H, d]; k/v: [B, Skv, KV, d], contiguous CUDA tensors of
    one type (float32 or bfloat16), d ∈ {32, 64, 128} → [B, Sq, H, d] of
    q's type: bf16 through ``flash_attention_wgmma``, anything else through
    ``flash_attention_fma``, which raises unless it is float32. Counted in
    ``flash_attention_bshd.launches`` as well as in the kernel's own
    counter."""
    kernel = (flash_attention_wgmma if q.dtype == torch.bfloat16
              else flash_attention_fma)
    out = kernel(q, k, v, causal)
    flash_attention_bshd.launches += 1
    return out


flash_attention_bshd.launches = 0
flash_attention_wgmma.launches = 0
flash_attention_fma.launches = 0
