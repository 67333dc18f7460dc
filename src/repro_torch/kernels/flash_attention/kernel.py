"""Causal flash attention on the card.

``flash_attention_bshd(q, k, v, causal=)`` launches the CUDA C++ kernel
of ``kernels/csrc/flash_attention.cu``, the port of the JAX package's
Pallas ``flash_attention_bhsd``. It reads the model layout
(q [B, Sq, H, d], k/v [B, Skv, KV, d]) where it lies, resolves GQA by
index and masks ``Skv`` itself, so nothing is transposed, repeated or
padded first. It takes CUDA tensors only and raises on what the kernel
does not take; the plain version is ``ref.attention_reference``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_int64] * 6 + [
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if B * H > _MAX_GRID_Y:
        raise ValueError(f"B * H = {B * H} is too many heads for one launch")


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """q: [B, Sq, H, d]; k/v: [B, Skv, KV, d], contiguous CUDA tensors of
    one type (float32 or bfloat16), d ∈ {32, 64, 128} → [B, Sq, H, d] of
    q's type. Counted in ``flash_attention_bshd.launches``."""
    _check(q, k, v)
    tensors = (q, k, v)
    if any(t.device.type != "cuda" or t.device != q.device for t in tensors):
        raise ValueError("flash_attention_bshd's kernel takes CUDA tensors on "
                         f"one device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("flash_attention_bshd's kernel needs contiguous, "
                         "16-byte aligned q, k, v")
    B, Sq, H, d = q.shape
    _, Skv, KV, _ = k.shape
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], B, H, KV, Sq, Skv, d, int(causal),
            1.0 / math.sqrt(d), stream)
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")
    flash_attention_bshd.launches += 1
    return out


flash_attention_bshd.launches = 0
