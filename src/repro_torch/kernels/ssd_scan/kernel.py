"""Mamba-2 SSD chunk scan on the card.

``ssd_scan_blh(x, dt, A, B_, C, return_state=)`` launches the CUDA C++
kernel of
``kernels/csrc/ssd_scan.cu``, the port of the JAX package's Pallas
``ssd_scan_bhl``: three launches (chunk states, state passing, chunk
outputs) over chunks of the kernel's own length (``ssd_scan_chunk()`` in
the source), with the states' scratch allocated here. bf16 goes through
``ssd_scan_wgmma`` (the chunk products on the tensor cores), float32
through ``ssd_scan_fma`` (on the CUDA cores). With ``return_state`` the
state-passing launch also writes the state after the last step, float32
[B, H, P, N], as the model's prefill caches it. It reads the model
layout (x [B, L, H, P], dt [B, L, H], A [H], B_/C [B, L, G, N]) where it
lies and reads B_ and C by group, so nothing is transposed, repeated or
padded first. It takes CUDA tensors only and raises on what the kernel
does not take; the plain version is ``ref.ssd_scan_reference``.

``ssd_scan_backward_wgmma(x, dt, A, B_, C, dy)`` launches the bf16
backward, ``kernels/csrc/ssd_scan_bwd_sm90.cu`` (the forward's states
recomputed, each chunk's state cotangent, a reverse pass over the chunks,
one adjoint per chunk and block of heads on wgmma, the sums over the
blocks), with its scratch allocated here; its plain version is
``backward.ssd_scan_backward``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_DIM = 128                   # P and N: csrc/ssd_scan.cu kMaxDim
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.ssd_scan_forward
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] + [
        ctypes.c_int64] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssd_scan_chunk.argtypes = []
    lib.ssd_scan_chunk.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, dt, A, B_, C, dtype: torch.dtype) -> None:
    """Raises unless the inputs are what the kernel of ``dtype`` takes."""
    if x.dim() != 4 or B_.dim() != 4 or B_.shape != C.shape:
        raise ValueError(f"need x [B, L, H, P] and B_, C [B, L, G, N], got "
                         f"{tuple(x.shape)}, {tuple(B_.shape)}, {tuple(C.shape)}")
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if dt.shape != (Bb, L, H) or A.shape != (H,) or B_.shape[:2] != (Bb, L):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)} or B_ "
                         f"{tuple(B_.shape)} disagree with x {tuple(x.shape)}")
    if G < 1 or H % G:
        raise ValueError(f"H = {H} must be a multiple of G = {G}")
    if not (1 <= P <= MAX_DIM and 1 <= N <= MAX_DIM):
        raise ValueError(f"need 1 <= P, N <= {MAX_DIM}, got P={P}, N={N}")
    if x.dtype not in _DTYPE_CODE or B_.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x, B_, C must all be float32 or all bfloat16, got "
                         f"{x.dtype}, {B_.dtype}, {C.dtype}")
    if x.dtype != dtype:
        raise ValueError(f"this kernel takes {dtype}, got {x.dtype}")
    if not (dt.is_floating_point() and A.is_floating_point()):
        raise ValueError("dt and A must be floating point")
    if Bb * H > _MAX_GRID_Y:
        raise ValueError(f"B * H = {Bb * H} is too many heads for one launch")
    tensors = (x, dt, A, B_, C)
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("ssd_scan_blh's kernel takes CUDA tensors on one "
                         f"device, got {[str(t.device) for t in tensors]}")
    if not (x.is_contiguous() and B_.is_contiguous() and C.is_contiguous()):
        raise ValueError("ssd_scan_blh's kernel needs contiguous x, B_, C")


def _launch(x, dt, A, B_, C, return_state: bool):
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    dt32 = dt.float().contiguous()
    A32 = A.float().contiguous()
    out = torch.empty_like(x)
    h_final = torch.empty((Bb, H, P, N), dtype=torch.float32,
                          device=x.device) if return_state else None
    lib = _library()
    n_chunks = -(-L // lib.ssd_scan_chunk())
    states = torch.empty(Bb * H * n_chunks * N * P, dtype=torch.float32,
                         device=x.device)
    totals = torch.empty(Bb * H * n_chunks, dtype=torch.float32,
                         device=x.device)
    # bf16 takes the states entering each chunk as a bf16 copy; fp32
    # overwrites the states with them in place
    hin = states if x.dtype == torch.float32 else torch.empty(
        states.shape, dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_forward(
            x.data_ptr(), dt32.data_ptr(), A32.data_ptr(), B_.data_ptr(),
            C.data_ptr(), out.data_ptr(),
            h_final.data_ptr() if return_state else None, states.data_ptr(),
            hin.data_ptr(), totals.data_ptr(), _DTYPE_CODE[x.dtype], Bb, L, H,
            G, P, N, stream)
    if err:
        raise RuntimeError("ssd_scan kernel launch failed: "
                           f"{lib.ssd_scan_error_string(err).decode()}")
    return (out, h_final) if return_state else out


def ssd_scan_wgmma(x, dt, A, B_, C, return_state: bool = False):
    """The bf16 passes (chunk products by wgmma) on inputs as
    ``ssd_scan_blh`` takes them, x, B_, C bf16. Counted in
    ``ssd_scan_wgmma.launches``."""
    _check(x, dt, A, B_, C, torch.bfloat16)
    out = _launch(x, dt, A, B_, C, return_state)
    ssd_scan_wgmma.launches += 1
    return out


def ssd_scan_fma(x, dt, A, B_, C, return_state: bool = False):
    """The float32 passes (CUDA-core FMA) on inputs as ``ssd_scan_blh``
    takes them, x, B_, C float32. Counted in ``ssd_scan_fma.launches``."""
    _check(x, dt, A, B_, C, torch.float32)
    out = _launch(x, dt, A, B_, C, return_state)
    ssd_scan_fma.launches += 1
    return out


@functools.cache
def _bwd_library() -> ctypes.CDLL:
    return bind_backward(build.load("ssd_scan_bwd_sm90"))


def bind_backward(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/ssd_scan_bwd_sm90.cu``) with its entry
    points bound."""
    fn = lib.ssd_scan_bwd_sm90_backward
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int64] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ssd_scan_bwd_sm90_chunk.argtypes = []
    lib.ssd_scan_bwd_sm90_chunk.restype = ctypes.c_int
    lib.ssd_scan_bwd_sm90_heads_per_block.argtypes = [ctypes.c_int64] * 2
    lib.ssd_scan_bwd_sm90_heads_per_block.restype = ctypes.c_int
    lib.ssd_scan_bwd_sm90_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_bwd_sm90_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan_backward_wgmma(x, dt, A, B_, C, dy):
    """The bf16 backward kernel on inputs as ``ssd_scan_blh`` takes them
    (x, B_, C bf16) and the cotangent dy of y (x's shape, type and device,
    contiguous) → (dx, ddt, dA, dB_, dC) in their inputs' types. Counted
    in ``ssd_scan_backward_wgmma.launches``; ``backward_launch`` does the
    work."""
    _check_backward(x, dt, A, B_, C, dy)
    out = backward_launch(_bwd_library(), x, dt, A, B_, C, dy)
    ssd_scan_backward_wgmma.launches += 1
    return out


def _check_backward(x, dt, A, B_, C, dy) -> None:
    """Raises unless the inputs and dy are what the backward kernel takes."""
    _check(x, dt, A, B_, C, torch.bfloat16)
    if (dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device
            or not dy.is_contiguous()):
        raise ValueError(f"dy must be a contiguous tensor of x's shape, type "
                         f"and device, got {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}")


def backward_launch(lib: ctypes.CDLL, x, dt, A, B_, C, dy):
    """The backward on ``lib`` (bound by ``bind_backward``), on inputs that
    ``_check_backward`` passed, counting nothing. dt and A are widened to
    float32 here. The scratch, allocated here: the recomputed states
    (4·B·H·ceil(L / chunk)·N·P bytes, and as many again in bf16 for h_in
    and for dS) and the float32 partials of dB_ and dC, one per block of
    heads the adjoint walks (8·B·L·(H / heads per block)·N bytes; none
    where a block walks a whole group). Every launch goes to the current
    stream of x's device; reruns are bit-identical."""
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    dt32 = dt.float().contiguous()
    A32 = A.float().contiguous()
    n_chunks = -(-L // lib.ssd_scan_bwd_sm90_chunk())
    blocks = H // lib.ssd_scan_bwd_sm90_heads_per_block(H, G)
    f32, dev = torch.float32, x.device
    dx, dB, dC = (torch.empty_like(t) for t in (x, B_, C))
    ddt = torch.empty((Bb, L, H), dtype=f32, device=dev)
    dA = torch.empty(H, dtype=f32, device=dev)
    n_state = Bb * H * n_chunks * N * P
    states = torch.empty(n_state, dtype=f32, device=dev)
    hin, ds = torch.empty((2, n_state), dtype=torch.bfloat16, device=dev)
    per_chunk = torch.empty((2, Bb * H * n_chunks), dtype=f32, device=dev)
    parts = torch.empty((2, Bb, L, blocks if blocks > G else 0, N),
                        dtype=f32, device=dev)
    ptrs = (x, dt32, A32, B_, C, dy, dx, ddt, dA, dB, dC, states,
            per_chunk[0], hin, ds, parts[0], parts[1], per_chunk[1])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_scan_bwd_sm90_backward(
            *(t.data_ptr() for t in ptrs), Bb, L, H, G, P, N, stream)
    if err:
        msg = lib.ssd_scan_bwd_sm90_error_string(err).decode()
        raise RuntimeError(f"ssd_scan backward kernel launch failed: {msg}")
    return dx, ddt.to(dt.dtype), dA.to(A.dtype), dB, dC


def ssd_scan_blh(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B_: torch.Tensor, C: torch.Tensor,
                 return_state: bool = False):
    """x [B,L,H,P]; dt [B,L,H]; A [H]; B_/C [B,L,G,N], CUDA tensors on one
    device, x, B_, C contiguous and of one type (float32 or bfloat16),
    P, N <= 128 → y [B,L,H,P] of x's type, without the D·x skip, and with
    ``return_state`` also the state after step L, float32 [B,H,P,N]: bf16
    through ``ssd_scan_wgmma``, anything else through ``ssd_scan_fma``,
    which raises unless it is float32. dt and A are widened to float32
    here. The states between the passes take 4·B·H·ceil(L / chunk)·N·P
    bytes of scratch (and half as much again in bf16). Counted in
    ``ssd_scan_blh.launches`` as well as in the kernel's own counter."""
    kernel = ssd_scan_wgmma if x.dtype == torch.bfloat16 else ssd_scan_fma
    out = kernel(x, dt, A, B_, C, return_state)
    ssd_scan_blh.launches += 1
    return out


ssd_scan_blh.launches = 0
ssd_scan_wgmma.launches = 0
ssd_scan_fma.launches = 0
ssd_scan_backward_wgmma.launches = 0
