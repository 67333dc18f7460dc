"""The gradient of ``repro_torch::flash_attention``, and its registration
with autograd.

The JAX package has no backward kernel: its language models train by
XLA's autodiff of the plain ``chunked_attention``. The port's forward is
the hand-written kernel on the card (the plain version on the CPU). Its
backward is the custom op ``repro_torch::flash_attention_backward``, with
two routes by device and type:

* bf16 on the card: the hand-written kernel
  ``kernel.flash_attention_backward_wgmma``
  (``csrc/flash_attention_bwd_sm90.cu``, wgmma fed by TMA, two passes
  with no atomics), at every head dim the forward takes;
* everything else, fp32 on the card and every type on the CPU: the
  explicit formula below in torch ops, ``flash_attention_backward``,
  which is also the kernel's plain version. No full-width path trains in
  fp32; on the card fp32 steps are the depth-2 card-against-CPU check.

Neither route calls the plain forward or a library attention, and
nothing falls back from one route to the other.

The formula, per block of BLOCK_Q query rows (memory stays at [B, H, BLOCK_Q, Skv]):
S = Q·Kᵀ·scale over the keys the block can see, the row log-sum-exp and
P = exp(S - lse) recomputed from it, then

    dV += Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ⊙ (dP - rowsum(P ⊙ dP)),
    dQ = dS·K·scale,  dK += dSᵀ·Q·scale.

rowsum(P ⊙ dP) equals rowsum(dO ⊙ O) in exact arithmetic. It is taken
from the same dP that it is subtracted from, as autodiff of the softmax
takes it: where a row's softmax is near uniform, dP - rowsum is a small
difference, and rowsum(dO ⊙ O) left the rounding of dP in it (whisper's
bf16 cross-attention gradients then missed tests/test_torch_train.py's
bound). So the forward's output is not saved either.

The mask is the forward's, right-aligned causal (query i sees key
j <= i + Skv - Sq); a row that sees no key has P = 0 and a zero
gradient. Under GQA the dK
and dV of the H / KV query heads that share a KV head are summed, in the
same product.

Types. S and dP are formed in float32 from the inputs' values, as the
forward kernels form S (bf16 operands, float32 sums): a backward that
rounded S to bf16 would differentiate another P than the forward
computed, and a bf16 dP leaves its rounding in dP - rowsum(P ⊙ dP). For
bf16 inputs these two products run with TF32 allowed, which is exact for
bf16 operands (8 significant bits, TF32 keeps 11). P and dS are rounded
to the inputs' type for dV, dQ and dK, whose products accumulate in
float32 inside the matmul, as the JAX package's einsums do; fp32 inputs
give fp32 products throughout. The softmax, and the sums of dK and dV
over the blocks, are float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_backward_wgmma)

BLOCK_Q = 512


@contextlib.contextmanager
def _tf32_if(enabled: bool):
    """TF32 for float32 matmuls inside, where ``enabled``; the caller's
    setting is restored after."""
    if not enabled:
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor, causal: bool):
    """q, do: [B, Sq, H, d]; k/v: [B, Skv, KV, d] → (dq, dk, dv) in the
    layouts and types of q, k and v."""
    B, Sq, H, d = q.shape
    _, Skv, KV, _ = k.shape
    rep = H // KV
    scale = 1.0 / math.sqrt(d)
    cdt = q.dtype
    # [B, KV, rep, S, d]: the query heads of one KV head side by side
    qh = q.permute(0, 2, 1, 3).reshape(B, KV, rep, Sq, d)
    doh = do.to(cdt).permute(0, 2, 1, 3).reshape(B, KV, rep, Sq, d)
    kh = k.permute(0, 2, 1, 3)[:, :, None]              # [B, KV, 1, Skv, d]
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    kf, vf = kh.float(), vh.float()
    exact_tf32 = cdt == torch.bfloat16
    dq = torch.zeros((B, KV, rep, Sq, d), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((B, KV, Skv, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    off = Skv - Sq
    for i0 in range(0, Sq, BLOCK_Q):
        i1 = min(Sq, i0 + BLOCK_Q)
        n = i1 - i0
        # the keys some row of the block sees
        kend = min(Skv, i1 + off) if causal else Skv
        if kend <= 0:
            continue
        qb, dob = qh[..., i0:i1, :], doh[..., i0:i1, :]
        kb = kh[..., :kend, :]
        with _tf32_if(exact_tf32):
            s = torch.matmul(qb.float(), kf[..., :kend, :].transpose(-1, -2))
        s = s * scale
        if causal:
            rows = torch.arange(i0, i1, device=q.device)[:, None]
            keep = torch.arange(kend, device=q.device)[None, :] <= rows + off
            s = s.masked_fill(~keep, float("-inf"))
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
        lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
        p = torch.exp(s - lse)                           # 0 where masked
        del s
        pc = p.to(cdt)
        # dV and dK sum over the block's rows of all rep query heads in one
        # product: [B, KV, kend, rep·n] · [B, KV, rep·n, d]
        pt = pc.permute(0, 1, 4, 2, 3).reshape(B, KV, kend, rep * n)
        dv[..., :kend, :] += torch.matmul(
            pt, dob.reshape(B, KV, rep * n, d)).float()
        with _tf32_if(exact_tf32):
            dp = torch.matmul(dob.float(), vf[..., :kend, :].transpose(-1, -2))
        ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
        del p, pc, pt, dp
        dsc = ds.to(cdt)
        dq[..., i0:i1, :] = torch.matmul(dsc, kb).float()
        dst = dsc.permute(0, 1, 4, 2, 3).reshape(B, KV, kend, rep * n)
        dk[..., :kend, :] += torch.matmul(
            dst, qb.reshape(B, KV, rep * n, d)).float()
        del ds, dsc, dst
    dq = dq.reshape(B, H, Sq, d).permute(0, 2, 1, 3).to(q.dtype)
    dk = dk.permute(0, 2, 1, 3).to(k.dtype)
    dv = dv.permute(0, 2, 1, 3).to(v.dtype)
    return dq.contiguous(), dk.contiguous(), dv.contiguous()


@torch.library.custom_op("repro_torch::flash_attention_backward",
                         mutates_args=(), device_types="cpu")
def _flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor,
                              causal: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    return flash_attention_backward(q, k, v, do, causal)


@_flash_attention_backward.register_kernel("cuda")
def _(q, k, v, do, causal):
    if q.dtype == torch.bfloat16:
        return flash_attention_backward_wgmma(
            q, k, v, do.to(q.dtype).contiguous(), causal)
    return flash_attention_backward(q, k, v, do, causal)


@_flash_attention_backward.register_fake
def _(q, k, v, do, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, causal = inputs
    ctx.causal = causal
    ctx.save_for_backward(q, k, v)


def _backward(ctx, grad):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = torch.ops.repro_torch.flash_attention_backward(
        q, k, v, grad, ctx.causal)
    return dq, dk, dv, None


def register() -> None:
    """Gives ``repro_torch::flash_attention`` its gradient: the custom op
    ``repro_torch::flash_attention_backward``, one op to
    ``FlopCounterMode``, to ``FakeTensorMode`` and to DTensor (whose rule
    is in ``ops.py``), the kernel or the formula inside by the routes
    above."""
    torch.library.register_autograd("repro_torch::flash_attention",
                                    _backward, setup_context=_setup_context)
