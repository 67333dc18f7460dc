"""The gradient of ``repro_torch::ssd_scan`` (and of y through
``repro_torch::ssd_scan_state``), and its registration with autograd.

The JAX package has no backward kernel: its language models train by
XLA's autodiff of the plain ``ssd_chunked`` (``models/ssm.py``). The
port's forward is the hand-written SSD kernel on the card (the plain
recurrence on the CPU). Its backward is the custom op
``repro_torch::ssd_scan_backward``, with two routes by device and type:

* bf16 on the card: the hand-written kernel
  ``kernel.ssd_scan_backward_wgmma`` (``csrc/ssd_scan_bwd_sm90.cu``: the
  forward's states recomputed, each chunk's state cotangent, a reverse
  pass over the chunks, one adjoint per chunk on wgmma, the sums over
  heads; no atomics);
* everything else, fp32 on the card and every type on the CPU:
  ``ssd_scan_backward`` below, the vector-Jacobian product of
  ``ssd_chunked``, a torch counterpart of the JAX package's function in
  its order of operations and types, recomputed and differentiated by
  autograd inside the op; it is also the kernel's plain version. No
  full-width path trains in fp32; on the card fp32 steps are the depth-2
  card-against-CPU check.

Neither route calls the plain recurrence of ``ref.py``, and nothing falls
back from one route to the other. The gradient covers x, dt, A, B_ and
C.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch._C import DispatchKey

from repro_torch.kernels.ssd_scan.kernel import ssd_scan_backward_wgmma


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """segsum(a)[..., i, j] = sum_{j < k <= i} a_k (−inf above the
    diagonal)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_: torch.Tensor, C: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan of the JAX package's ``ssd_chunked``. x: [B, L,
    H, P]; dt: [B, L, H] (post-softplus); A: [H] (negative); B_, C: [B, L,
    G, N] → (y [B, L, H, P] of x's type, h_final [B, H, P, N] of x's
    type). The products take x's type, the decays and C·Bᵀ float32, and
    the state is carried between chunks in x's type, as in the
    reference."""
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    Q = min(chunk, L)
    if L % Q:
        Q = L
    Nc = L // Q
    f32, xdt = torch.float32, x.dtype

    xc = x.reshape(Bb, Nc, Q, H, P)
    dtc = dt.reshape(Bb, Nc, Q, H).float()
    Bc = B_.reshape(Bb, Nc, Q, G, N)
    Cc = C.reshape(Bb, Nc, Q, G, N)

    a = dtc * A                                          # [B, Nc, Q, H]
    a_hq = a.movedim(-1, -2)                             # [B, Nc, H, Q]
    seg = _segsum(a_hq)                                  # [B, Nc, H, Q, Q]
    cum = torch.cumsum(a_hq, dim=-1)                     # [B, Nc, H, Q]

    # the diagonal (within-chunk) term
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc.to(f32), Bc.to(f32))
    CB = CB.repeat_interleave(rep, dim=2)                # [B, Nc, H, Q, Q]
    M = CB * torch.exp(seg) * dtc.movedim(-1, -2)[..., None, :]
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", M.to(xdt), xc)

    # the chunks' state summaries
    decay_out = torch.exp(cum[..., -1:] - cum)           # [B, Nc, H, Q]
    wB = (Bc.to(f32).repeat_interleave(rep, dim=3)
          * (dtc * decay_out.movedim(-1, -2))[..., None])
    S = torch.einsum("bcqhn,bcqhp->bchpn", wB.to(xdt), xc)  # [B,Nc,H,P,N]

    # the recurrence across chunks
    chunk_decay = torch.exp(cum[..., -1])                # [B, Nc, H]
    h = (torch.zeros((Bb, H, P, N), dtype=xdt, device=x.device)
         if h0 is None else h0)
    entries = []
    for c in range(Nc):
        entries.append(h)
        h = h * chunk_decay[:, c, :, None, None].to(xdt) + S[:, c]
    h_enter = torch.stack(entries, dim=1)                # [B, Nc, H, P, N]

    # the off-diagonal (carry-in) term
    Cin = (Cc.to(f32).repeat_interleave(rep, dim=3)
           * torch.exp(cum.movedim(-1, -2))[..., None])
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Cin.to(xdt), h_enter)
    return (y_diag + y_off).reshape(Bb, L, H, P), h


@contextlib.contextmanager
def _autograd_recording():
    """Autograd records ops inside: a custom op's kernel runs with
    autograd's dispatch keys excluded (``torch.library``), where the
    formula below must still differentiate its forward. The caller's
    exclusions are restored after. Not ``torch.func.vjp``: its wrapped
    tensors fail inside a ``TorchDispatchMode`` such as the
    ``FlopCounterMode`` that counts this op ("Cannot access storage of
    TensorWrapper")."""
    keys = (DispatchKey.AutogradFunctionality, DispatchKey.AutogradOther,
            DispatchKey.AutogradNestedTensor)
    was = [torch._C._dispatch_tls_is_dispatch_key_excluded(k) for k in keys]
    for k in keys:
        torch._C._dispatch_tls_set_dispatch_key_excluded(k, False)
    try:
        with torch.enable_grad():
            yield
    finally:
        for k, w in zip(keys, was):
            torch._C._dispatch_tls_set_dispatch_key_excluded(k, w)


def ssd_scan_backward(x, dt, A, B_, C, chunk: int, dy: torch.Tensor):
    """The VJP of ``ssd_chunked``'s y at (x, dt, A, B_, C) for the
    cotangent dy → (dx, ddt, dA, dB_, dC) in their inputs' types."""
    with _autograd_recording():
        ins = [t.detach().requires_grad_(True) for t in (x, dt, A, B_, C)]
        y, _ = ssd_chunked(*ins, chunk)
        grads = torch.autograd.grad(y, ins, dy.to(y.dtype))
    return tuple(g.to(t.dtype).contiguous()
                 for g, t in zip(grads, (x, dt, A, B_, C)))


@torch.library.custom_op("repro_torch::ssd_scan_backward", mutates_args=(),
                         device_types="cpu")
def _ssd_scan_backward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B_: torch.Tensor, C: torch.Tensor, chunk: int,
                       dy: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
    return ssd_scan_backward(x, dt, A, B_, C, chunk, dy)


@_ssd_scan_backward.register_kernel("cuda")
def _(x, dt, A, B_, C, chunk, dy):
    if x.dtype == torch.bfloat16:
        return ssd_scan_backward_wgmma(x, dt, A, B_, C,
                                       dy.to(x.dtype).contiguous())
    return ssd_scan_backward(x, dt, A, B_, C, chunk, dy)


@_ssd_scan_backward.register_fake
def _(x, dt, A, B_, C, chunk, dy):
    return tuple(torch.empty_like(t) for t in (x, dt, A, B_, C))


def _setup_context(ctx, inputs, output):
    x, dt, A, B_, C, chunk = inputs
    ctx.chunk = chunk
    ctx.save_for_backward(x, dt, A, B_, C)


def _local_placements(mesh, dy_pl, n_groups: int):
    """The placements under which each shard's VJP is its part of the
    whole, read from dy's (the forward's output placements) per mesh dim:
    batch-split (dA partial), heads-split (A over heads; B_/C over groups,
    or partial where one group is shared by every head), or replicated.
    → (dy's, the inputs', the gradients')."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    r, part = Replicate(), Partial()
    dy_, ins, outs = [], [[] for _ in range(5)], [[] for _ in range(5)]
    for p in dy_pl:
        if p == Shard(0):
            pin = (Shard(0), Shard(0), r, Shard(0), Shard(0))
            pout = (Shard(0), Shard(0), part, Shard(0), Shard(0))
        elif p == Shard(2):
            bc = Shard(2) if n_groups > 1 else r
            pin = (Shard(2), Shard(2), Shard(0), bc, bc)
            pout = pin[:3] + ((bc,) * 2 if n_groups > 1 else (part, part))
        else:
            p = r
            pin = pout = (r,) * 5
        dy_.append(p)
        for lst, q in zip(ins, pin):
            lst.append(q)
        for lst, q in zip(outs, pout):
            lst.append(q)
    return dy_, ins, outs


def _backward(ctx, dy):
    x, dt, A, B_, C = ctx.saved_tensors
    from torch.distributed.tensor import DTensor
    op = torch.ops.repro_torch.ssd_scan_backward
    if not isinstance(dy, DTensor):
        return (*op(x, dt, A, B_, C, ctx.chunk, dy), None)
    # on DTensors: each shard's VJP on its local tensors (local_map), the
    # shards laid out as the forward's output
    from torch.distributed.tensor.experimental import local_map
    mesh = dy.device_mesh
    dy_pl, ins, outs = _local_placements(mesh, dy.placements, B_.shape[2])
    vjp = local_map(op, out_placements=tuple(outs),
                    in_placements=(*ins, None, dy_pl), device_mesh=mesh,
                    redistribute_inputs=True)
    return (*vjp(x, dt, A, B_, C, ctx.chunk, dy), None)


def _backward_state(ctx, dy, dh):
    """The gradient through y only: training does not differentiate the
    final state, which only a prefill reads (``ssd_scan_state``'s
    docstring); a non-zero dh raises."""
    if dh is not None and bool((dh != 0).any()):
        raise NotImplementedError("ssd_scan_state has no gradient for its "
                                  "final state")
    return _backward(ctx, dy)


def register() -> None:
    """Gives ``repro_torch::ssd_scan`` and ``repro_torch::ssd_scan_state``
    their gradient: the custom op ``repro_torch::ssd_scan_backward``, one
    op to ``FlopCounterMode`` and to ``FakeTensorMode``, run per shard on
    DTensors, the kernel or the formula inside by the routes above."""
    torch.library.register_autograd("repro_torch::ssd_scan", _backward,
                                    setup_context=_setup_context)
    torch.library.register_autograd("repro_torch::ssd_scan_state",
                                    _backward_state,
                                    setup_context=_setup_context)
