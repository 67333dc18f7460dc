"""Plain torch oracle for the SSD scan kernel: the sequential
(non-chunked) state-space recurrence, O(L) steps — slow but
unambiguous."""
from __future__ import annotations

import torch


def ssd_scan_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       B_: torch.Tensor, C: torch.Tensor,
                       return_state: bool = False):
    """x [B,L,H,P]; dt [B,L,H]; A [H]; B_/C [B,L,G,N] → y [B,L,H,P] of
    x's type, computed in fp32; with ``return_state`` also the final state
    h_L, float32 [B,H,P,N].

    h_t = exp(dt_t A) h_{t-1} + dt_t · (B_t ⊗ x_t);  y_t = C_t · h_t
    """
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    Bh = B_.float().repeat_interleave(rep, dim=2)          # [B,L,H,N]
    Ch = C.float().repeat_interleave(rep, dim=2)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = torch.zeros(Bb, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        decay = torch.exp(dtf[:, t] * Af)[..., None, None]  # [B,H,1,1]
        dBx = (dtf[:, t][..., None, None] * Bh[:, t][:, :, None, :]
               * xf[:, t][..., None])                       # [B,H,P,N]
        h = h * decay + dBx
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)                  # [B,L,H,P]
    return (y, h) if return_state else y
