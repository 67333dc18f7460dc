"""Mamba-2 SSD (state-space duality) mixer.

The port of the JAX package's ``models/ssm.py``. The projections are kept
separate (z, x, B, C, dt) under the reference's names. The selective scan
over a whole sequence goes through the port's SSD op
(``repro_torch::ssd_scan``, or ``repro_torch::ssd_scan_state`` where the
prefill caches the final state), which on the card runs the SSD kernel and
on the CPU its plain recurrence; the JAX package computes the same
function with its chunked ``ssd_chunked``. The causal convolution, the
gated output and the one-token decode are plain torch.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import SSMConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import _dense_init, cast, weight


def ssm_axes(conv_bias: bool = False):
    ax = {
        "w_z": ("embed", "ssm_inner"),
        "w_x": ("embed", "ssm_inner"),
        "w_B": ("embed", None),
        "w_C": ("embed", None),
        "w_dt": ("embed", None),
        "conv_x": (None, "ssm_inner"),
        "conv_BC": (None, None),
        "A_log": (None,),
        "dt_bias": (None,),
        "D": (None,),
        "norm": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }
    if conv_bias:
        ax["conv_x_bias"] = ("ssm_inner",)
        ax["conv_BC_bias"] = (None,)
    return ax


class SSM(nn.Module):
    """A Mamba-2 mixer's parameters; with ``conv_bias`` the convolution's
    biases ``conv_x_bias`` and ``conv_BC_bias`` (zeros)."""

    def __init__(self, generator: torch.Generator, d_model: int,
                 cfg: SSMConfig, conv_bias: bool = False):
        super().__init__()
        g, dev = generator, generator.device
        din = cfg.d_inner(d_model)
        H = cfg.n_heads(d_model)
        G, N = cfg.n_groups, cfg.d_state
        self.d_model, self.cfg = d_model, cfg
        self.w_z = _dense_init(g, (d_model, din), d_model)
        self.w_x = _dense_init(g, (d_model, din), d_model)
        self.w_B = _dense_init(g, (d_model, G * N), d_model)
        self.w_C = _dense_init(g, (d_model, G * N), d_model)
        self.w_dt = _dense_init(g, (d_model, H), d_model)
        self.conv_x = _dense_init(g, (cfg.d_conv, din), cfg.d_conv)
        self.conv_BC = _dense_init(g, (cfg.d_conv, 2 * G * N), cfg.d_conv)
        self.conv_x_bias = self.conv_BC_bias = None
        if conv_bias:
            self.conv_x_bias = nn.Parameter(torch.zeros(din, device=dev))
            self.conv_BC_bias = nn.Parameter(torch.zeros(2 * G * N,
                                                         device=dev))
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, H, dtype=torch.float32, device=dev)))
        self.dt_bias = nn.Parameter(torch.zeros(H, device=dev))
        self.D = nn.Parameter(torch.ones(H, device=dev))
        self.norm = nn.Parameter(torch.ones(din, device=dev))
        self.out_proj = _dense_init(g, (din, d_model), din)

    def _proj(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bld,dp->blp", x, weight(w, x.dtype))

    def _in(self, x: torch.Tensor):
        z = self._proj(x, self.w_z)
        xr = self._proj(x, self.w_x)
        BCr = torch.cat([self._proj(x, self.w_B), self._proj(x, self.w_C)],
                        dim=-1)
        dt_raw = self._proj(x, self.w_dt)
        return z, xr, BCr, dt_raw

    def _dt_A(self, dt_raw: torch.Tensor):
        v = dt_raw.float() + self.dt_bias
        dt = torch.logaddexp(v, torch.zeros_like(v))       # softplus
        return dt, -torch.exp(self.A_log)


def _causal_conv(u: torch.Tensor, conv_w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv via tap shifts, plus ``bias``, then silu.
    u: [B, L, C]; conv_w: [K, C]; bias: [C] or None."""
    K, L = conv_w.shape[0], u.shape[1]
    out = u * conv_w[K - 1]
    for i in range(1, K):
        n = min(i, L)           # u shifted i steps later, zeros before
        shifted = torch.cat([torch.zeros_like(u[:, :n]), u[:, :L - n]],
                            dim=1)
        out = out + shifted * conv_w[K - 1 - i]
    if bias is not None:
        out = out + bias
    return F.silu(out)


def _bias(b: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if b is None else weight(b, dtype)


def _gated_out(ssm: SSM, y: torch.Tensor, z: torch.Tensor,
               dtype) -> torch.Tensor:
    y = y * F.silu(z)
    var = y.float().square().mean(-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + 1e-6) * ssm.norm).to(dtype)
    return torch.einsum("bld,dp->blp", y, weight(ssm.out_proj, dtype))


def ssm_fwd(ssm: SSM, x: torch.Tensor, return_state: bool = False):
    """Full-sequence Mamba-2 block. x: [B, L, d_model]. With
    ``return_state`` also the decode cache: the last d_conv - 1 inputs of
    the convolution and the SSD's final state in x's type."""
    cfg = ssm.cfg
    dtype = x.dtype
    Bb, L, _ = x.shape
    H, P = cfg.n_heads(ssm.d_model), cfg.head_dim
    G, N = cfg.n_groups, cfg.d_state
    din = cfg.d_inner(ssm.d_model)

    z, xr, BCr, dt_raw = ssm._in(x)
    xconv = _causal_conv(xr, weight(ssm.conv_x, dtype),
                         _bias(ssm.conv_x_bias, dtype))
    BC = _causal_conv(BCr, weight(ssm.conv_BC, dtype),
                      _bias(ssm.conv_BC_bias, dtype))
    xs = xconv.reshape(Bb, L, H, P)
    B_ = BC[..., : G * N].reshape(Bb, L, G, N).contiguous()
    C = BC[..., G * N:].reshape(Bb, L, G, N).contiguous()
    dt, A = ssm._dt_A(dt_raw)

    scan = ssd_scan(xs, dt, A, B_, C, chunk=cfg.chunk_size,
                    return_state=return_state)
    y, h_final = scan if return_state else (scan, None)
    y = y + xs * cast(ssm.D, dtype)[None, None, :, None]
    out = _gated_out(ssm, y.reshape(Bb, L, din), z, dtype)

    if return_state:
        tail = cfg.d_conv - 1
        conv_state = torch.cat([xr[:, -tail:], BCr[:, -tail:]], dim=-1)
        return out, {"conv": conv_state, "h": h_final.to(dtype)}
    return out


def init_ssm_cache(batch: int, d_model: int, cfg: SSMConfig, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    H, P = cfg.n_heads(d_model), cfg.head_dim
    G, N = cfg.n_groups, cfg.d_state
    din = cfg.d_inner(d_model)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, din + 2 * G * N),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, H, P, N), dtype=dtype, device=device),
    }


def ssm_decode(ssm: SSM, x: torch.Tensor, cache: Dict[str, torch.Tensor]):
    """Single-token state update. x: [B, 1, d_model] → (out, cache): the
    new conv window and state are written into ``cache``'s own tensors,
    which are returned."""
    cfg = ssm.cfg
    dtype = x.dtype
    Bb = x.shape[0]
    H, P = cfg.n_heads(ssm.d_model), cfg.head_dim
    G, N = cfg.n_groups, cfg.d_state
    din = cfg.d_inner(ssm.d_model)

    z, xr, BCr, dt_raw = ssm._in(x)
    # conv over [cached K-1 inputs, current]
    new_row = torch.cat([xr, BCr], dim=-1)                   # [B, 1, C]
    window = torch.cat([cache["conv"], new_row], dim=1)      # [B, K, C]
    conv_w = torch.cat([ssm.conv_x, ssm.conv_BC], dim=-1).to(dtype)
    conv_out = torch.einsum("bkc,kc->bc", window, conv_w)
    if ssm.conv_x_bias is not None:
        conv_out = conv_out + torch.cat([ssm.conv_x_bias, ssm.conv_BC_bias]
                                        ).to(dtype)
    conv_out = F.silu(conv_out)
    cache["conv"].copy_(window[:, 1:])

    xs = conv_out[..., :din].reshape(Bb, H, P)
    B_ = conv_out[..., din: din + G * N].reshape(Bb, G, N)
    C = conv_out[..., din + G * N:].reshape(Bb, G, N)
    dt, A = ssm._dt_A(dt_raw[:, 0])
    rep = H // G

    decay = torch.exp(dt * A)                                # [B, H]
    Bh = B_.repeat_interleave(rep, dim=1)                    # [B, H, N]
    dBx = (dt[..., None, None] * Bh[:, :, None, :].float()
           * xs[..., None].float())                          # [B, H, P, N]
    h = cache["h"].float() * decay[..., None, None] + dBx
    Ch = C.repeat_interleave(rep, dim=1)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch.float()).to(dtype)
    y = y + xs * cast(ssm.D, dtype)[None, :, None]
    out = _gated_out(ssm, y.reshape(Bb, 1, din), z, dtype)
    cache["h"].copy_(h)
    return out, {"conv": cache["conv"], "h": cache["h"]}

