"""The plain reference of the ``ssm`` family: a Mamba-2 language model
(arXiv:2405.21060), attention-free, each layer a norm and an SSD mixer
with a residual, tied embeddings. Float32, no kernels, no cache: the
state-space scan is the chunked SSD form computed in float32 with its
segment sums taken without cancellation.

Parameter names and layouts: ``embed`` [V, D], ``final_norm.scale``,
and for layer i ``blocks.i.ln1.scale`` and ``blocks.i.ssm.*``:
``w_z``, ``w_x`` [D, d_inner], ``w_B``, ``w_C`` [D, G·N], ``w_dt``
[D, H], ``conv_x`` [K, d_inner], ``conv_BC`` [K, 2·G·N], ``A_log``,
``dt_bias``, ``D`` [H], ``norm`` [d_inner], ``out_proj`` [d_inner, D].
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from portbench.reference import common as R


def sizes(cfg: dict):
    s = cfg["ssm"]
    din = s["expand"] * cfg["d_model"]
    return din, din // s["head_dim"], s["n_groups"], s["d_state"]


def param_spec(cfg: dict) -> list:
    """[(name, shape, init)]; init is ("normal", fan_in[, scale]),
    ("embed",), ("ones",), ("a_log",) (log of H values evenly spaced over
    [1, 16]) or ("dt_bias",) (the inverse softplus of a step drawn
    log-uniformly over [0.001, 0.1]). These are Mamba-2's own inits: its
    dt range, A over [1, 16], D ones, and the output projection scaled by
    1/sqrt(n_layers) as a pre-norm residual branch."""
    D, V, K = cfg["d_model"], cfg["padded_vocab"], cfg["ssm"]["d_conv"]
    din, H, G, N = sizes(cfg)
    spec = [("embed", (V, D), ("embed",)),
            ("final_norm.scale", (D,), ("ones",))]
    for i in range(cfg["n_layers"]):
        b = f"blocks.{i}."
        spec += [(b + "ln1.scale", (D,), ("ones",)),
                 (b + "ssm.w_z", (D, din), ("normal", D)),
                 (b + "ssm.w_x", (D, din), ("normal", D)),
                 (b + "ssm.w_B", (D, G * N), ("normal", D)),
                 (b + "ssm.w_C", (D, G * N), ("normal", D)),
                 (b + "ssm.w_dt", (D, H), ("normal", D)),
                 (b + "ssm.conv_x", (K, din), ("normal", K)),
                 (b + "ssm.conv_BC", (K, 2 * G * N), ("normal", K)),
                 (b + "ssm.A_log", (H,), ("a_log",)),
                 (b + "ssm.dt_bias", (H,), ("dt_bias",)),
                 (b + "ssm.D", (H,), ("ones",)),
                 (b + "ssm.norm", (din,), ("ones",)),
                 (b + "ssm.out_proj", (din, D),
                  ("normal", din, cfg["n_layers"] ** -0.5))]
    return spec


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """segsum(a)[..., i, j] = a_{j+1} + ... + a_i for j <= i (-inf above
    the diagonal), each entry summed from its own terms, without the
    difference of two long cumulative sums."""
    Q = a.shape[-1]
    x = a[..., None].expand(*a.shape, Q)                  # [..., i, j]: a_i
    low = torch.ones(Q, Q, dtype=torch.bool, device=a.device).tril(-1)
    x = x.masked_fill(~low, 0.0).cumsum(dim=-2)
    keep = torch.ones(Q, Q, dtype=torch.bool, device=a.device).tril()
    return x.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """The selective scan h_t = exp(dt_t A) h_{t-1} + dt_t (x_t ⊗ B_t),
    y_t = C_t · h_t from h_0 = 0, in float32 by chunks of ``chunk``.
    x [b, L, H, P]; dt [b, L, H]; A [H]; B, C [b, L, G, N] -> y."""
    b, L, H, P = x.shape
    rep = H // B.shape[2]
    pad = (-L) % chunk
    if pad:   # zero steps at the end: no input, no decay, no output read
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    c = x.shape[1] // chunk
    Bh = B.repeat_interleave(rep, dim=2).reshape(b, c, chunk, H, -1)
    Ch = C.repeat_interleave(rep, dim=2).reshape(b, c, chunk, H, -1)
    X = (x * dt[..., None]).reshape(b, c, chunk, H, P)
    a = (dt * A).reshape(b, c, chunk, H).permute(0, 3, 1, 2)   # [b,H,c,Q]
    # within each chunk
    Lm = torch.exp(_segsum(a))                                  # [b,H,c,Q,Q]
    y = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Ch, Bh, Lm, X)
    # each chunk's state from its own steps, then carried across chunks
    from_end = torch.flip(torch.cumsum(torch.flip(a, (-1,)), -1), (-1,))
    to_end = torch.exp(F.pad(from_end[..., 1:], (0, 1)))        # sum_{k>l}
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bh, to_end, X)
    totals = a.sum(-1)                                          # [b,H,c]
    carry = torch.exp(_segsum(F.pad(totals, (1, 0))))           # [b,H,c+1,c+1]
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    states = torch.einsum("bhzc,bchpn->bzhpn", carry, states)[:, :-1]
    from_start = torch.exp(torch.cumsum(a, -1))                 # [b,H,c,Q]
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", Ch, states, from_start)
    return y.reshape(b, c * chunk, H, P)[:, :L]


def _conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """silu of the depthwise causal convolution sum_i u_{t-i} w_{K-1-i}."""
    K = w.shape[0]
    out = u * w[K - 1]
    for i in range(1, K):
        out = out + F.pad(u, (0, 0, i, 0))[:, :u.shape[1]] * w[K - 1 - i]
    return F.silu(out)


def mixer(cfg: dict, p: R.Params, pre: str, x: torch.Tensor,
          mm: R.Products) -> torch.Tensor:
    s = cfg["ssm"]
    b, L, _ = x.shape
    din, H, G, N = sizes(cfg)
    P = s["head_dim"]
    z = mm("bld,de->ble", x, p[pre + "w_z"])
    xr = mm("bld,de->ble", x, p[pre + "w_x"])
    BCr = torch.cat([mm("bld,de->ble", x, p[pre + "w_B"]),
                     mm("bld,de->ble", x, p[pre + "w_C"])], dim=-1)
    dt = F.softplus(mm("bld,de->ble", x, p[pre + "w_dt"]) + p[pre + "dt_bias"])
    xs = _conv(xr, p[pre + "conv_x"]).reshape(b, L, H, P)
    BC = _conv(BCr, p[pre + "conv_BC"])
    Bm = BC[..., :G * N].reshape(b, L, G, N)
    Cm = BC[..., G * N:].reshape(b, L, G, N)
    y = ssd(xs, dt, -torch.exp(p[pre + "A_log"]), Bm, Cm, s["chunk_size"])
    y = (y + xs * p[pre + "D"][:, None]).reshape(b, L, din) * F.silu(z)
    y = R.rmsnorm(y, p[pre + "norm"], 1e-6)
    return mm("bld,de->ble", y, p[pre + "out_proj"])


def hidden(cfg: dict, p: R.Params, tokens: torch.Tensor, mm: R.Products,
           groups: Optional[List[int]] = None):
    """The last layer's output [B, S, D] over ``tokens`` [B, S] and the
    aux loss (none in this family). ``groups`` changes nothing here: the
    scan is causal, so a prompt and its decode steps read the same."""
    h = p["embed"][tokens]

    def layer(h, i):
        pre = f"blocks.{i}."
        return h + mixer(cfg, p, pre + "ssm.",
                         R.rmsnorm(h, p[pre + "ln1.scale"], cfg["norm_eps"]),
                         mm)
    for i in range(cfg["n_layers"]):
        h = R.checkpointed(layer, h, i)
    return h, torch.zeros((), device=h.device)
