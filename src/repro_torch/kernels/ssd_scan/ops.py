"""The public SSD scan entry point, as the custom ops
``repro_torch::ssd_scan`` (y) and ``repro_torch::ssd_scan_state`` (y and
the final state, for a prefill that caches it): on a CUDA tensor they run
the kernel (``kernel.ssd_scan_blh``), on a CPU tensor the plain version
(``ref.ssd_scan_reference``). ``torch.utils.flop_counter.FlopCounterMode``
counts both by ``ssd_scan_flops``, not by what either implementation
runs inside. The gradient of y is the op
``repro_torch::ssd_scan_backward`` (``backward.py``): on a CUDA tensor in
bf16 the backward kernel (``kernel.ssd_scan_backward_wgmma``), else the
VJP of the chunked form in torch ops; the final state has none. Under
``FakeTensorMode`` the ops give empty tensors of their outputs' shapes;
on DTensors they run on the local shards under ``ssd_sharding``'s rule."""
from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import Replicate, Shard
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import sharding_rules
from repro_torch.kernels.ssd_scan import backward
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_blh
from repro_torch.kernels.ssd_scan.ref import ssd_scan_reference


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cpu")
def _ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B_: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    return ssd_scan_reference(x, dt, A, B_, C).contiguous()


@_ssd_scan.register_fake
def _(x, dt, A, B_, C, chunk):
    return torch.empty_like(x)


@_ssd_scan.register_kernel("cuda")
def _(x, dt, A, B_, C, chunk):
    return ssd_scan_blh(x, dt, A, B_, C)


def ssd_scan_flops(x_shape, b_shape, chunk: int) -> int:
    """The work of the chunked form at the caller's chunk Q, which the
    calibrator counts: per chunk and head the four chunk products C·Bᵀ
    (2·Q·Q·N), its product with X (2·Q·Q·P), the carry-in C·hᵀ and the
    state update Xᵀ·B (2·Q·N·P each), over ceil(L / Q) chunks and B·H
    heads. It does not depend on how a kernel tiles the work; it is more
    than the recurrence needs, so it is not a roofline bound's count."""
    Bb, L, H, P = x_shape
    N = b_shape[3]
    Q = chunk
    per_chunk = 2 * Q * Q * N + 2 * Q * Q * P + 4 * Q * N * P
    return Bb * H * (-(-L // Q)) * per_chunk


@torch.library.custom_op("repro_torch::ssd_scan_state", mutates_args=(),
                         device_types="cpu")
def _ssd_scan_state(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B_: torch.Tensor, C: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    y, h = ssd_scan_reference(x, dt, A, B_, C, return_state=True)
    return y.contiguous(), h.contiguous()


@_ssd_scan_state.register_fake
def _(x, dt, A, B_, C, chunk):
    Bb, _, H, P = x.shape
    return (torch.empty_like(x),
            x.new_empty((Bb, H, P, B_.shape[3]), dtype=torch.float32))


@_ssd_scan_state.register_kernel("cuda")
def _(x, dt, A, B_, C, chunk):
    return ssd_scan_blh(x, dt, A, B_, C, return_state=True)


backward.register()


def _ssd_strategies(n_out: int, state_heads_dim: int = 1):
    """Per mesh dim: all replicated; batch-sharded (A replicated); or
    heads-sharded, A over its heads, and B/C over their groups (G heads'
    groups split with the heads; with one group B/C are replicated, see
    ``_ssd_valid``)."""
    r, b = Replicate(), Shard(0)
    outs_b = [b] * n_out
    outs_h = [Shard(2), Shard(state_heads_dim)][:n_out]
    return [([r] * n_out, [r, r, r, r, r, None]),
            (outs_b, [b, b, r, b, b, None]),
            (outs_h, [Shard(2), Shard(2), Shard(0), Shard(2), Shard(2),
                      None]),
            (outs_h, [Shard(2), Shard(2), Shard(0), r, r, None])]


def ssd_sharding(x, dt, A, B_, C, chunk):
    return _ssd_strategies(1)


def ssd_state_sharding(x, dt, A, B_, C, chunk):
    return _ssd_strategies(2)


def _ssd_valid(specs, args) -> bool:
    """Heads split n ways need n | H; B/C split with them (n | G) when
    there are several groups, replicated when there is one: local head j
    then reads group j // (H/G) of its own shard."""
    x, dt, A, B_, C = specs[:5]
    n = sharding_rules.shard_count(x, 2)
    G = B_.shape[2]
    if x.shape[2] % n or sharding_rules.shard_count(B_, 2) != (
            n if G > 1 else 1):
        return False
    return (tuple(dt.placements) == tuple(x.placements)
            and tuple(B_.placements) == tuple(C.placements))


sharding_rules.register([torch.ops.repro_torch.ssd_scan.default],
                        ssd_sharding, _ssd_valid)
sharding_rules.register([torch.ops.repro_torch.ssd_scan_state.default],
                        ssd_state_sharding, _ssd_valid)


@register_flop_formula([torch.ops.repro_torch.ssd_scan,
                        torch.ops.repro_torch.ssd_scan_state])
def _flops(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk, *args,
           **kwargs) -> int:
    return ssd_scan_flops(x_shape, b_shape, chunk)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_backward)
def _backward_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk,
                    dy_shape, *args, **kwargs) -> int:
    """Three times the forward's: its four chunk products recomputed, and
    two products of the same size for each of them."""
    return 3 * ssd_scan_flops(x_shape, b_shape, chunk)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             return_state: bool = False):
    """Model layout (matches the JAX package's models/ssm.ssd_chunked):
    x [B, L, H, P]; dt [B, L, H] (post-softplus); A [H] (negative);
    B_/C [B, L, G, N] (G groups broadcast over H). Returns y [B, L, H, P]
    of x's type (without the D·x skip, which the caller adds); with
    ``return_state`` also the state after the last step, float32
    [B, H, P, N] (``ssd_scan_state``). Runs where
    the tensors lie. ``chunk`` does not change what is computed: the CUDA
    kernel runs its own 64-step chunks and the plain version the
    recurrence. It sets only the FLOPs that ``FlopCounterMode`` counts the
    op for, which is the calibrator's measure; a roofline bound counts the
    least work instead (4·N·P per step and head, see chip_smoke.py)."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if return_state:
        return torch.ops.repro_torch.ssd_scan_state(x, dt, A, B_, C, chunk)
    return torch.ops.repro_torch.ssd_scan(x, dt, A, B_, C, chunk)
