"""The numerical designs of the port's Hopper kernels, checked on the CPU.

The CUDA kernels run only on a card, but their arithmetic can be replayed
here: these test-local torch functions follow the kernels' order of
operations and their bf16 rounding points, and are held against the JAX
package's kernels (Pallas in interpret mode) on the same numpy-seeded
inputs, under the limits of ``repro_torch.kernels.sweeps``.

* ``flash_design``: ``csrc/flash_attention_sm90.cu`` in bf16: key tiles of
  128, an online softmax in fp32 with ``exp2`` and log2(e) folded into the
  scale, P rounded to bf16 before P·V, a row that sees no key giving 0;
  at d 16 on the kernel's 32-column tiles, the 16 past d zero.
* ``flash_3xtf32_design``: ``csrc/flash_attention_sm90_f32.cu`` in fp32:
  each operand split into TF32 parts hi = tf32(a), lo = tf32(a - hi)
  (round to nearest, ties away, emulated on the bits), each product
  lo·hi + hi·lo and then hi·hi with fp32 sums, key tiles of 32, P split
  in registers, V^T's keys of each group of 8 in the order 0 2 4 6 1 3 5
  7; with ``products=1`` one TF32 product instead, the design the split
  replaces. With ``key_tile=64, key_split=2`` it is
  ``csrc/flash_d16.cuh``, fp32 at head dim 16 on ``mma.sync`` (two warps
  a row, each over half of every tile, merged at the end), whose m16n8k8
  lane maps ``test_d16_fragment_maps_replay_plain_products`` replays.
* ``ssd_design``: ``csrc/ssd_scan.cu``: chunk states, a state pass and
  chunk outputs at chunk length Q; in bf16 the operands computed in
  between are rounded where the kernel rounds them (B·w, h_in, M).
* ``flash_backward_design``: ``csrc/flash_attention_bwd_sm90.cu`` in
  bf16: pass 1 over key tiles of 64, once for the online max, sum and
  Dacc (D = rowsum(P ⊙ dP) in fp32 from the same sweep) and once for dS
  and dQ; pass 2 per CTA of 128 keys (two warpgroups of 64) over query
  tiles of 64 from each warpgroup's causal frontier, head by head of the
  GQA group; exp2 with log2(e) folded into the scale; P and dS rounded
  to bf16 as the products' operands, dq, dk, dv once at the end; d 16
  padded to 32 zero columns as the kernel's tiles are. It is held
  against ``jax.grad`` of ``models.layers.chunked_attention``, the JAX
  package's training attention (it has no backward kernel).
* ``ssd_backward_design``: ``csrc/ssd_scan_bwd_sm90.cu`` in bf16: the
  forward's states recomputed, each chunk's state cotangent, a reverse
  pass over the chunks, one adjoint per chunk of 64 steps, the sums over
  each group's heads; B·w, h_in, C·e^cum, dS, M and dM∘L∘dt rounded to
  bf16 where the kernel's products take them. It is held against
  ``jax.grad`` of ``models.ssm.ssd_chunked``, with which the JAX package
  trains mamba2 (it has no backward kernel).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_reference as jax_attention
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models.layers import chunked_attention
from repro.models.ssm import ssd_chunked
from repro_torch.kernels.flash_attention.backward import (
    flash_attention_backward)
from repro_torch.kernels.ssd_scan.backward import (
    ssd_chunked as port_ssd_chunked)
from repro_torch.kernels.ssd_scan.backward import ssd_scan_backward
from repro_torch.kernels.sweeps import (FLASH_BWD_RTOL, FLASH_BWD_SWEEP,
                                        FLASH_SWEEP, FLASH_TOL,
                                        FULL_FLASH_BF16_ROW_RTOL,
                                        FULL_SSD_RTOL, SSD_BWD_RTOL,
                                        SSD_RTOL, SSD_SWEEP)

torch.set_num_threads(2)

KEY_TILE = 128          # flash_attention_sm90.cu kBN
F32_KEY_TILE = 32       # flash_attention_sm90_f32.cu kBN
D16_KEY_TILE = 64       # flash_d16.cuh kKeys
D16_KEY_SPLIT = 2       # flash_d16.cuh kKeySplit
LOG2E = 1.4426950408889634


def flash_design(q, k, v, causal: bool, tile_cols: int = 0) -> torch.Tensor:
    """q [B, Sq, H, d], k/v [B, Skv, KV, d] bf16 → o bf16, the way the
    wgmma kernel computes it; with ``tile_cols`` > d the operands are
    zero-padded to that many columns, as the kernel's tiles are at d 16
    (32 columns), and the output keeps the d real ones."""
    B, Sq, H, d = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    pad = (0, max(0, tile_cols - d))
    qf = torch.nn.functional.pad(q.float().permute(0, 2, 1, 3), pad)
    kf = torch.nn.functional.pad(
        k.float().repeat_interleave(H // KV, 2).permute(0, 2, 1, 3), pad)
    vf = torch.nn.functional.pad(
        v.float().repeat_interleave(H // KV, 2).permute(0, 2, 1, 3), pad)
    scale_log2 = (1.0 / math.sqrt(d)) * LOG2E
    rows = torch.arange(Sq)[:, None] + (Skv - Sq)
    m = torch.full((B, H, Sq), -math.inf)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, qf.shape[3])
    for k0 in range(0, Skv, KEY_TILE):
        kt, vt = kf[:, :, k0:k0 + KEY_TILE], vf[:, :, k0:k0 + KEY_TILE]
        s = qf @ kt.transpose(-1, -2)                            # fp32 sums
        keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
        valid = keys <= rows if causal else torch.ones_like(keys <= rows)
        s = s.masked_fill(~valid, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        ms = torch.where(m_new == -math.inf, torch.zeros(()),
                         m_new * scale_log2)
        alpha = torch.exp2(m * scale_log2 - ms)
        p = torch.exp2(s * scale_log2 - ms[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ vt
        m = m_new
    out = acc / torch.where(l == 0, torch.ones(()), l)[..., None]
    return out[..., :d].permute(0, 2, 1, 3).bfloat16()


def tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 → TF32 (10 mantissa bits), rounded to nearest with ties away
    from zero, as PTX cvt.rna.tf32.f32: half of the 13 low bits added to
    the magnitude's bits, then the 13 cleared."""
    b = t.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(t: torch.Tensor):
    hi = tf32(t)
    return hi, tf32(t - hi)


def _key_order(n: int) -> torch.Tensor:
    """The keys of a V^T row of n: within each group of 8, 0 2 4 6 1 3 5 7
    (flash_attention_sm90_f32.cu key_at)."""
    p = torch.arange(n)
    q = p % 8
    return p - q + torch.where(q < 4, 2 * q, 2 * (q - 4) + 1)


def flash_3xtf32_design(q, k, v, causal: bool, products: int = 3,
                        key_tile: int = F32_KEY_TILE, key_split: int = 1
                        ) -> torch.Tensor:
    """q [B, Sq, H, d], k/v [B, Skv, KV, d] fp32 → o fp32, the way the
    3xTF32 kernel computes it (``products=3``), or with one TF32 product
    per matrix product (``products=1``), over tiles of ``key_tile`` keys.
    With ``key_split=2`` (the head-dim-16 kernel, ``key_tile=64``) two
    warps share each row, each with its own online softmax over one half
    of every tile, and the second's max, sum and O are merged into the
    first's at the end, the first's rescaled first."""
    B, Sq, H, d = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)                           # [B,H,Sq,d]
    kf = k.float().repeat_interleave(H // KV, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(H // KV, 2).permute(0, 2, 1, 3)

    def product(a, b):
        (a_hi, a_lo), (b_hi, b_lo) = split_tf32(a), split_tf32(b)
        if products == 1:
            return a_hi @ b_hi
        return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi        # cross first

    scale_log2 = (1.0 / math.sqrt(d)) * LOG2E
    rows = torch.arange(Sq)[:, None] + (Skv - Sq)
    part_keys = key_tile // key_split
    parts = []
    for part in range(key_split):
        m = torch.full((B, H, Sq), -math.inf)
        l = torch.zeros(B, H, Sq)
        acc = torch.zeros(B, H, Sq, d)
        for k0 in range(part * part_keys, Skv, key_tile):
            kt = kf[:, :, k0:k0 + part_keys]
            vt = vf[:, :, k0:k0 + part_keys]
            s = product(qf, kt.transpose(-1, -2))
            keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
            valid = (keys <= rows if causal
                     else torch.ones_like(keys <= rows))
            s = s.masked_fill(~valid, -math.inf)
            m_new = torch.maximum(m, s.amax(-1))
            ms = torch.where(m_new == -math.inf, torch.zeros(()),
                             m_new * scale_log2)
            alpha = torch.exp2(m * scale_log2 - ms)
            p = torch.exp2(s * scale_log2 - ms[..., None])
            l = l * alpha + p.sum(-1)
            order = _key_order(kt.shape[2])
            acc = (acc * alpha[..., None]
                   + product(p[..., order], vt[..., order, :]))
            m = m_new
        parts.append((m, l, acc))
    m, l, acc = parts[0]
    for m1, l1, acc1 in parts[1:]:
        top = torch.maximum(m, m1)
        ms = torch.where(top == -math.inf, torch.zeros(()), top * scale_log2)
        f = torch.exp2(m * scale_log2 - ms)
        f1 = torch.exp2(m1 * scale_log2 - ms)
        l = l1 * f1 + l * f
        acc = acc1 * f1[..., None] + acc * f[..., None]
        m = top
    out = acc / torch.where(l == 0, torch.ones(()), l)[..., None]
    return out.permute(0, 2, 1, 3).contiguous()


def _bf16(t: torch.Tensor, on: bool) -> torch.Tensor:
    return t.bfloat16().float() if on else t


def ssd_design(x, dt, A, B_, C, Q: int) -> torch.Tensor:
    """x [B,L,H,P], dt [B,L,H] f32, A [H] f32, B_/C [B,L,G,N] → y of x's
    type, in the kernel's three passes over chunks of Q steps."""
    rnd = x.dtype == torch.bfloat16
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    nc = -(-L // Q)
    pad = nc * Q - L

    def chunks(t):        # [B, L, ...] → [B, nc, Q, ...], zeros past L
        widths = (0, 0) * (t.dim() - 2) + (0, pad)
        t = torch.nn.functional.pad(t.float(), widths)
        return t.reshape(Bb, nc, Q, *t.shape[2:])

    xc, dtc = chunks(x), chunks(dt)                              # [B,nc,Q,H,(P)]
    Bc = chunks(B_).repeat_interleave(H // G, 3)                 # [B,nc,Q,H,N]
    Cc = chunks(C).repeat_interleave(H // G, 3)
    cum = torch.cumsum(dtc * A.float(), dim=2)                   # [B,nc,Q,H]
    total = cum[:, :, -1]                                        # [B,nc,H]
    # 1. chunk states S_c = X^T (B . w), w_j = dt_j e^(total - cum_j)
    w = dtc * torch.exp(total[:, :, None] - cum)
    Bw = _bf16(Bc * w[..., None], rnd)
    S = torch.einsum("bcjhn,bcjhp->bchnp", Bw, xc)
    # 2. the states entering each chunk
    h_in = torch.zeros_like(S)
    run = torch.zeros_like(S[:, 0])
    for c in range(nc):
        h_in[:, c] = run
        run = torch.exp(total[:, c])[..., None, None] * run + S[:, c]
    h_in = _bf16(h_in, rnd)
    # 3. chunk outputs
    Gm = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    cum_h = cum.permute(0, 1, 3, 2)                              # [B,nc,H,Q]
    seg = cum_h[..., :, None] - cum_h[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool).tril()
    decay = torch.exp(torch.where(mask, seg, torch.zeros(())))
    M = torch.where(mask, Gm * decay * dtc.permute(0, 1, 3, 2)[..., None, :],
                    torch.zeros(()))
    M = _bf16(M, rnd)
    carry = torch.einsum("bcihn,bchnp->bcihp", Cc, h_in)
    y = (torch.exp(cum)[..., None] * carry
         + torch.einsum("bchij,bcjhp->bcihp", M, xc))
    return y.reshape(Bb, nc * Q, H, P)[:, :L].to(x.dtype)


# ---- flash -----------------------------------------------------------------

FLASH_BF16 = [c[:7] for c in FLASH_SWEEP if c[-1] == "bfloat16"]


def _flash_inputs(B, Sq, Skv, H, KV, d, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, d)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, d)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, d)).astype(np.float32))


@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,causal", FLASH_BF16)
def test_flash_design_matches_jax(B, Sq, Skv, H, KV, d, causal):
    arrays = _flash_inputs(B, Sq, Skv, H, KV, d)
    j = np.asarray(jax_flash(*(jnp.asarray(a).astype(jnp.bfloat16)
                               for a in arrays), causal=causal,
                             interpret=True).astype(jnp.float32))
    t = flash_design(*(torch.from_numpy(a).bfloat16() for a in arrays),
                     causal).float().numpy()
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, atol=FLASH_TOL["bfloat16"], rtol=0)
    if causal and Sq > Skv:
        assert not t[:, :Sq - Skv].any()


# head dim 16 (the reduced() configs'): the reduced train_loop's shape
# first (smollm-135m: batch 8, seq 128, H 4, KV 2), then ragged MQA, Sq <
# Skv and Sq > Skv
FLASH_D16 = [(8, 128, 128, 4, 2, 16, True), (2, 200, 200, 4, 1, 16, True),
             (1, 96, 160, 4, 2, 16, False), (1, 160, 96, 2, 2, 16, True)]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,causal", FLASH_D16)
def test_flash_design_at_head_dim_16_on_32_columns(B, Sq, Skv, H, KV, d,
                                                   causal):
    """bf16 at d 16 runs on the wgmma kernel's 32-column tiles, the 16
    columns past d zero: that replay equals the unpadded one bit for bit
    (the zero columns add exact zeros to Q·Kᵀ; the scale stays 1/√16),
    and it is within FLASH_TOL of the JAX package's kernel in interpret
    mode on the same inputs."""
    arrays = _flash_inputs(B, Sq, Skv, H, KV, d, seed=Sq + Skv)
    t = [torch.from_numpy(a).bfloat16() for a in arrays]
    padded = flash_design(*t, causal, tile_cols=32)
    assert torch.equal(padded, flash_design(*t, causal))
    j = np.asarray(jax_flash(*(jnp.asarray(a).astype(jnp.bfloat16)
                               for a in arrays), causal=causal,
                             interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(padded.float().numpy(), j,
                               atol=FLASH_TOL["bfloat16"], rtol=0)
    if causal and Sq > Skv:
        assert not padded[:, :Sq - Skv].any()


@pytest.mark.parametrize("oracle", ["flash_attention", "exact"])
def test_flash_design_long_rows_within_a_bf16_step(oracle):
    """B 1, S 1,024, H 2, KV 1, d 128, causal: per query row |err| <=
    FULL_FLASH_BF16_ROW_RTOL · max|oracle| of the row, against the JAX
    package's flash_attention (interpret mode) and its exact attention,
    on the same bf16 inputs."""
    arrays = _flash_inputs(1, 1024, 1024, 2, 1, 128, seed=5)
    typed = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays]
    if oracle == "flash_attention":
        j = jax_flash(*typed, causal=True, interpret=True)
    else:
        j = jax_attention(*(a.astype(jnp.float32) for a in typed),
                          causal=True)
    j = np.asarray(j.astype(jnp.float32))
    t = flash_design(*(torch.from_numpy(a).bfloat16() for a in arrays),
                     True).float().numpy()
    row_err = np.abs(t - j).max(-1)
    row_max = np.abs(j).max(-1)
    assert (row_err <= FULL_FLASH_BF16_ROW_RTOL * row_max).all()


def test_flash_design_rounding_p_costs_about_one_bf16_step():
    """Rounding P to bf16 moves the output by about one bf16 step of it
    (at most two, 2^-7 of the row's max each), against exact attention in
    fp32 on the same bf16 inputs."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _flash_inputs(1, 256, 256, 2, 1, 64, seed=9))
    rounded = flash_design(q, k, v, True).float()
    exact = torch.nn.functional.scaled_dot_product_attention(
        q.float().transpose(1, 2), k.float().repeat_interleave(2, 2)
        .transpose(1, 2), v.float().repeat_interleave(2, 2).transpose(1, 2),
        is_causal=True).transpose(1, 2)
    rel = (rounded - exact).abs().amax(-1) / exact.abs().amax(-1)
    assert float(rel.max()) <= 2 * 2.0 ** -7


FLASH_F32 = [c[:7] for c in FLASH_SWEEP if c[-1] == "float32"]


def _jax_flash_f32(arrays, causal):
    return np.asarray(jax_flash(*(jnp.asarray(a) for a in arrays),
                                causal=causal, interpret=True))


@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,causal", FLASH_F32)
def test_flash_3xtf32_design_matches_jax(B, Sq, Skv, H, KV, d, causal):
    """The split products stay within the fp32 limit (2e-5) of the JAX
    package's kernel on every fp32 case of the sweep."""
    arrays = _flash_inputs(B, Sq, Skv, H, KV, d)
    j = _jax_flash_f32(arrays, causal)
    t = flash_3xtf32_design(*(torch.from_numpy(a) for a in arrays),
                            causal).numpy()
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, atol=FLASH_TOL["float32"], rtol=0)
    if causal and Sq > Skv:
        assert not t[:, :Sq - Skv].any()


def test_one_tf32_product_misses_the_fp32_limit():
    """Why the kernel splits: with one TF32 product per matrix product the
    first fp32 case of the sweep is off by more than 2e-5, the three
    products are within it."""
    B, Sq, Skv, H, KV, d, causal = FLASH_F32[0]
    arrays = _flash_inputs(B, Sq, Skv, H, KV, d)
    j = _jax_flash_f32(arrays, causal)
    tensors = [torch.from_numpy(a) for a in arrays]
    one = np.abs(flash_3xtf32_design(*tensors, causal, products=1).numpy()
                 - j).max()
    three = np.abs(flash_3xtf32_design(*tensors, causal).numpy() - j).max()
    assert one > FLASH_TOL["float32"] >= three


@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,causal", FLASH_D16)
def test_flash_d16_design_matches_jax(B, Sq, Skv, H, KV, d, causal):
    """fp32 at head dim 16 (``flash_d16.cuh``: 3xTF32 on mma.sync over
    64-key tiles, two warps a row each taking half of every tile, merged
    at the end; P·V's keys of each group of 8 in the order 0 2 4 6 1 3 5
    7) stays within the fp32 limit (2e-5) of the JAX package's kernel in
    interpret mode; a row that sees no key gives 0."""
    arrays = _flash_inputs(B, Sq, Skv, H, KV, d, seed=Sq + Skv)
    j = _jax_flash_f32(arrays, causal)
    t = flash_3xtf32_design(*(torch.from_numpy(a) for a in arrays), causal,
                            key_tile=D16_KEY_TILE,
                            key_split=D16_KEY_SPLIT).numpy()
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, atol=FLASH_TOL["float32"], rtol=0)
    if causal and Sq > Skv:
        assert not t[:, :Sq - Skv].any()


def _mma_m16n8k8(a, b, c):
    """One ``mma.sync.m16n8k8`` (tf32) from the 32 lanes' registers: a
    [32, 4] (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b [32,
    2] (k t, col g), (t + 4, g); c, the result, [32, 4] (g, 2t),
    (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1); g = lane / 4, t = lane %
    4. Each element of A and B is held by exactly one lane."""
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    A, B = torch.zeros(16, 8), torch.zeros(8, 8)
    seen_a = torch.zeros(16, 8, dtype=torch.int64)
    seen_b = torch.zeros(8, 8, dtype=torch.int64)
    for r, (row, col) in enumerate(((g, t), (g + 8, t), (g, t + 4),
                                    (g + 8, t + 4))):
        A[row, col] = a[:, r]
        seen_a[row, col] += 1
    for r, row in enumerate((t, t + 4)):
        B[row, g] = b[:, r]
        seen_b[row, g] += 1
    assert bool((seen_a == 1).all()) and bool((seen_b == 1).all())
    D = A @ B
    return c + torch.stack([D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                            D[g + 8, 2 * t + 1]], 1)


@pytest.mark.parametrize("product", ["q_kt", "p_v"])
def test_d16_fragment_maps_replay_plain_products(product):
    """The register maps of ``flash_d16.cuh`` on a warp's 16 rows and one
    64-key tile, lane by lane, give Q·Kᵀ and P·V bit for bit in fp32 (on
    small integers, so every order of the sums is exact and only a wrong
    map can differ). Q·Kᵀ: k-index t (t + 4) of k-step kk is column
    4t + 2kk (+ 1), each lane's Q and K fragments one float4 of a row.
    P·V: S's C fragment (keys 2t, 2t + 1 of each group of 8) taken as
    P's A fragment (0, 2, 1, 3), which is P with the keys of a group in
    ``_key_order``; B of n-tile nd is V's column 2g + nd; a lane's O
    columns 4t .. 4t + 3 come from both n-tiles."""
    rng = np.random.default_rng(23)
    ints = lambda *s: torch.from_numpy(  # noqa: E731
        rng.integers(-4, 5, s).astype(np.float32))
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    cols = 4 * t[:, None] + torch.arange(4)                     # [32, 4]
    if product == "q_kt":
        Q, K = ints(16, 16), ints(64, 16)
        q0, q8 = Q[g[:, None], cols], Q[g[:, None] + 8, cols]   # float4s
        S = torch.zeros(16, 64)
        for j in range(8):
            kx = K[8 * j + g[:, None], cols]
            c = torch.zeros(32, 4)
            for kk in range(2):
                a = torch.stack([q0[:, 2 * kk], q8[:, 2 * kk],
                                 q0[:, 2 * kk + 1], q8[:, 2 * kk + 1]], 1)
                c = _mma_m16n8k8(a, kx[:, 2 * kk:2 * kk + 2], c)
            for e, (row, key) in enumerate(((g, 2 * t), (g, 2 * t + 1),
                                            (g + 8, 2 * t),
                                            (g + 8, 2 * t + 1))):
                S[row, 8 * j + key] = c[:, e]
        assert torch.equal(S, Q @ K.T)
        return
    P, V = ints(16, 64), ints(64, 16)
    acc = torch.zeros(2, 32, 4)
    for j in range(8):
        c = torch.stack([P[g, 8 * j + 2 * t], P[g, 8 * j + 2 * t + 1],
                         P[g + 8, 8 * j + 2 * t],
                         P[g + 8, 8 * j + 2 * t + 1]], 1)   # S's C fragment
        a = c[:, [0, 2, 1, 3]]
        order = 8 * j + _key_order(8)
        assert torch.equal(a, torch.stack(
            [P[g, order[t]], P[g + 8, order[t]], P[g, order[t + 4]],
             P[g + 8, order[t + 4]]], 1))
        v0 = V[8 * j + 2 * t[:, None], 2 * g[:, None] + torch.arange(2)]
        v1 = V[8 * j + 2 * t[:, None] + 1, 2 * g[:, None] + torch.arange(2)]
        for nd in range(2):
            acc[nd] = _mma_m16n8k8(a, torch.stack([v0[:, nd], v1[:, nd]], 1),
                                   acc[nd])
    O = torch.zeros(16, 16)
    O[g[:, None], cols] = torch.stack([acc[0, :, 0], acc[1, :, 0],
                                       acc[0, :, 1], acc[1, :, 1]], 1)
    O[g[:, None] + 8, cols] = torch.stack([acc[0, :, 2], acc[1, :, 2],
                                           acc[0, :, 3], acc[1, :, 3]], 1)
    assert torch.equal(O, P @ V)


def test_tf32_split_keeps_about_22_bits():
    """hi has its 13 low bits clear and is within 2^-11 of a; hi + lo is
    within 2^-21 of a, on seeded normal values of many magnitudes."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.integers(-6, 7, 100_000))
                         .astype(np.float32))
    hi, lo = split_tf32(a)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert bool(((a - hi).abs() <= 2.0 ** -11 * a.abs()).all())
    err = (a.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -21 * a.double().abs()).all())
    assert torch.equal(tf32(torch.tensor([1.0 + 2.0 ** -11])),
                       torch.tensor([1.0 + 2.0 ** -10]))   # a tie, away


# ---- SSD -------------------------------------------------------------------

def _ssd_inputs(B, L, H, P, G, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    B_ = (rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, B_, C


@pytest.mark.parametrize("Q", [64, 128])
@pytest.mark.parametrize("B,L,H,P,G,N,chunk,dtype", SSD_SWEEP)
def test_ssd_design_matches_jax(B, L, H, P, G, N, chunk, dtype, Q):
    x, dt, A, B_, C = _ssd_inputs(B, L, H, P, G, N)
    jcast = lambda a: jnp.asarray(a).astype(getattr(jnp, dtype))  # noqa
    tcast = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa
    j = np.asarray(jax_ssd_scan(jcast(x), jnp.asarray(dt), jnp.asarray(A),
                                jcast(B_), jcast(C), chunk=chunk,
                                interpret=True).astype(jnp.float32))
    t = ssd_design(tcast(x), torch.from_numpy(dt), torch.from_numpy(A),
                   tcast(B_), tcast(C), Q)
    assert t.dtype == getattr(torch, dtype)
    err = float(np.abs(t.float().numpy() - j).max())
    scale = float(np.abs(j).max())
    assert err <= SSD_RTOL[dtype] * scale
    assert err <= FULL_SSD_RTOL[dtype] * scale


# ---- flash backward --------------------------------------------------------

BWD_KEY_TILE = 128      # flash_attention_bwd_sm90.cu kBN1 (pass 1)
BWD_CTA_KEYS = 128      # kBN2 (pass 2: two warpgroups of 64 keys)
BWD_QUERY_TILE = 64     # kBM2 (pass 2)


def _bwd_operands(q, k, v, do):
    """[B, heads, S, 32 or d] float32 views of the bf16 operands (k, v
    per KV head), zero-padded to 32 columns at d 16 as the kernel's tiles
    are."""
    pad = max(0, 32 - q.shape[3])
    return [torch.nn.functional.pad(t.float().permute(0, 2, 1, 3),
                                    (0, pad)) for t in (q, k, v, do)]


def _bwd_mask(Sq, Skv, causal, q_offset, rows, keys):
    """True where query ``rows`` sees key ``keys`` (keys past Skv never)."""
    seen = keys[None, :] < Skv
    if causal:
        seen = seen & (keys[None, :] <= rows[:, None] + q_offset)
    return seen & (rows[:, None] < Sq)


def flash_backward_stats(q, k, v, do, causal: bool, q_offset=None):
    """Pass 1's first sweep: lse (base 2, of S·scale·log2 e) and D per
    query row [B, H, Sq], from the online max, sum and Dacc over key tiles
    of BWD_KEY_TILE."""
    B, Sq, H, d = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    off = Skv - Sq if q_offset is None else q_offset
    qf, kf, vf, dof = _bwd_operands(q, k, v, do)
    kf, vf = (t.repeat_interleave(H // KV, 1) for t in (kf, vf))
    sl2 = (1.0 / math.sqrt(d)) * LOG2E
    rows = torch.arange(Sq)
    m = torch.full((B, H, Sq), -math.inf)
    l = torch.zeros(B, H, Sq)
    r = torch.zeros(B, H, Sq)
    for k0 in range(0, Skv, BWD_KEY_TILE):
        kt, vt = (t[:, :, k0:k0 + BWD_KEY_TILE] for t in (kf, vf))
        s = qf @ kt.transpose(-1, -2)
        dp = dof @ vt.transpose(-1, -2)
        seen = _bwd_mask(Sq, Skv, causal, off, rows,
                         torch.arange(k0, k0 + kt.shape[2]))
        s = s.masked_fill(~seen, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        ms = torch.where(m_new == -math.inf, torch.zeros(()), m_new * sl2)
        alpha = torch.exp2(m * sl2 - ms)
        p = torch.exp2(s * sl2 - ms[..., None])
        l = l * alpha + p.sum(-1)
        r = r * alpha + (p * dp).sum(-1)
        m = m_new
    lse = torch.where(l > 0, m * sl2 + torch.log2(l), torch.zeros(()))
    D = torch.where(l > 0, r / l, torch.zeros(()))
    return lse, D


def flash_backward_design(q, k, v, do, causal: bool, q_offset=None):
    """q, do [B, Sq, H, d], k/v [B, Skv, KV, d] bf16 → (dq, dk, dv) bf16,
    the way the backward kernel computes them. ``q_offset`` as
    ``chunked_attention`` takes it (query i sees key j <= i + q_offset);
    the kernel's is always Skv - Sq, the default."""
    B, Sq, H, d = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    rep = H // KV
    off = Skv - Sq if q_offset is None else q_offset
    scale = 1.0 / math.sqrt(d)
    sl2 = scale * LOG2E
    lse, D = flash_backward_stats(q, k, v, do, causal, q_offset)
    qf, kf, vf, dof = _bwd_operands(q, k, v, do)
    rows = torch.arange(Sq)

    def p_ds(qs, dos, kt, vt, row_ids, key_ids, lse_r, D_r):
        """P and dS (fp32) of query rows against keys."""
        s = qs @ kt.transpose(-1, -2)
        dp = dos @ vt.transpose(-1, -2)
        seen = _bwd_mask(Sq, Skv, causal, off, row_ids, key_ids)
        s = s.masked_fill(~seen, -math.inf)
        p = torch.exp2(s * sl2 - lse_r[..., None])
        return p, p * (dp - D_r[..., None]) * scale

    # pass 1, second sweep: dQ += bf16(dS)·K over key tiles of
    # BWD_KEY_TILE, in order, in fp32; rounded to bf16 once
    kr, vr = (t.repeat_interleave(rep, 1) for t in (kf, vf))
    dq = torch.zeros_like(qf)
    for k0 in range(0, Skv, BWD_KEY_TILE):
        kt, vt = kr[:, :, k0:k0 + BWD_KEY_TILE], vr[:, :, k0:k0 + BWD_KEY_TILE]
        _, ds = p_ds(qf, dof, kt, vt, rows,
                     torch.arange(k0, k0 + kt.shape[2]), lse, D)
        dq = dq + ds.bfloat16().float() @ kt
    # pass 2: per warpgroup of 64 keys, dK and dV over the GQA group's
    # heads, query tiles of 64 from the warpgroup's causal frontier
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    n_qt = -(-Sq // BWD_QUERY_TILE)
    for w0 in range(0, Skv, BWD_CTA_KEYS // 2):
        keys = torch.arange(w0, w0 + 64)
        kt, vt = kf[:, :, w0:w0 + 64], vf[:, :, w0:w0 + 64]
        first = max(0, w0 - off) // BWD_QUERY_TILE if causal else 0
        acc_k = torch.zeros(B, KV, kt.shape[2], qf.shape[3])
        acc_v = torch.zeros_like(acc_k)
        for r_ in range(rep):
            heads = torch.arange(KV) * rep + r_
            for qt in range(first, n_qt):
                q0 = qt * BWD_QUERY_TILE
                sl = slice(q0, q0 + BWD_QUERY_TILE)
                p, ds = p_ds(qf[:, heads, sl], dof[:, heads, sl], kt, vt,
                             rows[sl], keys[:kt.shape[2]],
                             lse[:, heads, sl], D[:, heads, sl])
                acc_v = acc_v + p.bfloat16().float().transpose(-1, -2) \
                    @ dof[:, heads, sl]
                acc_k = acc_k + ds.bfloat16().float().transpose(-1, -2) \
                    @ qf[:, heads, sl]
        dk[:, :, w0:w0 + 64] = acc_k
        dv[:, :, w0:w0 + 64] = acc_v
    return tuple(t[..., :d].permute(0, 2, 1, 3).contiguous().bfloat16()
                 for t in (dq, dk, dv))


def _bwd_arrays(B, Sq, Skv, H, KV, d, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((B, Sq, H, d), (B, Skv, KV, d),
                             (B, Skv, KV, d), (B, Sq, H, d)))
    return (q * q_scale).astype(np.float32), k, v, do


def _jax_grads(q, k, v, do, causal, q_offset):
    """jax.grad of chunked_attention in bf16, cotangent ``do``."""
    Sq = q.shape[1]

    def f(q, k, v):
        o = chunked_attention(q, k, v, causal=causal, q_chunk=Sq,
                              q_offset=q_offset)
        return jnp.sum(o.astype(jnp.float32) * do)
    return [np.asarray(g, np.float32) for g in jax.jit(jax.grad(
        f, argnums=(0, 1, 2)))(*(jnp.asarray(a, jnp.bfloat16)
                                 for a in (q, k, v)))]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,causal", FLASH_BWD_SWEEP)
def test_flash_backward_design_matches_jax_grad(B, Sq, Skv, H, KV, d,
                                                causal):
    """Each gradient within 5e-2·max|g| of jax.grad(chunked_attention) on
    the same bf16 inputs. Rows that see no key (causal, Sq > Skv) give 0
    in the port, where chunked_attention's -1e30 mask spreads them
    uniformly over the keys: their cotangent is 0 here, and their dq must
    be 0 exactly."""
    q, k, v, do = _bwd_arrays(B, Sq, Skv, H, KV, d, seed=Sq + d)
    blind = max(0, Sq - Skv) if causal else 0
    do[:, :blind] = 0.0
    want = _jax_grads(q, k, v, do, causal, Skv - Sq)
    got = flash_backward_design(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v, do)), causal)
    for name, g, w in zip("qkv", got, want):
        g = g.float().numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), name
        err = np.abs(g - w).max()
        assert err <= FLASH_BWD_RTOL * np.abs(w).max(), (name, err)
    if blind:
        q2 = torch.from_numpy(q).bfloat16()
        do2 = torch.randn(q2.shape).bfloat16()
        dq, _, _ = flash_backward_design(q2, torch.from_numpy(k).bfloat16(),
                                         torch.from_numpy(v).bfloat16(), do2,
                                         causal)
        assert not dq[:, :blind].any()


def test_flash_backward_online_d_is_the_two_pass_rowsum():
    """Near-uniform rows (q scaled by 1e-3, so dP - D is a small
    difference): pass 1's online D equals rowsum(P ⊙ dP) taken in float64
    in two passes (softmax first) within fp32 rounding, 1e-5 of
    rowsum(|P ⊙ dP|); lse within 1e-5 of the float64 log2-sum-exp2."""
    B, Sq, Skv, H, KV, d = 1, 200, 333, 4, 2, 64
    q, k, v, do = _bwd_arrays(B, Sq, Skv, H, KV, d, seed=11, q_scale=1e-3)
    t = [torch.from_numpy(a).bfloat16() for a in (q, k, v, do)]
    lse, D = flash_backward_stats(*t, causal=True)
    q64, k64, v64, do64 = (x.double().permute(0, 2, 1, 3) for x in t)
    k64, v64 = (x.repeat_interleave(H // KV, 1) for x in (k64, v64))
    s = q64 @ k64.transpose(-1, -2) / math.sqrt(d)
    keep = torch.arange(Skv)[None, :] <= torch.arange(Sq)[:, None] + Skv - Sq
    s = s.masked_fill(~keep, -math.inf)
    p = torch.softmax(s, -1)
    pdp = p * (do64 @ v64.transpose(-1, -2))
    assert bool(((D.double() - pdp.sum(-1)).abs()
                 <= 1e-5 * pdp.abs().sum(-1)).all())
    lse64 = torch.logsumexp(s, -1) * LOG2E
    assert bool(((lse.double() - lse64).abs() <= 1e-5 * lse64.abs().clamp(
        min=1.0)).all())


def test_flash_backward_design_key_tile_no_query_sees():
    """A key tile that no query sees gives dk = dv = 0 exactly, and the
    keys that are seen still match jax.grad: q_offset 0 with Sq 64 <
    Skv 320 (the kernel's own offset is Skv - Sq, under which the last
    query sees every key; this holds its frontier logic to the case)."""
    B, Sq, Skv, H, KV, d = 1, 64, 320, 4, 2, 32
    q, k, v, do = _bwd_arrays(B, Sq, Skv, H, KV, d, seed=3)
    want = _jax_grads(q, k, v, do, True, 0)
    got = flash_backward_design(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v, do)), True,
        q_offset=0)
    for name, g, w in zip("qkv", got, want):
        g = g.float().numpy()
        err = np.abs(g - w).max()
        assert err <= FLASH_BWD_RTOL * np.abs(w).max(), (name, err)
    for g in got[1:]:
        assert not g[:, Sq:].float().any()      # keys 64..319: none seen


@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,causal",
                         [(1, 300, 300, 4, 2, 128, True),
                          (1, 200, 150, 5, 1, 64, False)])
def test_flash_backward_design_no_less_accurate_than_the_formula(
        B, Sq, Skv, H, KV, d, causal):
    """Against the formula in fp32 on the same (bf16) values, each
    gradient of the replay is within 2 × the bf16 formula's own error +
    1e-3·max|g|, the limit chip_smoke.py holds the kernel to."""
    q, k, v, do = _bwd_arrays(B, Sq, Skv, H, KV, d, seed=7)
    t = [torch.from_numpy(a).bfloat16() for a in (q, k, v, do)]
    exact = flash_attention_backward(*(x.float() for x in t), causal)
    formula = flash_attention_backward(*t, causal)
    design = flash_backward_design(*t, causal)
    for name, e, f, g in zip("qkv", exact, formula, design):
        mx = float(e.abs().max())
        e_f = float((f.float() - e).abs().max())
        e_g = float((g.float() - e).abs().max())
        assert e_g <= 2 * e_f + 1e-3 * mx, (name, e_g, e_f)


# ---- SSD backward ----------------------------------------------------------

SSD_BWD_CHUNK = 64      # ssd_scan_bwd_sm90.cu (and ssd_scan.cu) kQ
SSD_BWD_HEADS = 16      # ssd_scan_bwd_sm90.cu kHeadsPerBlock
# the SSD_SWEEP shapes (B, L, H, P, G, N, chunk), each once, one L below a
# chunk, and two with more heads a group than an adjoint block walks
# (dB and dC summed over 3 blocks of 8 and 2 of 16)
SSD_BWD_SHAPES = sorted({c[:7] for c in SSD_SWEEP}) + [
    (2, 40, 4, 16, 1, 32, 64), (1, 130, 24, 16, 1, 32, 64),
    (1, 200, 64, 16, 2, 32, 64)]


def _heads_per_block(H: int, G: int) -> int:
    """The heads of one group that an adjoint block walks: the largest
    power of 2 up to SSD_BWD_HEADS that divides H / G."""
    hb = SSD_BWD_HEADS
    while (H // G) % hb:
        hb //= 2
    return hb


def _sum_heads(t, G: int, hb: int):
    """[B, L, H, N] float32 → [B, L, G, N]: each group's heads summed in
    head order inside blocks of hb, then the blocks in order, as the
    adjoint and group_sum sum them."""
    Bb, L, H, N = t.shape
    t = t.reshape(Bb, L, G, H // G // hb, hb, N)
    blocks = t[..., 0, :]
    for i in range(1, hb):
        blocks = blocks + t[..., i, :]
    out = blocks[..., 0, :]
    for r in range(1, blocks.shape[3]):
        out = out + blocks[..., r, :]
    return out


def _unchunk(t, L):
    """[B, nc, Q, ...] → [B, L, ...]."""
    return t.reshape(t.shape[0], -1, *t.shape[3:])[:, :L]


def ssd_backward_design(x, dt, A, B_, C, dy, Q: int = SSD_BWD_CHUNK):
    """x, dy [B,L,H,P], dt [B,L,H] f32, A [H] f32, B_/C [B,L,G,N] → (dx,
    ddt, dA, dB_, dC) in their inputs' types, the way the backward kernel
    computes them over chunks of Q steps: (0) the forward's chunk states
    and the states entering each chunk (B·w and h_in rounded as the
    forward rounds them); (1) each chunk's state cotangent dh_in =
    (C·e^cum)ᵀ·dY; (2) a reverse pass over the chunks, Gh[c] = dh_in[c] +
    e^T_c·Gh[c+1] with dS_c = Gh[c+1]; (3) one adjoint per chunk and head;
    (4) da the reverse running sum of dcum plus dT, ddt and dA from it, dB
    and dC summed over each group's heads in head order, in blocks of the
    heads an adjoint block walks, then over the blocks in order. In bf16
    the operands the products take are rounded where the kernel rounds
    them: B·w, h_in, C·e^cum, dS, M and dM∘L∘dt; every sum is float32."""
    rnd = x.dtype == torch.bfloat16
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    nc = -(-L // Q)
    pad = nc * Q - L

    def chunks(t):        # [B, L, ...] → [B, nc, Q, ...], zeros past L
        widths = (0, 0) * (t.dim() - 2) + (0, pad)
        t = torch.nn.functional.pad(t.float(), widths)
        return t.reshape(Bb, nc, Q, *t.shape[2:])

    xc, dyc, dtc = chunks(x), chunks(dy), chunks(dt)
    Bc = chunks(B_).repeat_interleave(rep, 3)                    # [B,nc,Q,H,N]
    Cc = chunks(C).repeat_interleave(rep, 3)
    Af = A.float()
    cum = torch.cumsum(dtc * Af, dim=2)                          # [B,nc,Q,H]
    total = cum[:, :, -1]                                        # [B,nc,H]
    w = dtc * torch.exp(total[:, :, None] - cum)
    # (0) the forward's chunk states and the states entering each chunk
    S = torch.einsum("bcjhn,bcjhp->bchnp", _bf16(Bc * w[..., None], rnd), xc)
    h_in = torch.zeros_like(S)
    run = torch.zeros_like(S[:, 0])
    for c in range(nc):
        h_in[:, c] = run
        run = torch.exp(total[:, c])[..., None, None] * run + S[:, c]
    h_in = _bf16(h_in, rnd)
    # (1) the state cotangent of each chunk's carry-in term
    Ce = _bf16(Cc * torch.exp(cum)[..., None], rnd)
    dh = torch.einsum("bcjhn,bcjhp->bchnp", Ce, dyc)
    # (2) the reverse pass: dS_c = Gh[c+1]
    dS = torch.zeros_like(dh)
    g = torch.zeros_like(dh[:, 0])
    for c in reversed(range(nc)):
        dS[:, c] = g
        g = dh[:, c] + torch.exp(total[:, c])[..., None, None] * g
    dS = _bf16(dS, rnd)
    # (3) the adjoint of each chunk: the diagonal term
    CB = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    dM = torch.einsum("bcihp,bcjhp->bchij", dyc, xc)
    cum_h = cum.permute(0, 1, 3, 2)                              # [B,nc,H,Q]
    mask = torch.ones(Q, Q, dtype=torch.bool).tril()
    seg = torch.where(mask, cum_h[..., :, None] - cum_h[..., None, :],
                      torch.zeros(()))
    Lm = torch.where(mask, torch.exp(seg), torch.zeros(()))
    dt_j = dtc.permute(0, 1, 3, 2)[..., None, :]
    M = _bf16(CB * Lm * dt_j, rnd)
    dCB = dM * Lm * dt_j
    dCBr = _bf16(dCB, rnd)
    Z = dCB * CB
    row_z = Z.sum(-1).permute(0, 1, 3, 2)                        # [B,nc,Q,H]
    col_z = Z.sum(-2).permute(0, 1, 3, 2)
    col_w = (dM * CB * Lm).sum(-2).permute(0, 1, 3, 2)
    # the chunk-state term, through dS
    P1 = torch.einsum("bcjhn,bchnp->bcjhp", Bc, dS)
    dw = (xc * P1).sum(-1)                                       # [B,nc,Q,H]
    dX = torch.einsum("bchij,bcihp->bcjhp", M, dyc) + w[..., None] * P1
    dB = (torch.einsum("bchij,bcihn->bcjhn", dCBr, Cc)
          + w[..., None] * torch.einsum("bcjhp,bchnp->bcjhn", xc, dS))
    # the carry-in term
    eT = torch.exp(cum)[..., None] * torch.einsum("bcihp,bchnp->bcihn", dyc,
                                                  h_in)
    dcin = (eT * Cc).sum(-1)
    dC = torch.einsum("bchij,bcjhn->bcihn", dCBr, Bc) + eT
    dT = (torch.exp(total) * (h_in * dS).sum((-1, -2))
          + (dw * w).sum(2))                                     # [B,nc,H]
    # (4) finish
    dcum = row_z - col_z + dcin - dw * w
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2]) \
        + dT[:, :, None]
    ddt = col_w + dw * torch.exp(total[:, :, None] - cum) + Af * da
    dA = (dtc * da).sum((0, 1, 2))
    hb = _heads_per_block(H, G)
    dB = _sum_heads(_unchunk(dB, L), G, hb)
    dC = _sum_heads(_unchunk(dC, L), G, hb)
    return (_unchunk(dX, L).to(x.dtype), _unchunk(ddt, L).to(dt.dtype),
            dA.to(A.dtype), dB.to(B_.dtype), dC.to(C.dtype))


def _ssd_bwd_arrays(B, L, H, P, G, N, seed):
    x, dt, A, B_, C = _ssd_inputs(B, L, H, P, G, N, seed)
    dy = np.random.default_rng(seed + 1).standard_normal(
        (B, L, H, P)).astype(np.float32)
    return (x, dt, A, B_, C), dy


def _jax_ssd_grads(arrays, dy, chunk, dtype):
    """jax.grad of ``models.ssm.ssd_chunked``'s y (the JAX package trains
    mamba2 by XLA's autodiff of it) with cotangent dy: x, B_, C in
    ``dtype``, dt and A float32, as the model hands them to the scan."""
    jdt = getattr(jnp, dtype)
    types = (jdt, jnp.float32, jnp.float32, jdt, jdt)

    def f(*args):
        y, _ = ssd_chunked(*args, chunk)
        return jnp.sum(y.astype(jnp.float32) * dy)
    return [np.asarray(g, np.float32) for g in jax.jit(jax.grad(
        f, argnums=(0, 1, 2, 3, 4)))(*(jnp.asarray(a, t)
                                       for a, t in zip(arrays, types)))]


def _ssd_bwd_tensors(arrays, dy, dtype):
    dt_ = getattr(torch, dtype)
    x, dt, A, B_, C = (torch.from_numpy(a) for a in arrays)
    return (x.to(dt_), dt, A, B_.to(dt_), C.to(dt_)), torch.from_numpy(
        dy).to(dt_)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SSD_BWD_SHAPES)
def test_ssd_backward_design_matches_jax_grad(B, L, H, P, G, N, chunk,
                                              dtype):
    """Each of dx, ddt, dA, dB_, dC within SSD_BWD_RTOL[dtype]·max|g| of
    jax.grad of ssd_chunked on the same inputs and cotangent: bf16 with
    the kernel's rounding points, fp32 with none."""
    arrays, dy = _ssd_bwd_arrays(B, L, H, P, G, N, seed=L + P + G)
    want = _jax_ssd_grads(arrays, dy, chunk, dtype)
    ins, dyt = _ssd_bwd_tensors(arrays, dy, dtype)
    got = ssd_backward_design(*ins, dyt)
    for name, g, w, t in zip(("dx", "ddt", "dA", "dB_", "dC"), got, want,
                             ins):
        assert g.dtype == t.dtype and g.shape == t.shape, name
        g = g.float().numpy()
        assert np.isfinite(g).all(), name
        err = float(np.abs(g - w).max())
        assert err <= SSD_BWD_RTOL[dtype] * float(np.abs(w).max()), (name,
                                                                      err)


@pytest.mark.parametrize("B,L,H,P,G,N,chunk",
                         [(2, 200, 4, 16, 2, 32, 64),
                          (1, 256, 8, 64, 1, 128, 128)])
def test_ssd_backward_design_no_less_accurate_than_the_formula(
        B, L, H, P, G, N, chunk):
    """Against a float64 autodiff of the chunked form on the same (bf16)
    values, each gradient of the bf16 replay is within 2 × the bf16
    formula's own error + 1e-3·max|g|, the limit chip_smoke.py holds the
    kernel to against the formula in fp32."""
    arrays, dy = _ssd_bwd_arrays(B, L, H, P, G, N, seed=5)
    ins, dyt = _ssd_bwd_tensors(arrays, dy, "bfloat16")
    t64 = [t.double().requires_grad_(True) for t in ins]
    y64, _ = port_ssd_chunked(*t64, chunk)
    exact = torch.autograd.grad(y64, t64, dyt.double())
    formula = ssd_scan_backward(*ins, chunk, dyt)
    design = ssd_backward_design(*ins, dyt)
    for name, e, f, g in zip(("dx", "ddt", "dA", "dB_", "dC"), exact,
                             formula, design):
        mx = float(e.abs().max())
        e_f = float((f.double() - e).abs().max())
        e_g = float((g.double() - e).abs().max())
        assert e_g <= 2 * e_f + 1e-3 * mx, (name, e_g, e_f)
