"""The numerical designs of the port's Hopper kernels, checked on the CPU.

The CUDA kernels run only on a card, but their arithmetic can be replayed
here: these test-local torch functions follow the kernels' order of
operations and their bf16 rounding points, and are held against the JAX
package's kernels (Pallas in interpret mode) on the same numpy-seeded
inputs, under the limits of ``repro_torch.kernels.sweeps``.

* ``flash_design``: ``csrc/flash_attention_sm90.cu`` in bf16: key tiles of
  128, an online softmax in fp32 with ``exp2`` and log2(e) folded into the
  scale, P rounded to bf16 before P·V, a row that sees no key giving 0.
* ``flash_3xtf32_design``: ``csrc/flash_attention_sm90_f32.cu`` in fp32:
  each operand split into TF32 parts hi = tf32(a), lo = tf32(a - hi)
  (round to nearest, ties away, emulated on the bits), each product
  lo·hi + hi·lo and then hi·hi with fp32 sums, key tiles of 32, P split
  in registers, V^T's keys of each group of 8 in the order 0 2 4 6 1 3 5
  7; with ``products=1`` one TF32 product instead, the design the split
  replaces.
* ``ssd_design``: ``csrc/ssd_scan.cu``: chunk states, a state pass and
  chunk outputs at chunk length Q; in bf16 the operands computed in
  between are rounded where the kernel rounds them (B·w, h_in, M).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_reference as jax_attention
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels.sweeps import (FLASH_SWEEP, FLASH_TOL,
                                        FULL_FLASH_BF16_ROW_RTOL,
                                        FULL_SSD_RTOL, SSD_RTOL, SSD_SWEEP)

torch.set_num_threads(2)

KEY_TILE = 128          # flash_attention_sm90.cu kBN
F32_KEY_TILE = 32       # flash_attention_sm90_f32.cu kBN
LOG2E = 1.4426950408889634


def flash_design(q, k, v, causal: bool) -> torch.Tensor:
    """q [B, Sq, H, d], k/v [B, Skv, KV, d] bf16 → o bf16, the way the
    wgmma kernel computes it."""
    B, Sq, H, d = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)                           # [B,H,Sq,d]
    kf = k.float().repeat_interleave(H // KV, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(H // KV, 2).permute(0, 2, 1, 3)
    scale_log2 = (1.0 / math.sqrt(d)) * LOG2E
    rows = torch.arange(Sq)[:, None] + (Skv - Sq)
    m = torch.full((B, H, Sq), -math.inf)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, d)
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
    return out.permute(0, 2, 1, 3).bfloat16()


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


def flash_3xtf32_design(q, k, v, causal: bool, products: int = 3
                        ) -> torch.Tensor:
    """q [B, Sq, H, d], k/v [B, Skv, KV, d] fp32 → o fp32, the way the
    3xTF32 kernel computes it (``products=3``), or with one TF32 product
    per matrix product (``products=1``)."""
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
    m = torch.full((B, H, Sq), -math.inf)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, d)
    for k0 in range(0, Skv, F32_KEY_TILE):
        kt, vt = kf[:, :, k0:k0 + F32_KEY_TILE], vf[:, :, k0:k0 + F32_KEY_TILE]
        s = product(qf, kt.transpose(-1, -2))
        keys = torch.arange(k0, k0 + kt.shape[2])[None, :]
        valid = keys <= rows if causal else torch.ones_like(keys <= rows)
        s = s.masked_fill(~valid, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        ms = torch.where(m_new == -math.inf, torch.zeros(()),
                         m_new * scale_log2)
        alpha = torch.exp2(m * scale_log2 - ms)
        p = torch.exp2(s * scale_log2 - ms[..., None])
        l = l * alpha + p.sum(-1)
        order = _key_order(kt.shape[2])
        acc = acc * alpha[..., None] + product(p[..., order], vt[..., order, :])
        m = m_new
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
