"""The port's flash attention against the JAX package's: on the CPU the
port runs the kernel's plain version (``ref.attention_reference``) and
JAX runs its Pallas kernel in interpret mode, on the same numpy-seeded
inputs and with the tolerances of tests/test_kernels_flash.py. The CUDA
kernel itself is held against the plain version in test_torch_gpu.py,
on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import (attention_reference,
                                                 flash_attention)
from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd
from repro_torch.kernels.flash_attention.ops import flash_attention_flops
from repro_torch.kernels.sweeps import FLASH_SWEEP, FLASH_TOL

torch.set_num_threads(2)

# (B, Sq, Skv, H, KV, d, causal, dtype, tol): tests/test_kernels_flash.py
# and a causal case with Sq > Skv, whose first 128 query rows see no key
SWEEP = [(*c, FLASH_TOL[c[-1]]) for c in FLASH_SWEEP]


def _inputs(B, Sq, Skv, H, KV, d, seed=42):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, d)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, d)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, d)).astype(np.float32))


@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,causal,dtype,tol", SWEEP)
def test_flash_matches_jax(B, Sq, Skv, H, KV, d, causal, dtype, tol):
    arrays = _inputs(B, Sq, Skv, H, KV, d)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrays)
    j = np.asarray(jax_flash(jq, jk, jv, causal=causal, interpret=True)
                   .astype(jnp.float32))
    t = flash_attention(tq, tk, tv, causal=causal)
    assert t.shape == (B, Sq, H, d) and t.dtype == tq.dtype
    t = t.float().numpy()
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t, j, atol=tol)
    if causal and Sq > Skv:       # rows that see no key give 0, as on TPU
        assert not t[:, :Sq - Skv].any() and not j[:, :Sq - Skv].any()


def test_block_sizes_do_not_change_the_result():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 256, 256, 4, 4, 64, 0))
    o1 = flash_attention(q, k, v, block_q=128, block_k=128)
    o2 = flash_attention(q, k, v, block_q=64, block_k=256)
    assert torch.equal(o1, o2)
    with pytest.raises(ValueError, match="block sizes"):
        flash_attention(q, k, v, block_q=0)


@pytest.mark.parametrize("Sq,Skv,causal", [(256, 256, True), (200, 300, True),
                                           (256, 128, True), (128, 384, False)])
def test_flop_counter_counts_the_kept_pairs(Sq, Skv, causal):
    """FlopCounterMode counts the op by its formula, 4·d per (query, key)
    pair the mask keeps, and not the matmuls of the plain version."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, Sq, Skv, 2, 1, 32))
    with FlopCounterMode(display=False) as fc:
        flash_attention(q, k, v, causal=causal)
    mask = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        mask = mask.tril(diagonal=Skv - Sq)
    want = 4 * 32 * 2 * int(mask.sum())
    assert fc.get_total_flops() == want
    assert flash_attention_flops((1, Sq, 2, 32), (1, Skv, 1, 32), causal) == want


def test_kernel_wrapper_takes_cuda_tensors_only():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 64, 64, 2, 1, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bshd(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bshd(q[..., :8], k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="multiple of KV"):
        flash_attention_bshd(q[:, :, :1], k.expand(1, 64, 2, 32),
                             v.expand(1, 64, 2, 32))


def test_reference_is_the_cpu_path():
    q, k, v = (torch.from_numpy(a) for a in _inputs(2, 96, 160, 4, 2, 64, 3))
    assert torch.equal(flash_attention(q, k, v),
                       attention_reference(q, k, v))
