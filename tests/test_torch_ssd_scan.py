"""The port's SSD scan against the JAX package's: on the CPU the port runs
the kernel's plain version (the sequential recurrence of
``ref.ssd_scan_reference``) and JAX runs its Pallas kernel in interpret
mode, on the same numpy-seeded inputs and with the tolerances of
tests/test_kernels_ssd.py. The CUDA kernel itself is held against the
plain version in test_torch_gpu.py, on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan import ssd_scan_reference as jax_ssd_reference
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_reference
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_blh
from repro_torch.kernels.ssd_scan.ops import ssd_scan_flops
from repro_torch.kernels.sweeps import SSD_RTOL, SSD_SWEEP

torch.set_num_threads(2)

# (B, L, H, P, G, N, chunk, dtype, rtol): tests/test_kernels_ssd.py
SWEEP = [(*c, SSD_RTOL[c[-1]]) for c in SSD_SWEEP]


def _inputs(B, L, H, P, G, N, seed=0):
    """x, dt (post-softplus), A (negative), B_, C as float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(np.float32)
    B_ = (rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32)
    return x, dt, A, B_, C


def _typed(arrays, dtype, lib):
    """x, B_ and C in ``dtype``; dt and A stay float32, as in the JAX
    sweep."""
    x, dt, A, B_, C = arrays
    if lib == "jax":
        cast = lambda a: jnp.asarray(a).astype(getattr(jnp, dtype))  # noqa
        return cast(x), jnp.asarray(dt), jnp.asarray(A), cast(B_), cast(C)
    cast = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa
    return (cast(x), torch.from_numpy(dt), torch.from_numpy(A), cast(B_),
            cast(C))


@pytest.mark.parametrize("B,L,H,P,G,N,chunk,dtype,rtol", SWEEP)
def test_ssd_matches_jax(B, L, H, P, G, N, chunk, dtype, rtol):
    arrays = _inputs(B, L, H, P, G, N)
    j = np.asarray(jax_ssd_scan(*_typed(arrays, dtype, "jax"), chunk=chunk,
                                interpret=True).astype(jnp.float32))
    t = ssd_scan(*_typed(arrays, dtype, "torch"), chunk=chunk)
    assert t.shape == (B, L, H, P) and t.dtype == getattr(torch, dtype)
    t = t.float().numpy()
    scale = float(np.abs(j).max())
    np.testing.assert_allclose(t / scale, j / scale, atol=rtol)


@pytest.mark.parametrize("B,L,H,P,G,N", [(1, 64, 2, 16, 1, 32),
                                         (2, 50, 4, 8, 2, 16)])
def test_reference_matches_jax_reference(B, L, H, P, G, N):
    """The two sequential oracles agree in float32 to rounding."""
    arrays = _inputs(B, L, H, P, G, N, seed=7)
    j = np.asarray(jax_ssd_reference(*(jnp.asarray(a) for a in arrays)))
    t = ssd_scan_reference(*(torch.from_numpy(a) for a in arrays)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5 * float(np.abs(j).max()))


@pytest.mark.parametrize("L,chunk", [(128, 64), (200, 64), (256, 256)])
def test_flop_counter_counts_the_chunk_products(L, chunk):
    """FlopCounterMode counts the op by its formula at the caller's chunk,
    not the einsums of the plain version."""
    arrays = _inputs(1, L, 2, 16, 1, 8)
    with FlopCounterMode(display=False) as fc:
        ssd_scan(*(torch.from_numpy(a) for a in arrays), chunk=chunk)
    n_chunks = -(-L // chunk)
    Q, N, P = chunk, 8, 16
    want = 2 * n_chunks * (2 * Q * Q * N + 2 * Q * Q * P + 4 * Q * N * P)
    assert fc.get_total_flops() == want
    assert ssd_scan_flops((1, L, 2, 16), (1, L, 1, 8), chunk) == want


@pytest.mark.parametrize("L,chunk", [(128, 64), (200, 64)])
def test_flop_counter_counts_the_backward_op(L, chunk):
    """The gradient is one op, ``repro_torch::ssd_scan_backward``, which
    FlopCounterMode counts as three forwards (the chunk products
    recomputed, and two of the same size for each), not by what its
    formula runs inside: a forward and backward count four."""
    arrays = _inputs(1, L, 2, 16, 1, 8)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    with FlopCounterMode(display=False) as fc:
        ssd_scan(*ins, chunk=chunk).sum().backward()
    fwd = ssd_scan_flops((1, L, 2, 16), (1, L, 1, 8), chunk)
    assert fc.get_total_flops() == 4 * fwd
    assert fc.get_flop_counts()["Global"][
        torch.ops.repro_torch.ssd_scan_backward] == 3 * fwd


def test_chunk_does_not_change_the_cpu_result():
    tensors = [torch.from_numpy(a) for a in _inputs(1, 96, 2, 8, 1, 8, 3)]
    assert torch.equal(ssd_scan(*tensors, chunk=32), ssd_scan(*tensors))
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan(*tensors, chunk=0)


def test_kernel_wrapper_takes_cuda_tensors_only():
    x, dt, A, B_, C = (torch.from_numpy(a) for a in _inputs(1, 32, 2, 8, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_blh(x, dt, A, B_, C)
    with pytest.raises(ValueError, match="P, N <= 128"):
        ssd_scan_blh(x, dt, A, B_.expand(1, 32, 1, 8).repeat(1, 1, 1, 17),
                     C.repeat(1, 1, 1, 17))
    with pytest.raises(ValueError, match="multiple of G"):
        ssd_scan_blh(x[:, :, :1].expand(1, 32, 3, 8).contiguous(),
                     dt[:, :, :1].expand(1, 32, 3), A[:1].expand(3),
                     B_.repeat(1, 1, 2, 1), C.repeat(1, 1, 2, 1))
