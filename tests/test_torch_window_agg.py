"""The port's window_agg against the JAX package's: on the CPU the port
runs the kernel's plain torch version and JAX runs its Pallas kernel in
interpret mode. The CUDA kernel itself is held against the plain version
in test_torch_gpu.py, on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.window_agg import window_aggregate as jax_window_aggregate
from repro_torch.kernels import build
from repro_torch.kernels.sweeps import WINDOW_SWEEP, WINDOW_TOL
from repro_torch.kernels.window_agg import (window_aggregate,
                                            window_aggregate_reference)
from repro_torch.kernels.window_agg.kernel import (segment_reduce,
                                                   segment_reduce_plain,
                                                   split_rows)

torch.set_num_threads(2)

# the sweep of tests/test_kernels_window.py
SWEEP, TOL = WINDOW_SWEEP, WINDOW_TOL
AGGS = ("max", "min", "sum", "mean")


def _draws(n=12, seed=2024):
    """Seeded (m, stride, n_windows, agg, data seed) with strides that are
    multiples of 17, so never powers of two."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(1, 9)), 17 * int(rng.integers(1, 7)),
             int(rng.integers(1, 13)), AGGS[i % 4], int(rng.integers(2**31)))
            for i in range(n)]


def _both(x: np.ndarray, dtype: str, **kw):
    """(JAX, port) outputs of the same window aggregation, as float32."""
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    j = np.asarray(jax_window_aggregate(jx, interpret=True, **kw)
                   .astype(jnp.float32))
    return j, window_aggregate(tx, **kw).float().numpy()


@pytest.mark.parametrize("T,C,w,s,agg,dtype", SWEEP)
def test_window_matches_jax(T, C, w, s, agg, dtype):
    x = np.random.default_rng(0).standard_normal((T, C)).astype(np.float32)
    x *= 10
    j, t = _both(x, dtype, agg=agg, window=w, stride=s)
    assert t.shape == j.shape == ((T - w) // s + 1, C)
    np.testing.assert_allclose(t, j, atol=TOL[dtype], rtol=TOL[dtype])
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = window_aggregate_reference(tx, agg=agg, window=w, stride=s)
    np.testing.assert_allclose(t, ref.float().numpy(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("m,stride,n_windows,agg,seed", _draws())
def test_window_random_shapes_match_jax(m, stride, n_windows, agg, seed):
    window = m * stride
    T = window + (n_windows - 1) * stride
    x = np.random.default_rng(seed).standard_normal((T, 3)).astype(np.float32)
    j, t = _both(x, "float32", agg=agg, window=window, stride=stride)
    assert t.shape == (n_windows, 3)
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("T,window,stride", [(100, 50, 33), (40, 50, 10)],
                         ids=["nonmultiple", "shorter_than_window"])
def test_window_rejects_bad_shapes(T, window, stride):
    with pytest.raises(ValueError):
        jax_window_aggregate(jnp.zeros((T, 1)), agg="max", window=window,
                             stride=stride, interpret=True)
    with pytest.raises(ValueError):
        window_aggregate(torch.zeros(T, 1), agg="max", window=window,
                         stride=stride)


@pytest.mark.parametrize("agg", AGGS)
def test_nan_propagates_like_jax(agg):
    x = np.random.default_rng(1).standard_normal((240, 4)).astype(np.float32)
    x[70, 2] = np.nan
    j, t = _both(x, "float32", agg=agg, window=60, stride=30)
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert np.isnan(t[:, 2]).sum() == 2          # the two windows over row 70
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=1e-4)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (650, 7)).astype(np.float32))
    before = segment_reduce.launches
    for agg in ("max", "min", "sum"):
        out = segment_reduce(x, agg=agg, stride=100)
        assert out.shape == (6, 7)               # the last 50 rows ignored
        assert torch.equal(out, segment_reduce_plain(x, agg=agg, stride=100))
    assert segment_reduce.launches == before


@pytest.mark.parametrize("stride,blocks,sms", [
    (648_000, 4, 132),        # the Q2 fold: one segment, 4 column tiles
    (7_813, 4, 132),          # a 1,000,000-record fold
    (60, 46_080, 132),        # the fleet shape: enough blocks already
    (5, 1, 132), (1, 1, 132), (100_003, 1, 7)])
def test_split_rows_covers_each_segment(stride, blocks, sms):
    """What the CUDA kernel needs of the host's split: every split
    non-empty, the splits cover the segment, within the grid's limit."""
    n_split, rows = split_rows(stride, blocks, sms)
    assert 1 <= n_split <= 65535 and rows >= 1
    assert (n_split - 1) * rows < stride <= n_split * rows
    if stride >= 32 * 8 * sms:
        assert n_split * blocks >= 4 * sms      # the grid fills the card


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()
