"""The port's CUDA kernels on a card: each against its plain torch version.

These tests need a CUDA card and skip elsewhere; the fixture decides, so
every process collects the same tests. The file imports no JAX, so it
runs where only PyTorch is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.window_agg import (window_aggregate,
                                            window_aggregate_reference)
from repro_torch.kernels.window_agg.kernel import (segment_reduce,
                                                   segment_reduce_plain)
from repro_torch.pipeline import HybridExecutor

torch.set_num_threads(2)

# the sweep of tests/test_kernels_window.py
SWEEP = [
    (600, 5, 180, 60, "max", "float32"),
    (600, 5, 180, 60, "mean", "float32"),
    (1024, 130, 256, 64, "sum", "float32"),
    (777, 3, 120, 40, "min", "float32"),
    (2000, 1, 500, 100, "mean", "float32"),
    (512, 128, 128, 128, "max", "bfloat16"),
]
RTOL_SUM = {"float32": 1e-5, "bfloat16": 1e-1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("T,C,w,s,agg,dtype", SWEEP)
def test_kernel_matches_plain(cuda, T, C, w, s, agg, dtype):
    """max/min equal to the plain version, sum within rtol · Σ|x| (the
    scale of fp32 rounding in a sum), reruns bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(T, C, device=cuda, generator=g) * 10).to(
        getattr(torch, dtype))
    for a in ("max", "min", "sum"):
        before = segment_reduce.launches
        k = segment_reduce(x, agg=a, stride=s)
        assert segment_reduce.launches == before + 1
        p = segment_reduce_plain(x, agg=a, stride=s)
        if a == "sum":
            scale = segment_reduce_plain(x.abs(), agg="sum", stride=s).float()
            err = (k.float() - p.float()).abs()
            assert bool((err <= RTOL_SUM[dtype] * scale).all())
        else:
            assert torch.equal(k, p)
        assert torch.equal(k, segment_reduce(x, agg=a, stride=s))
    tol = 1e-4 if dtype == "float32" else 1e-1
    out = window_aggregate(x, agg=agg, window=w, stride=s)
    ref = window_aggregate_reference(x, agg=agg, window=w, stride=s)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(64, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        segment_reduce(x[:, ::2], agg="max", stride=4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        segment_reduce(x.double(), agg="max", stride=4)
    with pytest.raises(ValueError, match="stride"):
        segment_reduce(x, agg="max", stride=65)


@pytest.mark.gpu
def test_kernel_propagates_nan(cuda):
    x = torch.randn(1000, 4, device=cuda)
    x[5, 1] = float("nan")
    for a in ("max", "min", "sum"):
        k = segment_reduce(x, agg=a, stride=100)
        assert k[0, 1].isnan() and not k[1:, 1].isnan().any()
        assert not k[:, [0, 2, 3]].isnan().any()


@pytest.mark.gpu
@pytest.mark.parametrize("agg", ["mean", "max"])
def test_executor_offloads_through_the_kernel(cuda, agg):
    rng = np.random.default_rng(0)
    vals = np.maximum(rng.standard_normal(1_000_000, dtype=np.float32) * 4e6
                      + 20e6, np.float32(0.1e6))
    hx = HybridExecutor()
    before = segment_reduce.launches
    got = hx.run_window(vals, agg)
    assert segment_reduce.launches == before + 1 and hx.offloads == 1
    if agg == "max":
        assert got == float(vals.max())
    else:
        assert got == pytest.approx(vals.mean(dtype=np.float64), rel=1e-5)
