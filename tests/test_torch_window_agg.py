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
from repro_torch.kernels.window_agg.kernel import (launch_plan,
                                                   segment_reduce,
                                                   segment_reduce_plain)

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
    counters = ("launches", "vector_launches", "scalar_launches")
    before = [getattr(segment_reduce, c) for c in counters]
    for agg in ("max", "min", "sum"):
        out = segment_reduce(x, agg=agg, stride=100)
        assert out.shape == (6, 7)               # the last 50 rows ignored
        assert torch.equal(out, segment_reduce_plain(x, agg=agg, stride=100))
    assert [getattr(segment_reduce, c) for c in counters] == before


def _coverage(plan, T, C, stride, elsize):
    """How many times the kernel's walk (csrc/window_agg.cu segment_pass)
    visits each (segment, column tile) item and each row of a segment:
    the blocks' grid-stride loop over items, warp w of a block on item
    slot w // lanes, and row lane l of split s on rows s·rows + l,
    + lanes, ... below min((s + 1)·rows, stride)."""
    items = (T // stride) * -(-C // (32 * plan.vec))
    per_block = 8 // plan.lanes
    seen = np.zeros(items, dtype=np.int64)
    for slot in range(per_block):
        first = np.arange(plan.grid[0]) * per_block + slot
        for start in range(0, items, plan.grid[0] * per_block):
            got = first + start
            np.add.at(seen, got[got < items], 1)
    rows = np.zeros(stride, dtype=np.int64)
    for s in range(plan.n_split):
        end = min((s + 1) * plan.rows, stride)
        for lane in range(plan.lanes):
            np.add.at(rows, np.arange(s * plan.rows + lane, end, plan.lanes),
                      1)
    return seen, rows


@pytest.mark.parametrize("T,C,stride,sms", [
    (648_000, 128, 648_000, 132),   # the Q2 fold: one segment
    (7_813, 128, 7_813, 132),       # a 1,000,000-record fold
    (86_400, 1_024, 60, 132),       # the fleet shape: many items already
    (5, 32, 5, 132), (1, 32, 1, 132), (100_003, 32, 100_003, 7)])
def test_launch_plan_covers_each_segment(T, C, stride, sms):
    """What the CUDA kernel needs of the host's plan: every item and every
    row of a segment visited exactly once, every split non-empty, within
    the grid's limits, and the card filled when a segment is tall."""
    plan = launch_plan(T, C, stride, 4, True, sms)
    assert plan.lanes in (1, 8) and plan.rows >= 1
    assert 1 <= plan.n_split <= 65535 and plan.grid[1] == plan.n_split
    assert 1 <= plan.grid[0] <= 2**31 - 1
    assert (plan.n_split - 1) * plan.rows < stride <= plan.n_split * plan.rows
    seen, rows = _coverage(plan, T, C, stride, 4)
    assert (seen == 1).all() and (rows == 1).all()
    if plan.lanes == 1:
        assert not plan.partials
    if stride >= 8 * 8 * 4 * sms:
        assert plan.grid[0] * plan.grid[1] >= 4 * sms  # the grid fills the card


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,C,stride", [(648_000, 128, 648_000),
                                        (86_400, 1_024, 60)],
                         ids=["q2_fold", "fleet"])
def test_launch_plan_takes_16_byte_loads(T, C, stride, dtype):
    """The fold and the fleet shapes in both types: 16 bytes a thread (4
    f32 or 8 bf16 columns); the fleet has enough items for a warp each and
    one pass, the fold's one segment is split over the card."""
    elsize = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
    plan = launch_plan(T, C, stride, elsize, True, 132)
    assert plan.vec == 16 // elsize
    if stride == 60:
        assert plan.lanes == 1 and plan.n_split == 1 and not plan.partials
        assert plan.grid == (-(-1_440 * C // (32 * plan.vec) // 8), 1)
    else:
        assert plan.lanes == 8 and plan.partials
        assert plan.grid[0] * plan.grid[1] >= 4 * 132


@pytest.mark.parametrize("T,C,stride,aligned", [
    (600, 5, 60, True), (1024, 130, 64, True), (777, 3, 40, True),
    (2000, 1, 100, True),           # the sweep's C = 5, 130, 3 and 1
    (768, 1, 64, True),             # the calibrator's dry-run
    (100_000, 5, 100, False),       # x[1:] of [T, 5] f32: 20 bytes off
    (100_000, 128, 100_000, False)])  # 16-byte rows, the pointer 4 off
def test_launch_plan_takes_one_element_loads(T, C, stride, aligned):
    """Rows that do not all start 16-byte aligned go through the same
    kernel one element per load, covered as before; one pass when there
    is no split."""
    for elsize in (4, 2):
        plan = launch_plan(T, C, stride, elsize, aligned, 132)
        assert plan.vec == 1
        seen, rows = _coverage(plan, T, C, stride, elsize)
        assert (seen == 1).all() and (rows == 1).all()
        assert plan.partials == (plan.n_split > 1)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


def test_ptxas_usage_reads_the_report(monkeypatch, tmp_path):
    """Registers, shared memory and spills of each kernel, by its demangled
    name, from the report that ``nvcc -Xptxas -v`` leaves beside a built
    library."""
    lib = tmp_path / "libwindow_agg-0.so"
    lib.with_suffix(".ptxas.txt").write_text(
        "ptxas info    : Compiling entry function '_Z4passPKf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4passPKf\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 88 registers, used 1 barriers, 8192 bytes smem\n"
        "ptxas info    : Compiling entry function '_Z6finishPf' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 28 registers, used 0 barriers\n")
    monkeypatch.setattr(build, "library_path", lambda name: lib)
    assert build.ptxas_usage("window_agg") == {
        "pass": {"registers": 88, "smem_bytes": 8192,
                 "spill_stores": 8, "spill_loads": 12},
        "finish": {"registers": 28, "smem_bytes": 0,
                   "spill_stores": 0, "spill_loads": 0}}
