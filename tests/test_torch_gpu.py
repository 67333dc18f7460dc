"""The port's CUDA kernels on a card: each against its plain torch version,
the calibrator on the card against the calibrator on the CPU, the
language models' serving and training paths on the card against the same
port on the CPU (the ops' backward formulas, a reduced train step), and
the flash and SSD ops on DTensors of a one-rank NCCL mesh.

These tests need a CUDA card and skip elsewhere; the fixture decides, so
every process collects the same tests. The file imports no JAX, so it
runs where only PyTorch is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import copy
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention_reference,
                                                 flash_attention)
from repro_torch.kernels.flash_attention.backward import (
    flash_attention_backward)
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_3xtf32, flash_attention_backward_wgmma,
    flash_attention_bshd, flash_attention_d16, flash_attention_wgmma)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_reference
from repro_torch.kernels.ssd_scan.kernel import (ssd_scan_blh, ssd_scan_fma,
                                                 ssd_scan_wgmma)
from repro_torch.kernels.sweeps import (FLASH_BWD_RTOL, FLASH_BWD_SWEEP,
                                        FLASH_SWEEP, FLASH_TOL,
                                        FULL_FLASH_BF16_ROW_RTOL,
                                        FULL_SSD_RTOL, SEGMENT_SUM_RTOL,
                                        SSD_BWD_RTOL, SSD_RTOL, SSD_SWEEP,
                                        STEP_GRAD_ATOL,
                                        STEP_GRAD_RTOL,
                                        STEP_SSM_GRAD_ATOL, WINDOW_SWEEP,
                                        WINDOW_TOL, full_widths)
from repro_torch.kernels.window_agg import (window_aggregate,
                                            window_aggregate_reference)
from repro_torch.kernels.window_agg.kernel import (segment_reduce,
                                                   segment_reduce_plain)
from repro_torch.configs import get_arch
from repro_torch.data import make_batch
from repro_torch.models import model as M
from repro_torch.pipeline import HybridExecutor
from repro_torch.scenario import KernelCalibrator
from repro_torch.scenario.calibrate import window_ratio

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("T,C,w,s,agg,dtype", WINDOW_SWEEP)
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
            assert bool((err <= SEGMENT_SUM_RTOL[dtype] * scale).all())
        else:
            assert torch.equal(k, p)
        assert torch.equal(k, segment_reduce(x, agg=a, stride=s))
    tol = WINDOW_TOL[dtype]
    out = window_aggregate(x, agg=agg, window=w, stride=s)
    ref = window_aggregate_reference(x, agg=agg, window=w, stride=s)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def _calibrator_ratios():
    """The window/stride ratios m, by the calibrator's formula, of the
    window_agg services of the recorded BENCH_placement.json scenarios
    (which compile with a calibrator on the scenario path) and of Neubot
    Q1 (MAX over 180 s every 60 s, m = 3)."""
    import json
    from pathlib import Path

    from repro_torch.scenario import ScenarioSpec
    bench = Path(__file__).resolve().parents[1] / "BENCH_placement.json"
    services = [s for sc in json.loads(bench.read_text())["scenarios"].values()
                for s in ScenarioSpec.from_dict(sc["spec"]).services
                if s.operator == "window_agg"]
    return sorted({3} | {window_ratio(s) for s in services})


@pytest.mark.gpu
@pytest.mark.parametrize("m", _calibrator_ratios())
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("agg", ["max", "min", "sum", "mean"])
def test_window_at_the_calibrators_shape(cuda, agg, dtype, m):
    """The calibrator's dry-run (KernelCalibrator.window_shape at stride
    64): [4·m·64, 1] in each type it runs, window m·64, at every ratio m
    its services give, on its ones and on seeded values; bf16 sums of
    seeded values within SEGMENT_SUM_RTOL · Σ|x|, since bf16 rounds each
    segment's sum before the combine."""
    g = torch.Generator(device=cuda).manual_seed(1)
    dt = getattr(torch, dtype)
    T, w, s = KernelCalibrator(device=cuda).window_shape(m)
    for seeded, x in ((False, torch.ones(T, 1, device=cuda)),
                      (True, torch.randn(T, 1, device=cuda, generator=g)
                       * 10)):
        x = x.to(dt)
        out = window_aggregate(x, agg=agg, window=w, stride=s)
        ref = window_aggregate_reference(x, agg=agg, window=w, stride=s)
        assert out.shape == ref.shape == ((T - w) // s + 1, 1)
        assert out.dtype == dt
        if agg in ("max", "min"):
            assert torch.equal(out, ref)
        elif dtype == "float32" or not seeded:
            tol = WINDOW_TOL[dtype]
            torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                       rtol=tol)
        else:
            scale = window_aggregate_reference(x.abs(), agg=agg, window=w,
                                               stride=s).float()
            err = (out.float() - ref.float()).abs()
            assert bool((err <= SEGMENT_SUM_RTOL[dtype] * scale).all())


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _x(cuda, T, C, dtype, seed, offset=0):
    """A seeded [T, C] of ``dtype`` on the card, starting ``offset``
    elements into its storage (a view whose pointer is off 16 bytes when
    offset · elsize is not a multiple of 16)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    flat = torch.randn(T * C + offset, device=cuda, generator=g) * 10
    return flat.to(getattr(torch, dtype))[offset:].view(T, C)


@pytest.mark.gpu
@pytest.mark.parametrize("T,C,stride,dtype,offset,width", [
    (86_400, 1_024, 60, "float32", 0, "vector"),      # the fleet shape
    (86_400, 1_024, 60, "bfloat16", 0, "vector"),
    (648_000, 128, 648_000, "float32", 0, "vector"),  # the Q2 fold
    (64_000, 128, 64_000, "bfloat16", 0, "vector"),   # split, bf16
    (100_000, 5, 100, "float32", 5, "scalar"),   # x[1:] of [T, 5]: 20 B off
    (100_000, 5, 100_000, "float32", 5, "scalar"),    # ... split
    (100_001, 128, 100_001, "float32", 1, "scalar")])  # 16-B rows, 4 B off
def test_both_load_widths_match_plain(cuda, T, C, stride, dtype, offset,
                                      width):
    """Each shape runs the load width its rows allow, counted apart: max
    and min bit-equal to the plain version, sums within SEGMENT_SUM_RTOL ·
    Σ|x|, reruns bit-identical."""
    x = _x(cuda, T, C, dtype, 7, offset)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (offset > 0)
    for a in ("max", "min", "sum"):
        before = (segment_reduce.vector_launches,
                  segment_reduce.scalar_launches)
        k = segment_reduce(x, agg=a, stride=stride)
        went = (segment_reduce.vector_launches - before[0],
                segment_reduce.scalar_launches - before[1])
        assert went == ((1, 0) if width == "vector" else (0, 1))
        p = segment_reduce_plain(x, agg=a, stride=stride)
        if a == "sum":
            scale = segment_reduce_plain(x.abs(), agg="sum",
                                         stride=stride).float()
            err = (k.float() - p.float()).abs()
            assert bool((err <= SEGMENT_SUM_RTOL[dtype] * scale).all())
        else:
            assert torch.equal(_bits(k), _bits(p))
        assert torch.equal(_bits(k), _bits(segment_reduce(x, agg=a,
                                                          stride=stride)))


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
@pytest.mark.parametrize("T,C,stride", [(1000, 4, 100), (1000, 5, 100),
                                        (64_000, 128, 16_000)])
def test_kernel_propagates_nan(cuda, T, C, stride):
    """One NaN poisons its segment's column only, in both load widths and
    through the split's partials."""
    x = torch.randn(T, C, device=cuda)
    x[5, 1] = float("nan")
    for a in ("max", "min", "sum"):
        k = segment_reduce(x, agg=a, stride=stride)
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


# ---- flash attention and the SSD scan --------------------------------------
# the sweeps of tests/test_kernels_flash.py and tests/test_kernels_ssd.py,
# each with the JAX package's tolerance, plus a causal case with Sq > Skv
FLASH_CASES = [(*c, FLASH_TOL[c[-1]]) for c in FLASH_SWEEP]
SSD_CASES = [(*c, SSD_RTOL[c[-1]]) for c in SSD_SWEEP]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,causal,dtype,tol", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, B, Sq, Skv, H, KV, d, causal, dtype,
                                    tol):
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(42)
    dt = getattr(torch, dtype)
    q = torch.randn(B, Sq, H, d, device=cuda, generator=g).to(dt)
    k = torch.randn(B, Skv, KV, d, device=cuda, generator=g).to(dt)
    v = torch.randn(B, Skv, KV, d, device=cuda, generator=g).to(dt)
    before = flash_attention_bshd.launches
    out = flash_attention(q, k, v, causal=causal)
    assert flash_attention_bshd.launches == before + 1
    torch.cuda.synchronize()
    ref = attention_reference(q, k, v, causal=causal)
    assert out.shape == ref.shape and out.dtype == dt
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    assert torch.equal(_bits(out), _bits(flash_attention(q, k, v,
                                                         causal=causal)))
    if causal and Sq > Skv:
        assert not out[:, :Sq - Skv].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kernel", [("bfloat16", "wgmma"),
                                          ("float32", "3xtf32")])
def test_flash_dtype_picks_its_kernel(cuda, dtype, kernel):
    """bf16 launches the bf16 wgmma + TMA kernel, float32 the 3xTF32 one,
    each counted once, and flash_attention_bshd counts both."""
    q = torch.randn(1, 128, 2, 64, device=cuda).to(getattr(torch, dtype))
    counters = {"wgmma": flash_attention_wgmma,
                "3xtf32": flash_attention_3xtf32}
    before = {n: c.launches for n, c in counters.items()}
    total = flash_attention_bshd.launches
    flash_attention(q, q, q)
    went = {n: c.launches - before[n] for n, c in counters.items()}
    assert went == {n: int(n == kernel) for n in counters}
    assert flash_attention_bshd.launches == total + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_at_the_calibrators_shape(cuda, dtype):
    """The calibrator's dry-run (scenario/calibrate.py): q = k = v = ones
    [1, 256, 2, 64], causal, in each type it runs."""
    ones = torch.ones(1, 256, 2, 64, device=cuda, dtype=getattr(torch, dtype))
    out = flash_attention(ones, ones, ones)
    ref = attention_reference(ones, ones, ones)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=FLASH_TOL[dtype], rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,P,G,N,chunk,dtype,rtol", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, B, L, H, P, G, N, chunk, dtype, rtol):
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    x = torch.randn(B, L, H, P, device=cuda, generator=g).to(dt)
    dtt = torch.nn.functional.softplus(torch.randn(B, L, H, device=cuda,
                                                   generator=g))
    A = -torch.exp(torch.randn(H, device=cuda, generator=g) * 0.5)
    Bm = (torch.randn(B, L, G, N, device=cuda, generator=g) * 0.3).to(dt)
    Cm = (torch.randn(B, L, G, N, device=cuda, generator=g) * 0.3).to(dt)
    before = ssd_scan_blh.launches
    y = ssd_scan(x, dtt, A, Bm, Cm, chunk=chunk)
    assert ssd_scan_blh.launches == before + 1
    torch.cuda.synchronize()
    ref = ssd_scan_reference(x, dtt, A, Bm, Cm)
    assert y.shape == ref.shape and y.dtype == dt
    scale = float(ref.float().abs().max())
    assert float((y.float() - ref.float()).abs().max()) <= rtol * scale
    assert torch.equal(_bits(y), _bits(ssd_scan(x, dtt, A, Bm, Cm,
                                                chunk=chunk)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kernel", [("bfloat16", "wgmma"),
                                          ("float32", "fma")])
def test_ssd_dtype_picks_its_kernel(cuda, dtype, kernel):
    """bf16 launches the wgmma passes, float32 the CUDA-core ones, each
    counted once, and ssd_scan_blh counts both."""
    dt = getattr(torch, dtype)
    x = torch.randn(1, 64, 2, 16, device=cuda).to(dt)
    dtt, A = torch.rand(1, 64, 2, device=cuda), -torch.ones(2, device=cuda)
    Bm = torch.randn(1, 64, 1, 16, device=cuda).to(dt)
    counters = {"wgmma": ssd_scan_wgmma, "fma": ssd_scan_fma}
    before = {n: c.launches for n, c in counters.items()}
    total = ssd_scan_blh.launches
    ssd_scan(x, dtt, A, Bm, Bm)
    went = {n: c.launches - before[n] for n, c in counters.items()}
    assert went == {n: int(n == kernel) for n in counters}
    assert ssd_scan_blh.launches == total + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_at_the_calibrators_shape(cuda, dtype):
    """The calibrator's dry-run (scenario/calibrate.py): B 1, L 128, H 2,
    P 64, G 1, N 16 of ones, dt 0.1, A -1, in each type it runs."""
    dt = getattr(torch, dtype)
    x = torch.ones(1, 128, 2, 64, device=cuda, dtype=dt)
    Bm = torch.ones(1, 128, 1, 16, device=cuda, dtype=dt)
    dtt = torch.ones(1, 128, 2, device=cuda) * 0.1
    A = -torch.ones(2, device=cuda)
    y = ssd_scan(x, dtt, A, Bm, Bm, chunk=64)
    ref = ssd_scan_reference(x, dtt, A, Bm, Bm)
    assert y.shape == ref.shape and y.dtype == dt
    scale = float(ref.float().abs().max())
    assert float((y.float() - ref.float()).abs().max()) <= (SSD_RTOL[dtype]
                                                            * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_kernel_takes_unaligned_widths(cuda, dtype):
    """P = 7, N = 9 and a ragged L: rows too narrow for 16-byte copies go
    through the kernel's plain loads, with the sweep's limit."""
    g = torch.Generator(device=cuda).manual_seed(3)
    dt = getattr(torch, dtype)
    x = torch.randn(1, 100, 3, 7, device=cuda, generator=g).to(dt)
    dtt = torch.nn.functional.softplus(torch.randn(1, 100, 3, device=cuda,
                                                   generator=g))
    A = -torch.exp(torch.randn(3, device=cuda, generator=g) * 0.5)
    Bm = (torch.randn(1, 100, 1, 9, device=cuda, generator=g) * 0.3).to(dt)
    Cm = (torch.randn(1, 100, 1, 9, device=cuda, generator=g) * 0.3).to(dt)
    y = ssd_scan(x, dtt, A, Bm, Cm)
    ref = ssd_scan_reference(x, dtt, A, Bm, Cm)
    assert y.shape == ref.shape and y.dtype == dt
    scale = float(ref.float().abs().max())
    assert float((y.float() - ref.float()).abs().max()) <= SSD_RTOL[dtype] * scale


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_full_width_kernels_match_plain(cuda, dtype):
    """qwen3-1.7b attention and mamba2-1.3b's SSD at 4,096 positions:
    flash per query row in bf16 (|err| <= rtol · max|plain| of the row),
    else within the sweep's limit; the SSD within FULL_SSD_RTOL ·
    max|plain|."""
    torch.backends.cuda.matmul.allow_tf32 = False
    (B, Sq, Skv, H, KV, d, causal), (_, L, Hs, P, G, N, chunk) = full_widths()
    g = torch.Generator(device=cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn(B, Sq, H, d, device=cuda, generator=g).to(dt)
    k = torch.randn(B, Skv, KV, d, device=cuda, generator=g).to(dt)
    v = torch.randn(B, Skv, KV, d, device=cuda, generator=g).to(dt)
    out = flash_attention(q, k, v, causal=causal).float()
    ref = attention_reference(q, k, v, causal=causal).float()
    diff = (out - ref).abs()
    if dtype == "bfloat16":
        row_tol = FULL_FLASH_BF16_ROW_RTOL * ref.abs().amax(-1)
        assert bool((diff.amax(-1) <= row_tol).all())
    else:
        assert float(diff.max()) <= FLASH_TOL[dtype]
    del q, k, v, out, ref, diff
    x = torch.randn(B, L, Hs, P, device=cuda, generator=g).to(dt)
    dtt = torch.nn.functional.softplus(torch.randn(B, L, Hs, device=cuda,
                                                   generator=g))
    A = -torch.exp(torch.randn(Hs, device=cuda, generator=g) * 0.5)
    Bm = (torch.randn(B, L, G, N, device=cuda, generator=g) * 0.3).to(dt)
    Cm = (torch.randn(B, L, G, N, device=cuda, generator=g) * 0.3).to(dt)
    y = ssd_scan(x, dtt, A, Bm, Cm, chunk=chunk).float()
    ref = ssd_scan_reference(x, dtt, A, Bm, Cm).float()
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= FULL_SSD_RTOL[dtype] * scale


@pytest.mark.gpu
def test_new_kernels_reject_what_they_do_not_take(cuda):
    q = torch.randn(1, 64, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_bshd(q[:, ::2], q[:, ::2], q[:, ::2])
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attention_bshd(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="CUDA tensors on one device"):
        flash_attention_bshd(q, q.cpu(), q)
    x = torch.randn(1, 32, 2, 8, device=cuda)
    dt, A = torch.rand(1, 32, 2, device=cuda), -torch.ones(2, device=cuda)
    Bm = torch.randn(1, 32, 1, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_blh(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                     Bm, Bm)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        ssd_scan_blh(x.bfloat16(), dt, A, Bm, Bm)


@pytest.mark.gpu
def test_calibration_on_the_card_equals_the_cpu(cuda):
    """The calibrator on the card launches every kernel of its operators,
    once in float32 and once in bfloat16, and counts the same FLOPs as on
    the CPU."""
    gpu, cpu = KernelCalibrator(), KernelCalibrator(device="cpu")
    assert gpu.device == cuda
    counters = (segment_reduce, flash_attention_bshd, flash_attention_wgmma,
                flash_attention_3xtf32, ssd_scan_blh, ssd_scan_wgmma,
                ssd_scan_fma)
    before = [c.launches for c in counters]
    for op, agg, m in (("window_agg", "max", 3), ("ssd_scan", "max", 2),
                       ("flash_attention", "max", 2)):
        a, b = gpu.measure(op, agg=agg, m=m), cpu.measure(op, agg=agg, m=m)
        assert a == b and a.source == "flop-counter"
    assert ([c.launches - n for c, n in zip(counters, before)]
            == [2, 2, 1, 1, 2, 1, 1])


@pytest.mark.gpu
def test_calibrated_scenario_compile_on_the_card(cuda):
    """heavy_analytics of BENCH_placement.json compiled with
    KernelCalibrator() on the card: the compile launches window_agg (clean,
    trend) and both flash kernels (classify), its profiles equal those of
    KernelCalibrator(device="cpu"), and the recorded searched plan runs to
    the same VoS, ledger and energy on both engines."""
    import json
    from pathlib import Path

    from repro_torch.placement import PlacementPlan
    from repro_torch.scenario import ScenarioSpec

    bench = Path(__file__).resolve().parents[1] / "BENCH_placement.json"
    sc = json.loads(bench.read_text())["scenarios"]["heavy_analytics"]
    spec = ScenarioSpec.from_dict(sc["spec"])
    counters = (segment_reduce, flash_attention_wgmma, flash_attention_3xtf32)
    before = [c.launches for c in counters]
    gpu = spec.compile(calibrator=KernelCalibrator())
    assert all(c.launches > n for c, n in zip(counters, before))
    cpu = spec.compile(calibrator=KernelCalibrator(device="cpu"))
    assert gpu.profiles == cpu.profiles
    assert gpu.profiles["classify"].flops_per_record == 65_792.0
    plan = PlacementPlan.from_dict(sc["search"]["assignments"])
    a, b = gpu.run_plan(plan), cpu.run_plan(plan)
    assert a.feasible and a.ledger.conserved()
    assert (a.vos, a.ledger.totals(), a.energy_total_j) == (
        b.vos, b.ledger.totals(), b.energy_total_j)


# ------------------------------------------------------- the fluid stepper
# The fluid engine on the card against the same call on the CPU: cuBLAS
# and the card's exp round differently from the host's in the last bits,
# so element for element |card - cpu| <= FLUID_RTOL * max(1, |cpu|).
FLUID_RTOL = 1e-5
FLUID_FIELDS = ("vos", "vos_service", "vos_t", "lat_mean", "drop_frac")


def _fluid_cases():
    """heavy_analytics of BENCH_placement.json (flat) and a small
    generated fleet (hierarchical), each with an ensemble and plans."""
    import json
    from pathlib import Path

    from repro_torch.placement.plan import enumerate_plans
    from repro_torch.region import FleetGenSpec, generate_fleet
    from repro_torch.scenario import ScenarioSpec

    bench = Path(__file__).resolve().parents[1] / "BENCH_placement.json"
    sc = json.loads(bench.read_text())["scenarios"]["heavy_analytics"]
    flat = ScenarioSpec.from_dict(sc["spec"])
    hier = generate_fleet(FleetGenSpec(n_sites=12, n_regions=3, seed=5,
                                       horizon_s=600.0))
    for spec in (flat, hier):
        eng = spec.compile()
        sites = tuple(eng.info().fleet.site_names)
        plans = list(enumerate_plans(list(eng.order), (4, 8), (1.0,),
                                     edge_sites=sites[:2]))[:16]
        yield spec, eng, plans


def _assert_fluid_close(got, ref):
    assert (got.feasible == ref.feasible).all()
    for k in FLUID_FIELDS:
        a, b = getattr(got, k), getattr(ref, k)
        fin = np.isfinite(b)
        assert (np.isfinite(a) == fin).all(), k
        err = np.abs(a[fin] - b[fin])
        assert (err <= FLUID_RTOL * np.maximum(1.0, np.abs(b[fin]))).all(), \
            (k, float(err.max()))


@pytest.mark.gpu
def test_fluid_on_the_card_matches_the_cpu(cuda):
    """ScenarioEnsemble on the card (its default device) against the same
    ensemble with device="cpu", on the flat and the hierarchical branch;
    the products run in full fp32."""
    from repro_torch.fluid import ScenarioEnsemble
    for spec, eng, plans in _fluid_cases():
        gpu = ScenarioEnsemble.from_spec(spec, n=8, seed=1, engine=eng)
        cpu = ScenarioEnsemble.from_spec(spec, n=8, seed=1, engine=eng,
                                         device="cpu")
        assert gpu.fluid.device == cuda and gpu.fluid is not cpu.fluid
        _assert_fluid_close(gpu.evaluate(plans, jit=False),
                            cpu.evaluate(plans))


@pytest.mark.gpu
def test_fluid_graph_replay_equals_eager(cuda):
    """jit=True runs a shape's first call op by op and replays a CUDA graph,
    captured on the shape's second call, from then on; its outputs equal
    the op-by-op run bit for bit, on both branches."""
    from repro_torch.fluid import ScenarioEnsemble
    for spec, eng, plans in _fluid_cases():
        ens = ScenarioEnsemble.from_spec(spec, n=4, seed=2, engine=eng)
        fl = ens.fluid
        captures = fl.graph_captures
        eager = ens.evaluate(plans, jit=False)
        first = ens.evaluate(plans, jit=True)
        again = ens.evaluate(plans, jit=True)
        assert fl.graph_captures == captures + 1
        for k in FLUID_FIELDS:
            a, b, c = (getattr(r, k) for r in (eager, first, again))
            assert np.array_equal(a, b) and np.array_equal(b, c), k
        once = ens.evaluate(plans[:3], jit=True)
        assert fl.graph_captures == captures + 1
        twice = ens.evaluate(plans[:3], jit=True)
        assert fl.graph_captures == captures + 2
        assert np.array_equal(once.vos, eager.vos[:, :3])
        assert np.array_equal(twice.vos, eager.vos[:, :3])


@pytest.mark.gpu
def test_forked_parallel_evaluator_after_cuda(cuda):
    """A search through ParallelEvaluator forks its workers after this
    process has made a CUDA context; the workers run host code only, so
    the pool works and gives the serial plan and VoS bit for bit."""
    from repro_torch.placement import Evaluator, ParallelEvaluator
    from repro_torch.region import (FleetGenSpec, generate_fleet,
                                    region_search)
    torch.cuda.init()
    torch.ones(1, device=cuda).sum().item()
    spec = generate_fleet(FleetGenSpec(n_sites=12, n_regions=3, seed=5,
                                       horizon_s=600.0))
    eng = spec.compile()
    ser = Evaluator(eng)
    a = region_search(eng, chips_options=(4,), seed=0, sweeps=1,
                      evaluator=ser)
    with ParallelEvaluator(eng, workers=2, spec=spec) as pev:
        b = region_search(eng, chips_options=(4,), seed=0, sweeps=1,
                          evaluator=pev)
    assert pev.parallel_batches >= 1 and not pev._pool_broken
    assert (b.plan.key(), b.result.vos) == (a.plan.key(), a.result.vos)
    assert (pev.hits, pev.misses, pev.history) == (ser.hits, ser.misses,
                                                   ser.history)


# ------------------------------------------------ the LM serving path
def _lm_case(arch):
    """A reduced() config on the wgmma flash kernels: qwen3-1.7b with head
    dim 64 (reduced()'s 16 runs the d-16 kernel, held by the tests of
    head dim 16 and the reduced train step below), mamba2-1.3b as it is
    (P = N = 16)."""
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, d_head=64) if cfg.ssm is None else cfg


def _lm_counters(arch, dtype):
    if arch.startswith("mamba"):
        return ssd_scan_wgmma if dtype == "bfloat16" else ssd_scan_fma
    return (flash_attention_wgmma if dtype == "bfloat16"
            else flash_attention_3xtf32)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_prefill_and_decode_on_the_card_match_the_cpu(cuda, arch, dtype):
    """The same weights on the card (the kernels) and on the CPU (their
    plain versions): prefill logits, the caches' shapes and one decode
    step, fp32 within atol 2e-3 / rtol 1e-3, bf16 within 5e-2 ·
    max|logits| of each row. The prefill launches the path's kernel once
    per layer; decode launches none."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_case(arch)
    dt = getattr(torch, dtype)
    model = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    cpu_model = copy.deepcopy(model).cpu()
    bd = make_batch(cfg, 65, 2, 0)
    bd.pop("labels")
    tb = {k: torch.as_tensor(v) for k, v in bd.items()}
    pre = {k: (v[:, :64] if k == "tokens" else v) for k, v in tb.items()}
    counter = _lm_counters(arch, dtype)
    before = counter.launches
    logits, cache = M.prefill(cfg, model, {k: v.to(cuda)
                                           for k, v in pre.items()},
                              cache_len=72, compute_dtype=dt)
    assert counter.launches - before == cfg.n_layers
    ref, ref_cache = M.prefill(cfg, cpu_model, pre, cache_len=72,
                               compute_dtype=dt)
    before = counter.launches
    nxt = tb["tokens"][:, 64:]
    logits1, _ = M.decode_step(cfg, model, cache, nxt.to(cuda), 64,
                               compute_dtype=dt)
    assert counter.launches == before
    ref1, _ = M.decode_step(cfg, cpu_model, ref_cache, nxt, 64,
                            compute_dtype=dt)
    V = cfg.vocab_size
    for got, want in ((logits, ref), (logits1, ref1)):
        got, want = got.cpu()[:, :V], want[:, :V]
        assert bool(torch.isfinite(got).all())
        if dtype == "float32":
            torch.testing.assert_close(got, want, atol=2e-3, rtol=1e-3)
        else:
            row = want.abs().amax(-1, keepdim=True)
            assert bool(((got - want).abs() <= 5e-2 * row).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,G,N", [(2, 200, 4, 16, 2, 32),
                                         (1, 256, 4, 64, 1, 128),
                                         (1, 100, 3, 7, 1, 9)])
def test_ssd_final_state_matches_plain(cuda, dtype, B, L, H, P, G, N):
    """``ssd_scan_blh(return_state=True)``: y as without the state, and
    the state after step L (float32 [B, H, P, N]) within the sweep's limit
    of the plain recurrence's."""
    g = torch.Generator(device=cuda).manual_seed(5)
    dt = getattr(torch, dtype)
    x = torch.randn(B, L, H, P, device=cuda, generator=g).to(dt)
    dtt = torch.nn.functional.softplus(torch.randn(B, L, H, device=cuda,
                                                   generator=g))
    A = -torch.exp(torch.randn(H, device=cuda, generator=g) * 0.5)
    Bm = (torch.randn(B, L, G, N, device=cuda, generator=g) * 0.3).to(dt)
    Cm = (torch.randn(B, L, G, N, device=cuda, generator=g) * 0.3).to(dt)
    y, h = ssd_scan_blh(x, dtt, A, Bm, Cm, return_state=True)
    assert torch.equal(y, ssd_scan_blh(x, dtt, A, Bm, Cm))
    y_ref, h_ref = ssd_scan_reference(x, dtt, A, Bm, Cm, return_state=True)
    assert h.shape == (B, H, P, N) and h.dtype == torch.float32
    for got, ref in ((y.float(), y_ref.float()), (h, h_ref)):
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= SSD_RTOL[dtype] * scale


# ------------------------------------------------ head dim 16 and training
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,causal",
                         [(8, 128, 128, 4, 2, True), (2, 200, 200, 4, 1, True),
                          (1, 96, 160, 4, 2, False), (1, 160, 96, 2, 2, True),
                          (1, 64, 64, 3, 3, False),
                          # a query tile over many key tiles, both buffers
                          (2, 1000, 1000, 4, 2, True)])
def test_flash_at_head_dim_16_matches_plain(cuda, B, Sq, Skv, H, KV, causal,
                                            dtype):
    """reduced()'s head dim 16 runs on the card: bf16 on the wgmma kernel
    (``flash_attention_wgmma``, its 32-column tiles zero past d), float32
    on the 3xTF32 ``mma.sync`` kernel (``flash_attention_d16``), each
    counted there and nowhere else, within the sweep's tolerance of the
    plain version, bit-identical on a rerun; a row that sees no key gives
    0."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Skv)
    dt = getattr(torch, dtype)
    q = torch.randn(B, Sq, H, 16, device=cuda, generator=g).to(dt)
    k = torch.randn(B, Skv, KV, 16, device=cuda, generator=g).to(dt)
    v = torch.randn(B, Skv, KV, 16, device=cuda, generator=g).to(dt)
    counters = (flash_attention_d16, flash_attention_wgmma,
                flash_attention_3xtf32)
    before = [c.launches for c in counters]
    out = flash_attention(q, k, v, causal=causal)
    want = [0, 1, 0] if dtype == "bfloat16" else [1, 0, 0]
    assert [c.launches - b for c, b in zip(counters, before)] == want
    ref = attention_reference(q, k, v, causal=causal)
    assert out.dtype == dt
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=FLASH_TOL[dtype], rtol=0)
    assert torch.equal(_bits(out), _bits(flash_attention(q, k, v,
                                                         causal=causal)))
    if causal and Sq > Skv:
        assert not out[:, :Sq - Skv].any()


@pytest.mark.gpu
def test_cuda_core_kernel_at_head_dim_16_takes_float32_only(cuda):
    """The d 16 kernel of ``flash_d16.cuh`` is float32's: bf16 (which
    runs d 16 on the wgmma kernel) raises there and launches nothing."""
    g = torch.Generator(device=cuda).manual_seed(16)
    q, k, v = (torch.randn(s, device=cuda, generator=g).bfloat16()
               for s in ((8, 128, 4, 16), (8, 128, 2, 16), (8, 128, 2, 16)))
    before = flash_attention_d16.launches
    with pytest.raises(ValueError, match="takes torch.float32"):
        flash_attention_d16(q, k, v, True)
    assert flash_attention_d16.launches == before


def _grad_err(got, want):
    return max(float((a.float().cpu() - b.float().cpu()).abs().max())
               / float(b.float().abs().max()) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,causal",
                         [(2, 192, 192, 4, 2, 16, True),
                          (1, 128, 256, 4, 2, 16, False),
                          (1, 256, 256, 4, 2, 128, True),
                          (1, 96, 224, 8, 2, 64, True),
                          # three query blocks of the backward's BLOCK_Q
                          (1, 1100, 1300, 4, 2, 128, True)])
def test_flash_backward_on_the_card_matches_the_cpu(cuda, B, Sq, Skv, H, KV,
                                                    d, causal, dtype):
    """loss.backward() through the flash op on the card (its forward the
    kernel, its backward the bf16 kernel or, in fp32, the formula in
    torch ops) against the same on the CPU (the plain forward, the
    formula): each gradient within 1e-4 (fp32) or 5e-2 (bf16) of its
    max."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(d + Sq)
    dt = getattr(torch, dtype)
    host = [torch.randn(s, generator=g).to(dt)
            for s in ((B, Sq, H, d), (B, Skv, KV, d), (B, Skv, KV, d),
                      (B, Sq, H, d))]
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        ins = [t.to(dev).requires_grad_(True) for t in host[:3]]
        flash_attention(*ins, causal=causal).backward(host[3].to(dev))
        grads[dev.type] = [t.grad for t in ins]
    assert all(gr.dtype == dt for gr in grads["cuda"])
    assert _grad_err(grads["cuda"], grads["cpu"]) <= (
        1e-4 if dtype == "float32" else 5e-2)


def _bwd_inputs(dev, B, Sq, Skv, H, KV, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    return [torch.randn(s, device=dev, generator=g).to(dt)
            for s in ((B, Sq, H, d), (B, Skv, KV, d), (B, Skv, KV, d),
                      (B, Sq, H, d))]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,causal", FLASH_BWD_SWEEP)
def test_flash_backward_kernel_matches_the_formula(cuda, B, Sq, Skv, H, KV,
                                                   d, causal):
    """The bf16 backward kernel (``flash_attention_backward_wgmma``, one
    count a call) against its plain version, the formula, run in fp32 on
    the same values: each gradient finite, of its input's type, within
    2 × the bf16 formula's own error against it + 1e-3·max|g| (no less
    accurate than the formula); a rerun bit-identical; rows that see no
    key (causal, Sq > Skv) get dq = 0 exactly."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _bwd_inputs(cuda, B, Sq, Skv, H, KV, d, "bfloat16",
                              Sq + d)
    before = flash_attention_backward_wgmma.launches
    got = flash_attention_backward_wgmma(q, k, v, do, causal)
    again = flash_attention_backward_wgmma(q, k, v, do, causal)
    assert flash_attention_backward_wgmma.launches - before == 2
    exact = flash_attention_backward(*(t.float() for t in (q, k, v, do)),
                                     causal)
    plain = flash_attention_backward(q, k, v, do, causal)
    for a, b, p, e in zip(got, again, plain, exact):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a.float()).all()
        assert torch.equal(_bits(a), _bits(b))
        mx = float(e.abs().max())
        e_k = float((a.float() - e).abs().max())
        e_f = float((p.float() - e).abs().max())
        assert e_k <= 2 * e_f + 1e-3 * mx, (e_k, e_f, mx)
    if causal and Sq > Skv:
        assert not got[0][:, :Sq - Skv].any()


# (B, Sq, Skv, H, KV, d, causal) with more CTAs in each pass than 4 waves
# of 132 SMs: qwen3-1.7b's widths at batch 4 (2,048 pass-1 and 1,024
# pass-2 CTAs), and non-causal, where every key tile reaches every query
# tile (1,024 and 1,024)
FLASH_BWD_WAVES = [(4, 4096, 4096, 16, 8, 128, True),
                   (16, 1024, 1024, 8, 8, 64, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,causal", FLASH_BWD_WAVES)
def test_flash_backward_kernel_is_bit_identical_across_waves(
        cuda, B, Sq, Skv, H, KV, d, causal):
    """Three runs of the bf16 backward kernel on grids of many waves are
    bit-identical (every sum in an order that the schedule does not
    change), and each gradient is within FLASH_BWD_RTOL·max|g| of the
    formula run in bf16 on the same values."""
    q, k, v, do = _bwd_inputs(cuda, B, Sq, Skv, H, KV, d, "bfloat16", d)
    runs = [flash_attention_backward_wgmma(q, k, v, do, causal)
            for _ in range(3)]
    torch.cuda.synchronize()
    for again in runs[1:]:
        for a, b in zip(runs[0], again):
            assert torch.equal(_bits(a), _bits(b))
    plain = flash_attention_backward(q, k, v, do, causal)
    for a, p in zip(runs[0], plain):
        assert torch.isfinite(a.float()).all()
        err = float((a.float() - p.float()).abs().max())
        assert err <= FLASH_BWD_RTOL * float(p.float().abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_backward_route_on_the_card(cuda, dtype):
    """``repro_torch::flash_attention_backward`` on the card: bf16 through
    the kernel (one launch), fp32 through the formula (none), equal bit
    for bit to the route's function; autograd through the flash op takes
    the same route."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _bwd_inputs(cuda, 1, 200, 200, 4, 2, 64, dtype, 5)
    want_launches = 1 if dtype == "bfloat16" else 0
    route = (flash_attention_backward_wgmma if dtype == "bfloat16"
             else flash_attention_backward)
    before = flash_attention_backward_wgmma.launches
    got = torch.ops.repro_torch.flash_attention_backward(q, k, v, do, True)
    assert flash_attention_backward_wgmma.launches - before == want_launches
    for a, b in zip(got, route(q, k, v, do, True)):
        assert torch.equal(_bits(a), _bits(b))
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = flash_attention_backward_wgmma.launches
    flash_attention(*ins, causal=True).backward(do)
    assert flash_attention_backward_wgmma.launches - before == want_launches
    for t, b in zip(ins, got):
        assert torch.equal(_bits(t.grad), _bits(b))


@pytest.mark.gpu
def test_flash_backward_kernel_rejects_what_it_does_not_take(cuda):
    """float32, a dO of another shape or type, a non-contiguous dO, a head
    dim the forward does not take: ValueError before any launch."""
    q, k, v, do = _bwd_inputs(cuda, 1, 64, 64, 2, 1, 64, "bfloat16", 0)
    before = flash_attention_backward_wgmma.launches
    bad = [(q.float(), k.float(), v.float(), do.float()),
           (q, k, v, do[:, :32]), (q, k, v, do.float()),
           (q, k, v, do.transpose(1, 2).contiguous().transpose(1, 2)),
           tuple(t[..., :48].contiguous() for t in (q, k, v, do))]
    for args in bad:
        with pytest.raises(ValueError):
            flash_attention_backward_wgmma(*args, True)
    assert flash_attention_backward_wgmma.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,G,N,chunk", [(2, 256, 4, 64, 1, 128, 64),
                                               (1, 200, 4, 16, 2, 32, 64)])
def test_ssd_backward_on_the_card_matches_the_cpu(cuda, B, L, H, P, G, N,
                                                  chunk, dtype):
    """loss.backward() through the SSD op on the card (its forward the
    kernel, its backward the bf16 kernel or, in fp32, the VJP of the
    chunked form) against the same on the CPU (the plain forward, the
    VJP): every gradient (x, dt, A, B_, C) within 1e-4 (fp32) or 1e-1
    (bf16) of its max."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(L + N)
    dt = getattr(torch, dtype)
    host = [torch.randn(B, L, H, P, generator=g).to(dt),
            torch.nn.functional.softplus(torch.randn(B, L, H, generator=g)),
            -torch.exp(torch.randn(H, generator=g) * 0.5),
            (torch.randn(B, L, G, N, generator=g) * 0.3).to(dt),
            (torch.randn(B, L, G, N, generator=g) * 0.3).to(dt),
            torch.randn(B, L, H, P, generator=g).to(dt)]
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        ins = [t.to(dev).requires_grad_(True) for t in host[:5]]
        ssd_scan(*ins, chunk=chunk).backward(host[5].to(dev))
        grads[dev.type] = [t.grad for t in ins]
    assert _grad_err(grads["cuda"], grads["cpu"]) <= (
        1e-4 if dtype == "float32" else 1e-1)


# the SSD backward kernel's cases (B, L, H, P, G, N): G 1 and 2, L past
# the last whole chunk of 64, a single chunk, mamba2's P 64 and N 128;
# the last two have more heads a group than an adjoint block walks (16,
# or 8 where 16 does not divide them), so their dB and dC are summed over
# 2 and 3 blocks
SSD_BWD_CASES = [(2, 256, 4, 64, 1, 128), (1, 200, 4, 16, 2, 32),
                 (1, 328, 8, 64, 1, 128), (2, 40, 4, 16, 1, 32),
                 (1, 200, 64, 16, 2, 32), (1, 130, 24, 64, 1, 128)]


def _ssd_bwd_inputs(dev, B, L, H, P, G, N, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)

    def rn(*s):
        return torch.randn(s, device=dev, generator=g)
    return [rn(B, L, H, P).to(dt),
            torch.nn.functional.softplus(rn(B, L, H)),
            -torch.exp(rn(H) * 0.5), (rn(B, L, G, N) * 0.3).to(dt),
            (rn(B, L, G, N) * 0.3).to(dt), rn(B, L, H, P).to(dt)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,H,P,G,N", SSD_BWD_CASES)
def test_ssd_backward_kernel_matches_the_formula(cuda, B, L, H, P, G, N):
    """The bf16 SSD backward kernel (``ssd_scan_backward_wgmma``, one
    count a call) against its plain version, the VJP of the chunked form,
    run in fp32 on the same values: each of dx, ddt, dA, dB_, dC finite,
    of its input's type, within 2 × the bf16 formula's own error against
    it + 1e-3·max|g| (no less accurate than the formula); a rerun
    bit-identical."""
    from repro_torch.kernels.ssd_scan.backward import ssd_scan_backward
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_backward_wgmma
    torch.backends.cuda.matmul.allow_tf32 = False
    *ins, dy = _ssd_bwd_inputs(cuda, B, L, H, P, G, N, "bfloat16", L + G)
    before = ssd_scan_backward_wgmma.launches
    got = ssd_scan_backward_wgmma(*ins, dy)
    again = ssd_scan_backward_wgmma(*ins, dy)
    assert ssd_scan_backward_wgmma.launches - before == 2
    exact = ssd_scan_backward(*(t.float() for t in ins), 64, dy.float())
    plain = ssd_scan_backward(*ins, 64, dy)
    for a, b, p, e, t in zip(got, again, plain, exact, ins):
        assert a.dtype == t.dtype and a.shape == t.shape
        assert torch.isfinite(a.float()).all()
        assert torch.equal(_bits(a), _bits(b))
        mx = float(e.abs().max())
        e_k = float((a.float() - e).abs().max())
        e_f = float((p.float() - e).abs().max())
        assert e_k <= 2 * e_f + 1e-3 * mx, (e_k, e_f, mx)


@pytest.mark.gpu
def test_ssd_backward_kernel_is_bit_identical_over_head_blocks(cuda):
    """Three runs of the bf16 SSD backward kernel at 2 × 16 heads a group
    in 3 groups (each group's dB and dC summed over two adjoint blocks of
    16 heads, then over the blocks) are bit-identical, and each gradient is
    within SSD_BWD_RTOL·max|g| of the formula run in bf16 on the same
    values."""
    from repro_torch.kernels.ssd_scan.backward import ssd_scan_backward
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_backward_wgmma
    *ins, dy = _ssd_bwd_inputs(cuda, 2, 1024, 96, 64, 3, 128, "bfloat16", 9)
    runs = [ssd_scan_backward_wgmma(*ins, dy) for _ in range(3)]
    torch.cuda.synchronize()
    for again in runs[1:]:
        for a, b in zip(runs[0], again):
            assert torch.equal(_bits(a), _bits(b))
    plain = ssd_scan_backward(*ins, 64, dy)
    for a, p in zip(runs[0], plain):
        assert torch.isfinite(a.float()).all()
        err = float((a.float() - p.float()).abs().max())
        assert err <= SSD_BWD_RTOL["bfloat16"] * float(p.float().abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_backward_route_on_the_card(cuda, dtype):
    """``repro_torch::ssd_scan_backward`` on the card: bf16 through the
    kernel (one launch), fp32 through the formula (none), equal bit for
    bit to the route's function; autograd through the SSD op takes the
    same route."""
    from repro_torch.kernels.ssd_scan.backward import ssd_scan_backward
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_backward_wgmma
    torch.backends.cuda.matmul.allow_tf32 = False
    *ins, dy = _ssd_bwd_inputs(cuda, 1, 200, 4, 16, 2, 32, dtype, 3)
    want_launches = 1 if dtype == "bfloat16" else 0
    before = ssd_scan_backward_wgmma.launches
    got = torch.ops.repro_torch.ssd_scan_backward(*ins, 64, dy)
    assert ssd_scan_backward_wgmma.launches - before == want_launches
    route = (ssd_scan_backward_wgmma(*ins, dy) if dtype == "bfloat16"
             else ssd_scan_backward(*ins, 64, dy))
    for a, b in zip(got, route):
        assert torch.equal(_bits(a), _bits(b))
    req = [t.clone().requires_grad_(True) for t in ins]
    before = ssd_scan_backward_wgmma.launches
    ssd_scan(*req, chunk=64).backward(dy)
    assert ssd_scan_backward_wgmma.launches - before == want_launches
    for t, b in zip(req, got):
        assert torch.equal(_bits(t.grad), _bits(b))


@pytest.mark.gpu
def test_ssd_backward_kernel_rejects_what_it_does_not_take(cuda):
    """float32 inputs, a dy of another shape or type, a non-contiguous
    dy: ValueError before any launch."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_backward_wgmma
    *ins, dy = _ssd_bwd_inputs(cuda, 1, 64, 2, 16, 1, 16, "bfloat16", 0)
    before = ssd_scan_backward_wgmma.launches
    f32 = [t.float() for t in ins]
    bad = [(*f32, dy.float()), (*ins, dy[:, :32]), (*ins, dy.float()),
           (*ins, dy.transpose(1, 2).contiguous().transpose(1, 2))]
    for args in bad:
        with pytest.raises(ValueError):
            ssd_scan_backward_wgmma(*args)
    assert ssd_scan_backward_wgmma.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["smollm-135m", "mamba2-1.3b",
                                  "whisper-medium"])
def test_reduced_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One fp32 train step of reduced() (head dim 16: the d-16 flash
    kernel; mamba2's SSD kernel) on the card against the same weights and
    batch on the CPU: loss and grad norm within rtol 1e-4; each
    parameter's clipped gradient, read from AdamW's first moment after the
    step ((1 - b1)·g from zero moments), within STEP_GRAD_RTOL·|g| +
    STEP_GRAD_ATOL·max|g| (with SSM layers STEP_SSM_GRAD_ATOL·max|g|,
    ``kernels/sweeps.py`` says why); the updated parameters within 2·lr + 1e-6, a sanity bound only (a
    first AdamW step moves each by about ±lr, whatever its gradient).
    With remat "full" the path's kernel runs twice per layer (forward and
    recompute)."""
    from repro_torch.train import (TrainHParams, init_train_state,
                                   make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch).reduced()
    model = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    cpu_model = copy.deepcopy(model).cpu()
    bd = {k: torch.as_tensor(v) for k, v in make_batch(cfg, 32, 4, 0).items()}
    step = make_train_step(cfg, TrainHParams(compute_dtype=torch.float32,
                                             grad_accum=2))
    counter = ssd_scan_fma if cfg.ssm is not None else flash_attention_d16
    before = counter.launches
    card, mc = step(init_train_state(model), {k: v.to(cuda)
                                              for k, v in bd.items()})
    n_path = (cfg.n_layers if cfg.enc_dec is None
              else 2 * cfg.n_layers + cfg.enc_dec.n_enc_layers)
    if cfg.ssm is not None:
        n_path = sum(k.startswith("ssm") for k in cfg.layer_kinds())
    # two microbatches, each a forward and a recompute
    assert counter.launches - before == 2 * 2 * n_path
    cpu, mp = step(init_train_state(cpu_model), bd)
    for k in ("loss", "grad_norm", "loss_total"):
        assert float(mc[k]) == pytest.approx(float(mp[k]), rel=1e-4), k
    assert card.opt.mu.keys() == cpu.opt.mu.keys()
    atol = STEP_SSM_GRAD_ATOL if cfg.ssm is not None else STEP_GRAD_ATOL
    for name, a in card.opt.mu.items():
        a, b = a.cpu(), cpu.opt.mu[name]
        assert bool(((a - b).abs() <= STEP_GRAD_RTOL * b.abs()
                     + atol * b.abs().max()).all()), name
    tol = 2 * float(mc["lr"]) + 1e-6
    for (name, a), (_, b) in zip(card.params.named_parameters(),
                                 cpu.params.named_parameters()):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= tol, name


# ------------------------------------------------- the MoE's dispatch
MOE_SLOT_CASES = [(1, 32, 8, 8, "all"), (16, 32, 8, 40, "all"),
                  (300, 4, 2, 2, "local"), (1500, 32, 1, 1, "all"),
                  (8192, 32, 8, 2560, "all"), (8192, 32, 8, 8, "local")]


@pytest.mark.gpu
@pytest.mark.parametrize("T,E,k,C,experts", MOE_SLOT_CASES)
def test_moe_slot_map_kernel_matches_plain(cuda, T, E, k, C, experts):
    """The slot map's kernels against the plain sort-based version, from
    a top_e strided as the router's: the same slots, inverse maps and
    counts, exactly, on crowded routings (most choices dropped at C = k)
    and over a local expert range."""
    from repro_torch.kernels.moe_dispatch import kernel as MK
    g = torch.Generator(device=cuda).manual_seed(T + E)
    e0, nl = (0, E) if experts == "all" else (E // 4, E // 2)
    score = torch.rand(T, E, device=cuda, generator=g) + 2 * torch.linspace(
        1, 0, E, device=cuda)
    top_e = torch.sort(score, dim=-1, descending=True,
                       stable=True)[1][:, :k]
    before = MK.slot_map.launches
    m = MK.slot_map(top_e, C, E, nl, e0)
    assert MK.slot_map.launches - before == 1
    for a, b in zip(m, MK.slot_map_plain(top_e, C, E, nl, e0)):
        assert torch.equal(a, b)


MOE_GATHER_CASES = [(8192, 8, 81920, 1024), (16, 8, 128, 1024),
                    (37, 3, 50, 100), (37, 3, 50, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,k,S,d", MOE_GATHER_CASES)
def test_moe_gathers_match_plain(cuda, n, k, S, d, dtype, offset):
    """gather_sum, gather_rows and gather_dot against their plain
    versions, with indices past the end (dropped choices, empty slots),
    in both load widths (an offset of one element misaligns the rows):
    rows in the source's type within one unit in the last place, and
    1e-6 of the largest where the sum cancels (the sums' order differs),
    gather_dot within 1e-5 of the largest, each bitwise equal on a
    rerun."""
    from repro_torch.kernels.moe_dispatch import kernel as MK
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(n + d)

    def rows(r):
        flat = torch.randn(r * d + offset, device=cuda, generator=g).to(dt)
        return flat[offset:].view(r, d)
    src, toks = rows(S), rows(n)
    slot = torch.randint(0, S + 1, (n, k), device=cuda, generator=g)
    w = torch.rand(n, k, device=cuda, generator=g)
    tok = torch.randint(0, n + 1, (S,), device=cuda, generator=g)
    choice = torch.randint(0, n * k + 1, (S,), device=cuda, generator=g)
    for fn, args in ((MK.gather_sum, (src, slot, w)),
                     (MK.gather_sum, (src, slot)),
                     (MK.gather_rows, (toks, tok)),
                     (MK.gather_rows, (toks, tok, w.view(-1), choice)),
                     (MK.gather_dot, (src, slot, toks))):
        before = fn.launches
        got = fn(*args)
        assert fn.launches - before == 1
        assert torch.equal(got, fn(*args))
        want = getattr(MK, fn.__name__ + "_plain")(*args)
        assert got.dtype == want.dtype and got.shape == want.shape
        diff = (got.double() - want.double()).abs()
        if fn is MK.gather_dot:
            assert float(diff.max()) <= 1e-5 * float(want.abs().max())
        else:
            ulp = 2.0 ** -7 if dt == torch.bfloat16 else 2.0 ** -22
            big = want.double().abs()
            assert bool((diff <= ulp * big + 1e-6 * big.max()).all()), \
                fn.__name__


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_kernels_match_plain_on_the_card(cuda, dtype, monkeypatch):
    """The MoE layer at granite's widths (32 experts, top 8, d 1,024),
    1,024 tokens at capacity 1.25, crowded so that choices drop: y, aux
    and the gradients of x and the four weights with the slot map and the
    gathers as kernels against the same layer with their plain versions,
    on the card (the same routing): fp32 within 1e-5, bf16 within 1e-2
    of each tensor's largest; no host sync on the kernels' path; each
    kernel launched."""
    from repro_torch.kernels.moe_dispatch import kernel as MK
    from repro_torch.models import moe as MOE
    dt = getattr(torch, dtype)
    mc = get_arch("granite-moe-1b-a400m").moe
    moe = MOE.MoE(torch.Generator(device=cuda).manual_seed(0), 1024, mc)
    g = torch.Generator(device=cuda).manual_seed(1)
    lean = (moe.router[:, 0] / moe.router[:, 0].norm()).detach()
    x = torch.randn(1024, 1024, device=cuda, generator=g) + 3.0 * lean
    r = torch.randn(1024, 1024, device=cuda, generator=g)

    def run():
        xg = x.to(dt).requires_grad_(True)
        w = {n: getattr(moe, n).detach().clone().requires_grad_(True)
             for n in MOE._WEIGHTS}
        y, aux = MOE._moe_local(w, mc, xg, 32, 0)
        ((y.float() * r).sum() + aux).backward()
        return [y, aux, xg.grad] + [w[n].grad for n in MOE._WEIGHTS]

    names = ("slot_map", "gather_sum", "gather_rows", "gather_dot")
    before = [getattr(MK, n).launches for n in names]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(getattr(MK, n).launches > b for n, b in zip(names, before))
    for n in names:
        monkeypatch.setattr(MOE, n, getattr(MK, n + "_plain"))
    want = run()
    drops = MK.slot_map_plain(
        MOE._top_k(torch.softmax((x.to(dt) @ moe.router.to(dt)).float(), -1),
                   8)[1], MOE._capacity(1024, mc), 32, 32, 0).slot
    assert bool((drops == 32 * MOE._capacity(1024, mc)).any())
    tol = 1e-5 if dtype == "float32" else 1e-2
    for a, b in zip(got, want):
        a, b = a.detach().float(), b.detach().float()
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())


# ------------------------------------------- the train step's CUDA graph
def _graph_case(cuda, seq=128, batch=2, steps=5):
    """reduced() granite-moe-1b-a400m at head dim 64 (granite's flash
    kernels, the MoE's dispatch kernels), its weights, and ``steps``
    batches of ``batch`` × ``seq`` on the card."""
    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(),
                              d_head=64)
    model = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    batches = [{k: torch.as_tensor(v, device=cuda) for k, v in
                make_batch(cfg, seq, batch, i).items()} for i in range(steps)]
    return cfg, model, batches


def _tallies_since(before):
    from repro_torch import tracing
    now = tracing.tallies()
    return tuple(now.get(f"train.graph.{k}", 0) - before.get(
        f"train.graph.{k}", 0) for k in ("eager", "capture", "replay"))


@pytest.mark.gpu
def test_train_step_graph_equals_eager_bit_for_bit(cuda, monkeypatch):
    """Five bf16 remat-full steps from the same weights, one closure
    replaying its CUDA graph (step 1 op by op, step 2 captured and
    replayed, steps 3-5 replayed), the other op by op: parameters, both
    moments and every metric bitwise equal, each step's metrics read
    after all five (copies that later steps leave as they were)."""
    from repro_torch import tracing
    from repro_torch.train import (TrainHParams, init_train_state,
                                   make_train_step)
    from repro_torch.train import train_step as TS
    cfg, model, batches = _graph_case(cuda)
    hp = TrainHParams(total_steps=10)
    eager_state = init_train_state(copy.deepcopy(model))
    state = init_train_state(model)
    before = tracing.tallies()
    step = make_train_step(cfg, hp)
    got = []
    for b in batches:
        state, m = step(state, b)
        got.append(m)
    assert _tallies_since(before) == (1, 1, 4)
    monkeypatch.setattr(TS, "_graphable", lambda device, hp: False)
    eager = make_train_step(cfg, hp)
    want = []
    for b in batches:
        eager_state, m = eager(eager_state, b)
        want.append(m)
    # each step's metrics, kept across the later steps, against the
    # eager step's of the same index
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for name in w:
            assert torch.equal(g[name], w[name]), (i, name)
    assert state.step == eager_state.step == 5
    assert state.opt.count == eager_state.opt.count == 5
    for (name, p), q in zip(state.params.named_parameters(),
                            eager_state.params.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(state.opt.mu[name], eager_state.opt.mu[name])
        assert torch.equal(state.opt.nu[name], eager_state.opt.nu[name])


@pytest.mark.gpu
def test_train_step_captures_once_per_batch_shape(cuda):
    """A shape's first call runs op by op, its second captures and
    replays, later ones replay; a new shape starts over: its first call
    op by op, its second a capture of its own."""
    from repro_torch import tracing
    from repro_torch.train import (TrainHParams, init_train_state,
                                   make_train_step)
    cfg, model, long = _graph_case(cuda, seq=128, steps=4)
    short = _graph_case(cuda, seq=64, steps=3)[2]
    step = make_train_step(cfg, TrainHParams())
    state, before = init_train_state(model), tracing.tallies()
    for b in long:
        state, m = step(state, b)
    assert _tallies_since(before) == (1, 1, 3)
    for b in short:
        state, m = step(state, b)
    assert _tallies_since(before) == (2, 2, 5)
    assert math.isfinite(float(m["loss"]))


@pytest.mark.gpu
def test_train_step_under_a_profiler_runs_op_by_op(cuda):
    """A call under torch.profiler releases the graph and runs op by op,
    its spans and kernels in the trace; the next call without a profiler
    captures again."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.train import (TrainHParams, init_train_state,
                                   make_train_step)
    cfg, model, batches = _graph_case(cuda, steps=4)
    step = make_train_step(cfg, TrainHParams())
    state, before = init_train_state(model), tracing.tallies()
    for b in batches[:2]:
        state, _ = step(state, b)
    assert _tallies_since(before) == (1, 1, 1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = step(state, batches[2])
        float(m["loss"])
    assert _tallies_since(before) == (2, 1, 1)
    names = {e.key for e in prof.key_averages()}
    assert "repro_torch.train.optimizer" in names
    assert any(n.startswith("repro_torch::flash_attention") for n in names)
    state, _ = step(state, batches[3])
    assert _tallies_since(before) == (2, 2, 2)
    tracing.reset()



# ------------------------------------------ the decode step's CUDA graph
def _serve_tallies_since(before):
    from repro_torch import tracing
    now = tracing.tallies()
    return tuple(now.get(f"serve.graph.{k}", 0) - before.get(
        f"serve.graph.{k}", 0) for k in ("eager", "capture", "replay"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "mamba2-1.3b"])
def test_decode_graph_equals_eager_bit_for_bit(cuda, name):
    """Three requests through one decode step, bf16: two of one prompt
    length (the first's step 1 captured and replayed, the rest replayed;
    the second replayed from its first step, under a CUDA-only
    torch.profiler) and one of another, under a profiler that records
    the host's ops with their shapes (with attention caches, a new key:
    its first step captured; mamba2's caches have no length, so it
    replays). Every step's logits and caches equal ``M.decode_step`` op
    by op on copies of the same prefill caches, bit for bit; the tallies
    count one capture a key, no call op by op, and every call replayed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.train import make_decode_step, make_prefill_step
    cfg = get_arch(name).reduced()
    if name.startswith("granite"):
        cfg = dataclasses.replace(cfg, d_head=64)
    model = M.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    steps, batch, dt = 5, 4, torch.bfloat16
    decode = make_decode_step(cfg, dt)
    profilers = {1: dict(activities=[ProfilerActivity.CUDA]),
                 2: dict(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         record_shapes=True)}
    before = tracing.tallies()
    for r, prompt in enumerate((40, 40, 72)):
        prefill = make_prefill_step(cfg, prompt + steps, dt)
        toks = torch.as_tensor(make_batch(cfg, prompt, batch, r)["tokens"],
                               device=cuda)
        logits, cache = prefill(model, {"tokens": toks})
        ref = [{k: v.clone() for k, v in c.items()} for c in cache]
        tok = logits.argmax(-1)[:, None]
        prof = profile(**profilers[r]) if r in profilers else None
        if prof is not None:
            prof.start()
        try:
            for j in range(steps):
                got, cache = decode(model, cache, tok, prompt + j)
                want, ref = M.decode_step(cfg, model, ref, tok, prompt + j,
                                          compute_dtype=dt)
                assert torch.equal(got, want), (r, j)
                for i, (g, w) in enumerate(zip(cache, ref)):
                    for k in w:
                        assert torch.equal(g[k], w[k]), (r, j, i, k)
                tok = got.argmax(-1)[:, None]
        finally:
            if prof is not None:
                prof.stop()
        if prof is not None:
            assert prof.profiler.kineto_results.events(), r
    keys = 2 if any(k.startswith("attn") for k in cfg.layer_kinds()) else 1
    assert _serve_tallies_since(before) == (0, keys, 3 * steps)


# ---------------------------------------------- a one-rank NCCL mesh
@pytest.fixture
def nccl_mesh(cuda):
    """``make_dev_mesh(1, 1)`` on a one-rank NCCL group, destroyed after
    the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_local_world, make_dev_mesh
    init_local_world("cuda")
    try:
        yield make_dev_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_and_ssd_under_dtensor_match_plain(nccl_mesh, dtype):
    """The flash and SSD ops on DTensors of a 1×1 CUDA mesh (batch over
    "data", heads over "model") launch their kernels and equal the plain
    versions on the same values; the flash gradient through DTensor
    equals the one without."""
    from torch.distributed.tensor import Shard, distribute_tensor
    mesh = nccl_mesh
    dev = torch.device("cuda", 0)
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*s):
        return torch.randn(s, device=dev, generator=g).to(dt)
    q, k, v = rn(2, 256, 4, 128), rn(2, 256, 2, 128), rn(2, 256, 2, 128)
    pl = [Shard(0), Shard(2)]
    qd, kd, vd = (distribute_tensor(t, mesh, pl).requires_grad_(True)
                  for t in (q, k, v))
    before = flash_attention_bshd.launches
    out = flash_attention(qd, kd, vd, causal=True)
    assert flash_attention_bshd.launches - before == 1
    assert out.device_mesh.device_type == "cuda"
    ref = attention_reference(q, k, v, causal=True)
    err = float((out.full_tensor().float() - ref.float()).abs().max())
    assert err <= FLASH_TOL[dtype], err
    do = rn(2, 256, 4, 128)
    out.backward(distribute_tensor(do, mesh, out.placements))
    qp, kp, vp = (t.clone().requires_grad_(True) for t in (q, k, v))
    flash_attention(qp, kp, vp, causal=True).backward(do)
    for a, b in ((qd, qp), (kd, kp), (vd, vp)):
        assert torch.equal(a.grad.full_tensor(), b.grad)

    x, dtv = rn(2, 256, 8, 64), torch.rand(2, 256, 8, device=dev,
                                           generator=g) * 0.1
    A = -torch.rand(8, device=dev, generator=g)
    Bm, C = rn(2, 256, 1, 128), rn(2, 256, 1, 128)
    from torch.distributed.tensor import Replicate
    before = ssd_scan_blh.launches
    y = ssd_scan(distribute_tensor(x, mesh, pl),
                 distribute_tensor(dtv, mesh, pl),
                 distribute_tensor(A, mesh, [Replicate(), Shard(0)]),
                 distribute_tensor(Bm, mesh, [Shard(0), Replicate()]),
                 distribute_tensor(C, mesh, [Shard(0), Replicate()]),
                 chunk=64)
    assert ssd_scan_blh.launches - before == 1
    want = ssd_scan_reference(x, dtv, A, Bm, C)
    err = float((y.full_tensor().float() - want.float()).abs().max())
    assert err <= SSD_RTOL[dtype] * float(want.float().abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_backward_under_dtensor_runs_the_kernel(nccl_mesh, G):
    """The SSD op's bf16 gradient on DTensors of a 1×1 CUDA mesh (batch
    over "data", heads over "model") runs the backward kernel once, on
    the local shards, and equals the gradient without DTensor bit for
    bit."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_backward_wgmma
    mesh = nccl_mesh
    dev = torch.device("cuda", 0)
    *ins, dy = _ssd_bwd_inputs(dev, 2, 200, 8, 64, G, 128, "bfloat16", G)
    pl = [Shard(0), Shard(2)]
    bc = [Shard(0), Shard(2) if G > 1 else Replicate()]
    dts = [distribute_tensor(t, mesh, p).requires_grad_(True)
           for t, p in zip(ins, (pl, pl, [Replicate(), Shard(0)], bc, bc))]
    y = ssd_scan(*dts, chunk=64)
    before = ssd_scan_backward_wgmma.launches
    y.backward(distribute_tensor(dy, mesh, y.placements))
    assert ssd_scan_backward_wgmma.launches - before == 1
    plain = [t.clone().requires_grad_(True) for t in ins]
    ssd_scan(*plain, chunk=64).backward(dy)
    for a, b in zip(dts, plain):
        assert torch.equal(_bits(a.grad.full_tensor()), _bits(b.grad))
