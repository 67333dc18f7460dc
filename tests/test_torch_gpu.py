"""The port's CUDA kernels on a card: each against its plain torch version,
and the calibrator on the card against the calibrator on the CPU.

These tests need a CUDA card and skip elsewhere; the fixture decides, so
every process collects the same tests. The file imports no JAX, so it
runs where only PyTorch is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attention_reference,
                                                 flash_attention)
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_3xtf32, flash_attention_bshd, flash_attention_wgmma)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_reference
from repro_torch.kernels.ssd_scan.kernel import (ssd_scan_blh, ssd_scan_fma,
                                                 ssd_scan_wgmma)
from repro_torch.kernels.sweeps import (FLASH_SWEEP, FLASH_TOL,
                                        FULL_FLASH_BF16_ROW_RTOL,
                                        FULL_SSD_RTOL, SEGMENT_SUM_RTOL,
                                        SSD_RTOL, SSD_SWEEP, WINDOW_SWEEP,
                                        WINDOW_TOL, full_widths)
from repro_torch.kernels.window_agg import (window_aggregate,
                                            window_aggregate_reference)
from repro_torch.kernels.window_agg.kernel import (segment_reduce,
                                                   segment_reduce_plain)
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
