#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main paths once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` (into ``build/kernels``, one ``nvcc`` per
source, all started together), then runs these phases, each printing one
JSON line; any failure exits non-zero:

  card    nvidia-smi's name and power limit (also printed raw), torch's name
  build   the kernels' build, timed as set-up, with ptxas's registers,
          shared memory and spills of every kernel; the window_agg and
          fp32 flash kernels must not spill
  kernel  every kernel against its plain torch version on the card, at the
          test sweeps' shapes, the main paths' shapes (the calibrator's
          dry-runs among them) and full width
          (qwen3-1.7b attention and mamba2-1.3b SSD at 4,096 positions),
          plus NaN cases and a bitwise rerun check; window_agg in both of
          its load widths (16-byte loads where every row is 16-byte
          aligned, one element per load else: C = 1, 3, 5, 130, the
          calibrator's [4·m·64, 1] at every window/stride ratio m that the
          calibrate and scenario phases hand it, views whose pointer is
          off 16 bytes),
          each call counted in its width's counter; flash attention has
          two kernels, wgmma in bf16 and 3xTF32 on wgmma in fp32, the
          SSD wgmma in bf16 and CUDA-core FMA in fp32, and each call must
          launch the one of its type
  main    the paper's §3 use case through the port's entry points: a Neubot
          farm of 8 things at 1 Hz → broker → Q1 and Q2 stream services
          (fetch → bounded buffer → spill to the store) for one simulated
          hour on the edge, then Q2 windows of up to 82,944,000 records
          (120 days at 1 Hz for 8 things) through ``HybridExecutor()``,
          checked against float64 numpy; the kernel's launch counter shows
          that the offloads ran it; then the analytics operators on the card
          against the same operators on the CPU
  fleet   Q1 (MAX over 180 s every 60 s) for a fleet of 1,024 things over
          a day, [86,400, 1,024] in float32 and in bfloat16, through
          ``window_aggregate``, bit-equal to its plain version; the
          counters, set to 0 before each type, show one 16-byte-load
          launch of the kernel each
  calibrate  the JITA-4DS path: ``KernelCalibrator()`` measures the flops
          per record of three services (window_agg, ssd_scan,
          flash_attention) from dry-runs of their kernels on the card, in
          float32 and bfloat16,
          ``calibrate_profiles`` and ``analytics_cost_model`` price them,
          and a seeded trace of their DC fires runs through
          ``Simulator(HintedVPTR(), cost)``; the launch counters show that
          every kernel ran, and the card's calibrations equal the CPU's
  scenario  the scenario layer through its users' entry points: the
          three recorded scenarios of BENCH_placement.json compiled from
          their specs and replayed under their recorded plans with
          ``run_plan`` (VoS within 1e-3, fires and records as recorded, the
          ledger conserved), then heavy_analytics compiled with
          ``ScenarioSpec.compile(calibrator=KernelCalibrator())``: the
          counters, set to 0 just before, show that the compile launched
          window_agg and both flash kernels on the card, and its profiles
          and its engine's run equal those of the CPU's calibrator.
          The calibrate and scenario lines carry ``gc``: the collections
          of each generation inside the phase and the seconds spent in
          them
  search  placement search and control through their entry points: the
          screened ``search_placement`` over the recorded scenarios of
          BENCH_search.json (plan and VoS as recorded); heavy_analytics
          compiled with ``KernelCalibrator()`` (the counters, set to 0
          just before, show window_agg and both flash kernels launched)
          and searched to the plan of the CPU's calibrator, then searched
          again through ``ParallelEvaluator(workers=2)``, whose workers
          fork after this process made its CUDA context: the serial plan
          and VoS bit for bit, the pool used (faulthandler turns a hung
          pool into a traceback); flash_crowd under ``OnlineController``
          and crash_during_burst under ``ChaosController`` from their
          recorded specs, VoS within 1e-3 and fires as recorded; host
          seconds of each
  fluid   the batched fluid engine on the card at bench_robust.py's
          throughput shape (heavy_analytics, 257 realizations × 32
          plans): a shape's first call runs op by op, its second captures
          a CUDA graph that later calls (``jit=True``) replay, bit-equal
          to the op-by-op run, both within FLUID_RTOL of the CPU; the
          first call, the capturing call, the op-by-op and the replayed
          call (host clock, median of 5 batches), the CPU's call, the
          stepper alone by CUDA events, evaluations per second, peak
          memory; ``robust_search`` over that ensemble, with its one
          fluid call timed as the search pays it beside the CPU's call on
          the same candidates (same cvar ranking); then BENCH_robust.json's
          agreement block on the card (fluid VoS within 1e-3 of the
          recorded). The stepper's kernels and launch calls per call
          (torch.profiler) print last, on a ``fluid_launches`` line
          after ``times``, and a ``profiler_probe`` line says whether a
          trace after it still saw device time. ORDER: a trace of the
          stepper (about 12,000 kernels) once left torch.profiler blind
          to device time in every later trace, so no phase that reads
          ``kernel_device_ms`` or ``launches_per_call`` may follow
          ``fluid_launches``
  region  BENCH_fleet.json's generated 500-site fleet from its recorded
          generator fields: the spec's sha256 as recorded (the record
          predates the spec's null ``chaos`` field, so it is taken
          without it) and as the JAX package gives it today, the drive,
          ``region_search`` to the recorded VoS serially and through a
          forked ``ParallelEvaluator``, bit-identical; then the search
          with a fluid ensemble (n=64) of its finalists on the card, on
          the stepper's hierarchical branch, its one fluid call op by op
          and timed as the search pays it: within FLUID_RTOL of the CPU's
          call on the same finalists and ranked alike under "cvar"; a
          second call of that shape captures a graph, bit-equal
  paper4  the paper's §4 experiment (examples/vos_scheduler_demo.py) on the
          port's core: six heuristics, 120 jobs each, a 70% power cap; the
          VoS must equal the JAX package's, recorded below
  times   kernel, plain version and one library call by CUDA events at the
          main path's shape, the fleet shape and full width, beside the
          bound; the kernel and the library call as the median of 5
          batches of 20 launches after 5 warm-ups, with the batches'
          spread; at full width each kernel's device time from
          torch.profiler (the SSD's three passes apart; a trace that saw
          no kernel prints a ``profiler_retry`` line and is taken again);
          the host-to-device
          copy and ``run_window`` end to end; peak memory

The bound is the larger of the bytes (each input read once, each output
written once) over 3.35 TB/s and the operations over the card's peak for
their type: 989 TFLOP/s for bf16 on the tensor cores, and for fp32 the
lesser of the CUDA cores' 67 TFLOP/s and three TF32 products at
495 TFLOP/s (3xTF32, which holds fp32 accuracy on the tensor cores).
``bound_by`` says which: ``bytes``, ``operations_bf16``,
``operations_fma`` or ``operations_3xtf32``; the ``times`` lines keep the
fp32 CUDA-core figure beside it as ``bound_fma_ms``. The ``kernels`` line
gives ``bound_by`` as ``bytes`` or ``operations`` and the finer word as
``bound_detail``.

Then one line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
{...}}``. With no CUDA card it exits non-zero before printing any result.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import itertools
import json
import math
import random
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12     # H100 SXM tf32 tensor cores, dense
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
SEED = 0
N_THINGS, RATE_HZ, HOURS = 8, 1.0, 1.0
Q2_RECORDS = 120 * 86400 * N_THINGS          # 82,944,000
Q2_WINDOWS = (10_000, 1_000_000, 10_368_000, Q2_RECORDS)
FLEET = (86_400, 1_024, 180, 60)              # T, C, window, stride: Q1 for 1,024 things
Q2_MEAN_RTOL = 1e-5
# the JITA-4DS path: EngineConfig's defaults (scenario/engine.py) and the
# calibrated services (Neubot Q1: MAX over 180 s every 60 s, so m = 3)
ENGINE_CFG = SimpleNamespace(records_per_step=5_000, mxu_efficiency=0.5,
                             dc_step_floor_s=1e-3)
N_FIRES = 90
PROFILER_ATTEMPTS = 3       # traces kernel_device_ms takes before it fails
# examples/vos_scheduler_demo.py on the JAX package: VoS per heuristic
PAPER4_VOS = {"Simple": 83.20119626628816, "VPT": 167.51703734084728,
              "VPTR": 140.88804074535503, "VPT-CPC": 117.44285432262758,
              "VPT-JSPC": 94.17585420303756, "Hybrid": 122.83503565612259}


class SmokeFailure(RuntimeError):
    pass


class GcClock:
    """Python's garbage collections by generation, and the host seconds
    spent in them, counted through ``gc.callbacks`` from construction."""

    def __init__(self):
        self.collections, self.seconds, self._t0 = [0, 0, 0], [0.0] * 3, 0.0
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            g = info["generation"]
            self.collections[g] += 1
            self.seconds[g] += time.perf_counter() - self._t0

    def read(self):
        return list(self.collections), list(self.seconds)

    def since(self, then) -> dict:
        n, t = then
        return {"collections": [a - b for a, b in zip(self.collections, n)],
                "seconds": [a - b for a, b in zip(self.seconds, t)]}


GC_CLOCK = GcClock()


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def bits(t):
    """The raw bits of a float32 or bfloat16 tensor, for bitwise compares."""
    import torch
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def bound(nbytes, flops, dtype) -> dict:
    """The least time the card could take to move ``nbytes`` and do
    ``flops`` in ``dtype`` (see the module's docstring), in ms, what bounds
    it, and for fp32 the operations' time on the CUDA cores."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    if dtype == "bfloat16":
        t_o, by, fma = flops / BF16_OPS_PER_S * 1e3, "operations_bf16", None
    else:
        fma = flops / FP32_OPS_PER_S * 1e3
        tf32 = 3 * flops / TF32_OPS_PER_S * 1e3
        t_o, by = ((fma, "operations_fma") if fma <= tf32
                   else (tf32, "operations_3xtf32"))
    return {"bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o
            else by, "bound_fma_ms": fma}


def batches(cuda_ms, fn, key) -> dict:
    """{key: median ms, key_batches: the 5 batch means, key_spread: max -
    min of them}: 5 batches of 20 launches after 5 warm-ups."""
    ms = sorted(cuda_ms(fn, 20, 5 if i == 0 else 0) for i in range(5))
    return {key: ms[2], f"{key}_batches": ms, f"{key}_spread": ms[-1] - ms[0]}


def flash_inputs(dev, gen, B, Sq, Skv, H, KV, d, dtype):
    import torch
    dt = getattr(torch, dtype)
    return tuple(torch.randn(shape, device=dev, generator=gen).to(dt)
                 for shape in ((B, Sq, H, d), (B, Skv, KV, d), (B, Skv, KV, d)))


def ssd_inputs(dev, gen, B, L, H, P, G, N, dtype):
    """x, dt (post-softplus), A (negative), B_, C as the JAX sweep makes
    them: x, B_ and C in ``dtype``, dt and A float32."""
    import torch
    dt = getattr(torch, dtype)
    x = torch.randn(B, L, H, P, device=dev, generator=gen).to(dt)
    dtt = torch.nn.functional.softplus(torch.randn(B, L, H, device=dev,
                                                   generator=gen))
    A = -torch.exp(torch.randn(H, device=dev, generator=gen) * 0.5)
    Bm = (torch.randn(B, L, G, N, device=dev, generator=gen) * 0.3).to(dt)
    Cm = (torch.randn(B, L, G, N, device=dev, generator=gen) * 0.3).to(dt)
    return x, dtt, A, Bm, Cm


def check_attention_and_ssd(dev, gen) -> dict:
    """flash attention and the SSD scan against their plain versions on
    the card: the sweeps, the calibrator's dry-run inputs (ones) and full
    width. Returns the full-width max |err| by (kernel, dtype)."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_reference,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_3xtf32, flash_attention_wgmma)
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_reference
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_fma, ssd_scan_wgmma
    from repro_torch.kernels.sweeps import (FLASH_SWEEP, FLASH_TOL,
                                            FULL_FLASH_BF16_ROW_RTOL,
                                            FULL_SSD_RTOL, SSD_RTOL,
                                            SSD_SWEEP, full_widths)

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's
    flash_full, ssd_full = full_widths()             # products in fp32

    def check(name, out, again, ref, tol, scale=1.0, per_row=False):
        """|kernel - plain| <= tol · scale over the output, or with
        ``per_row`` <= tol · max|plain| of each row of the last axis (a
        row of zeros must then be matched exactly)."""
        torch.cuda.synchronize()
        require(out.shape == ref.shape and out.dtype == ref.dtype,
                f"{name}: shape {tuple(out.shape)} dtype {out.dtype}")
        require(torch.equal(bits(out), bits(again)), f"{name}: rerun differs")
        require(bool(torch.isfinite(out.float()).all()), f"{name}: not finite")
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        if per_row:
            row_err, row_max = diff.amax(-1), ref.float().abs().amax(-1)
            require(bool((row_err <= tol * row_max).all()),
                    f"{name}: a row's max |kernel - plain| > {tol} * its "
                    f"max|plain|")
            rel = torch.where(row_max > 0, row_err / row_max, row_err)
            emit("kernel", case=name, max_abs_err=err,
                 max_row_err_over_row_max=float(rel.max()),
                 tolerance=f"|err| <= {tol} * max|plain| per row")
        else:
            require(err <= tol * scale,
                    f"{name}: max |kernel - plain| {err} > {tol} * {scale}")
            emit("kernel", case=name, max_abs_err=err, tolerance=tol * scale)
        return err

    full = {}
    cases = list(FLASH_SWEEP) + [(*flash_full, dt)
                                 for dt in ("bfloat16", "float32")]
    for B, Sq, Skv, H, KV, d, causal, dt in cases:
        q, k, v = flash_inputs(dev, gen, B, Sq, Skv, H, KV, d, dt)
        name = f"flash[{B},{Sq},{Skv},{H},{KV},{d}] causal={causal} {dt}"
        at_full = (B, Sq, Skv, H, KV, d, causal) == flash_full
        row = at_full and dt == "bfloat16"
        before = (flash_attention_wgmma.launches,
                  flash_attention_3xtf32.launches)
        out = flash_attention(q, k, v, causal=causal)
        went = (flash_attention_wgmma.launches - before[0],
                flash_attention_3xtf32.launches - before[1])
        require(went == ((1, 0) if dt == "bfloat16" else (0, 1)),
                f"{name}: (wgmma, 3xtf32) launches {went}")
        err = check(name, out, flash_attention(q, k, v, causal=causal),
                    attention_reference(q, k, v, causal=causal),
                    FULL_FLASH_BF16_ROW_RTOL if row else FLASH_TOL[dt],
                    per_row=row)
        if at_full:
            full[("flash", dt)] = err
        del q, k, v
    for dt in ("float32", "bfloat16"):                   # the dry-run's
        ones = torch.ones(1, 256, 2, 64, device=dev, dtype=getattr(torch, dt))
        check(f"flash calibrator dry-run [1,256,2,64] ones {dt}",
              flash_attention(ones, ones, ones),
              flash_attention(ones, ones, ones),
              attention_reference(ones, ones, ones), FLASH_TOL[dt])

    cases = list(SSD_SWEEP) + [(*ssd_full, dt)
                               for dt in ("bfloat16", "float32")]
    for B, L, H, P, G, N, chunk, dt in cases:
        args = ssd_inputs(dev, gen, B, L, H, P, G, N, dt)
        ref = ssd_scan_reference(*args)
        at_full = (B, L, H, P, G, N, chunk) == ssd_full
        name = f"ssd[{B},{L},{H},{P},{G},{N}] chunk={chunk} {dt}"
        before = (ssd_scan_wgmma.launches, ssd_scan_fma.launches)
        out = ssd_scan(*args, chunk=chunk)
        went = (ssd_scan_wgmma.launches - before[0],
                ssd_scan_fma.launches - before[1])
        require(went == ((1, 0) if dt == "bfloat16" else (0, 1)),
                f"{name}: (wgmma, fma) launches {went}")
        err = check(name, out, ssd_scan(*args, chunk=chunk), ref,
                    (FULL_SSD_RTOL if at_full else SSD_RTOL)[dt],
                    float(ref.float().abs().max()))
        if at_full:
            full[("ssd", dt)] = err
        del args, ref
    for dt in ("float32", "bfloat16"):                   # the dry-run's
        x = torch.ones(1, 128, 2, 64, device=dev, dtype=getattr(torch, dt))
        Bm = torch.ones(1, 128, 1, 16, device=dev, dtype=x.dtype)
        dtt = torch.ones(1, 128, 2, device=dev) * 0.1
        A = -torch.ones(2, device=dev)
        ref = ssd_scan_reference(x, dtt, A, Bm, Bm)
        check(f"ssd calibrator dry-run [1,128,2,64] N=16 ones {dt}",
              ssd_scan(x, dtt, A, Bm, Bm, chunk=64),
              ssd_scan(x, dtt, A, Bm, Bm, chunk=64), ref, SSD_RTOL[dt],
              float(ref.float().abs().max()))
    return full


def calibrated_services():
    """Three services, one per operator family: Neubot Q1 (MAX over 180 s
    every 60 s) on window_agg, and two analytics services on ssd_scan and
    flash_attention."""
    from repro_torch.scenario import ServiceSLO
    slo = ServiceSLO(soft_latency_s=0.05, hard_latency_s=0.5, gamma=2.0)
    return [SimpleNamespace(name="q1_max", operator="window_agg", agg="max",
                            width_s=180.0, slide_s=60.0, slo=slo,
                            bytes_per_record=8.0),
            SimpleNamespace(name="ssm", operator="ssd_scan", agg="mean",
                            width_s=120.0, slide_s=60.0, slo=slo,
                            bytes_per_record=64.0),
            SimpleNamespace(name="attn", operator="flash_attention",
                            agg="mean", width_s=60.0, slide_s=60.0, slo=slo,
                            bytes_per_record=512.0)]


def calibrator_window_ratios() -> list:
    """The window/stride ratios m, by the calibrator's own formula, of
    every window_agg service that the calibrate and scenario phases hand
    to KernelCalibrator: calibrated_services() and the services of the
    recorded BENCH_placement.json scenarios."""
    from repro_torch.scenario import ScenarioSpec
    from repro_torch.scenario.calibrate import window_ratio
    recorded = json.loads((ROOT / "BENCH_placement.json").read_text())
    services = calibrated_services() + [
        s for sc in recorded["scenarios"].values()
        for s in ScenarioSpec.from_dict(sc["spec"]).services]
    return sorted({window_ratio(s) for s in services
                   if s.operator == "window_agg"})


def fire_tasks(profiles, cost, n=N_FIRES, seed=SEED):
    """A seeded trace of DC fires built the way the JAX package's
    ScenarioEngine._make_task builds them: one task per fire,
    ceil(window / records_per_step) steps on the plan's chips, the SLO
    shifted by the delay before the task, the plan's DVFS hint."""
    from repro_torch.core.tasks import Task, TaskType
    rng = random.Random(seed)
    names, ts, out = sorted(profiles), 0.0, []
    for tid in range(n):
        name = names[tid % len(names)]
        ts += rng.expovariate(1 / 0.02)
        arrival = ts + rng.uniform(0.0, 0.05)
        n_window = rng.randint(1_000, 400_000)
        chips = rng.choice((4, 8, 16, 32))
        tt = TaskType(f"svc:{name}", "window", allowable_chips=(chips,))
        task = Task(tid=tid, ttype=tt, arrival=arrival,
                    steps=max(1, math.ceil(n_window
                                           / ENGINE_CFG.records_per_step)),
                    value=profiles[name].slo.value_spec(arrival - ts + 0.01),
                    hbm_bytes=cost.hbm_bytes(f"svc:{name}", "window"))
        task.dvfs_hint = rng.choice((1.0, 0.8, 0.6))
        out.append(task)
    return out


def zeroed_counters() -> dict:
    """The launch counters of the calibrator's kernels by name, each set
    to 0 (``window_agg``'s counts by load width too)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_3xtf32, flash_attention_bshd, flash_attention_wgmma)
    from repro_torch.kernels.ssd_scan.kernel import (ssd_scan_blh, ssd_scan_fma,
                                                     ssd_scan_wgmma)
    from repro_torch.kernels.window_agg.kernel import segment_reduce
    counters = {"window_agg": segment_reduce, "flash_attention":
                flash_attention_bshd, "flash_attention_wgmma":
                flash_attention_wgmma, "flash_attention_3xtf32":
                flash_attention_3xtf32, "ssd_scan": ssd_scan_blh,
                "ssd_scan_wgmma": ssd_scan_wgmma, "ssd_scan_fma": ssd_scan_fma}
    for c in counters.values():
        c.launches = 0
    segment_reduce.scalar_launches = segment_reduce.vector_launches = 0
    return counters


def calibration_path() -> dict:
    """KernelCalibrator() on the card → calibrate_profiles →
    analytics_cost_model → Simulator(HintedVPTR(), cost). Returns the
    launches of each kernel in this run."""
    from repro_torch.core.simulator import Simulator
    from repro_torch.kernels.window_agg.kernel import segment_reduce
    from repro_torch.scenario import (HintedVPTR, KernelCalibrator,
                                      analytics_cost_model, calibrate_profiles)

    counters = zeroed_counters()
    gc0 = GC_CLOCK.read()
    t0 = time.perf_counter()
    services = calibrated_services()
    profiles, cal = calibrate_profiles(SimpleNamespace(services=services),
                                       KernelCalibrator())
    cost = analytics_cost_model(profiles, ENGINE_CFG)
    res = Simulator(HintedVPTR(), cost).run(fire_tasks(profiles, cost))
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    # the dry-run's [768, 1] takes one element per load
    launches["window_agg_scalar"] = segment_reduce.scalar_launches
    require(segment_reduce.vector_launches == 0,
            f"the dry-run's [768, 1] took 16-byte loads: {launches}")

    require(all(n > 0 for n in launches.values()),
            f"a kernel of the calibration path never launched: {launches}")
    require(cal.device.type == "cuda", f"calibrator on {cal.device}")
    require(len(cal.log) == 3
            and all(c.source == "flop-counter" for c in cal.log),
            f"calibrations: {cal.report()}")
    cpu = [KernelCalibrator(device="cpu").measure(c.operator, agg=c.agg,
                                                  m=c.m) for c in cal.log]
    require(cpu == cal.log, f"card {cal.report()} != CPU {cpu}")
    require(math.isfinite(res.vos) and res.vos > 0
            and res.completed + res.dropped == N_FIRES
            and math.isfinite(res.total_energy_j),
            f"priced trace: vos {res.vos}, {res.completed} done, "
            f"{res.dropped} dropped")
    emit("calibrate", launches=launches, calibrations=cal.report(),
         cells={f"{a}|{s}": list(dataclasses.astuple(c))
                for (a, s), c in cost.cells.items()},
         fires=N_FIRES, vos=res.vos, vos_normalized=res.vos_normalized,
         completed=res.completed, dropped=res.dropped,
         energy_j=res.total_energy_j, seconds=wall, gc=GC_CLOCK.since(gc0))
    return launches


def scenario_path(checked_ratios) -> None:
    """The scenario layer as its users drive it. (a) The three recorded
    scenarios of BENCH_placement.json at their recorded size, compiled
    from their specs and replayed under their recorded searched, all-edge
    and all-DC plans: VoS within 1e-3 of the recorded value, feasibility,
    fires and records as recorded, the ledger conserved. (b)
    heavy_analytics compiled with ``KernelCalibrator()`` on the card, the
    launch counters set to 0 just before: the compile must launch
    window_agg and both flash kernels, its profiles must equal those of
    ``KernelCalibrator(device="cpu")``, and the recorded searched plan
    must run to the same VoS, ledger and energy on both engines, and
    every window/stride ratio it dry-ran window_agg at must be one of
    ``checked_ratios``, the ratios held against the plain version."""
    from repro_torch.placement import PlacementPlan
    from repro_torch.scenario import KernelCalibrator, ScenarioSpec

    recorded = json.loads((ROOT / "BENCH_placement.json").read_text())
    replays = {}
    for name, sc in recorded["scenarios"].items():
        t0 = time.perf_counter()
        engine = ScenarioSpec.from_dict(sc["spec"]).compile()
        compile_s = time.perf_counter() - t0
        names = list(engine.topology)
        chips0 = sc["search"]["chips_options"][0]
        plans = {"searched": PlacementPlan.from_dict(
                     sc["search"]["assignments"]),
                 "all_edge": PlacementPlan.all_edge(names),
                 "all_dc": PlacementPlan.all_dc(names, chips=chips0)}
        rows = {}
        for key, plan in plans.items():
            t0 = time.perf_counter()
            r = engine.run_plan(plan)
            wall = time.perf_counter() - t0
            rec, got = sc[key], r.summary()
            what = f"scenario {name} {key}"
            require(r.feasible == rec["feasible"],
                    f"{what}: feasible {r.feasible}")
            if rec["vos"] is None:
                require(r.vos == float("-inf"), f"{what}: VoS {r.vos}")
            else:
                require(abs(r.vos - rec["vos"]) <= 1e-3,
                        f"{what}: VoS {r.vos!r} vs recorded {rec['vos']}")
            require(got["fires"] == rec["fires"]
                    and got["records"] == rec["records"],
                    f"{what}: fires {got['fires']} records {got['records']}")
            require(r.ledger.conserved(), f"{what}: ledger not conserved")
            rows[key] = {"plan": plan.label,
                         "vos": r.vos if r.feasible else None,
                         "recorded_vos": rec["vos"],
                         "energy_j": r.energy_total_j, "seconds": wall}
        replays[name] = {"compile_seconds": compile_s, "plans": rows}

    sc = recorded["scenarios"]["heavy_analytics"]
    spec = ScenarioSpec.from_dict(sc["spec"])
    counters = zeroed_counters()
    gc0 = GC_CLOCK.read()
    t0 = time.perf_counter()
    cal = KernelCalibrator()
    card = spec.compile(calibrator=cal)
    card_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    ratios = sorted({c.m for c in cal.log if c.operator == "window_agg"})
    require(set(ratios) <= set(checked_ratios),
            f"window_agg dry-run at ratios {ratios}, checked {checked_ratios}")
    require(all(launches[k] > 0 for k in ("window_agg",
                                           "flash_attention_wgmma",
                                           "flash_attention_3xtf32")),
            f"the calibrated compile missed a kernel: {launches}")
    t0 = time.perf_counter()
    cpu = spec.compile(calibrator=KernelCalibrator(device="cpu"))
    cpu_s = time.perf_counter() - t0
    fpr = {k: p.flops_per_record for k, p in card.profiles.items()}
    cpu_fpr = {k: p.flops_per_record for k, p in cpu.profiles.items()}
    require(card.profiles == cpu.profiles,
            f"card profiles {fpr} != CPU {cpu_fpr}")
    require(fpr["classify"] == 65_792.0, f"classify: {fpr['classify']}")
    plan = PlacementPlan.from_dict(sc["search"]["assignments"])
    t0 = time.perf_counter()
    a = card.run_plan(plan)
    run_s = time.perf_counter() - t0
    b = cpu.run_plan(plan)
    require(a.feasible and a.ledger.conserved() and math.isfinite(a.vos),
            f"calibrated heavy_analytics: VoS {a.vos}, feasible {a.feasible}")
    require((a.vos, a.ledger.totals(), a.energy_total_j)
            == (b.vos, b.ledger.totals(), b.energy_total_j),
            f"card engine VoS {a.vos!r} energy {a.energy_total_j!r} != CPU "
            f"VoS {b.vos!r} energy {b.energy_total_j!r}")
    emit("scenario", replays=replays, calibrated={
        "scenario": "heavy_analytics", "compile_seconds": card_s,
        "cpu_compile_seconds": cpu_s, "launches": launches,
        "flops_per_record": fpr, "plan": plan.label, "vos": a.vos,
        "energy_j": a.energy_total_j, "ledger": a.ledger.totals(),
        "run_plan_seconds": run_s, "window_agg_ratios": ratios},
         gc=GC_CLOCK.since(gc0))


# bench_online.py's priors and controller arguments for flash_crowd
# (OnlineScenario's chips_options, window, switch_margin, seed) and
# bench_chaos.py's for crash_during_burst, copied: benchmarks/ imports the
# JAX package
TIDE_PRIORS = {"agg": 8.0, "pctl": 8.0, "trend": 0.02}
CONTROLLERS = {
    "flash_crowd": ("BENCH_online.json", "online", "OnlineController",
                    dict(chips_options=(4, 8), window=1, switch_margin=0.02,
                         seed=0, prior_rates=TIDE_PRIORS)),
    "crash_during_burst": ("BENCH_chaos.json", "chaos", "ChaosController",
                           dict(chips_options=(4,), window=1,
                                switch_margin=0.02, seed=0,
                                prior_rates={"agg": 8.0}))}
HANG_S = 600            # faulthandler's deadline around a forked search
FLUID_N, FLUID_M = 256, 32       # bench_robust.py's throughput shape
FLEET_ENSEMBLE_N = 64
# sha256 of json.dumps(spec.to_dict(), sort_keys=True) for BENCH_fleet.json's
# generated fleet, as the JAX package gives it (bench_fleet.py's digest)
FLEET_SPEC_SHA256 = ("4fcebffbb5576cd7be3609d0dad5f779"
                     "fb131aa7281a65fa60895f5d93eb1a37")
# the fluid stepper on the card against the same call on the CPU: cuBLAS
# and the card's exp round differently in the last bits, so element for
# element |card - cpu| <= FLUID_RTOL * max(1, |cpu|)
FLUID_RTOL = 1e-5
FLUID_FIELDS = ("vos", "vos_service", "vos_t", "lat_mean", "drop_frac")


def fluid_err(card, cpu, what) -> float:
    """The largest |card - cpu| / max(1, |cpu|) over the fluid outputs;
    fails past FLUID_RTOL or where feasibility differs."""
    import numpy as np
    require((card.feasible == cpu.feasible).all(), f"{what}: feasibility")
    worst = 0.0
    for k in FLUID_FIELDS:
        a, b = getattr(card, k), getattr(cpu, k)
        fin = np.isfinite(b)
        require(a.shape == b.shape and (np.isfinite(a) == fin).all(),
                f"{what}: {k} shape or infinities differ")
        rel = np.abs(a[fin] - b[fin]) / np.maximum(1.0, np.abs(b[fin]))
        worst = max(worst, float(rel.max()) if rel.size else 0.0)
    require(worst <= FLUID_RTOL, f"{what}: card vs CPU {worst} > {FLUID_RTOL}")
    return worst


def same_fluid(a, b) -> bool:
    import numpy as np
    return all(np.array_equal(getattr(a, k), getattr(b, k))
               for k in FLUID_FIELDS)


def host_median(fn, calls=3, batches=5, warm=2) -> dict:
    """Host seconds per call: the median of ``batches`` means of ``calls``
    calls after ``warm`` warm-ups, and the batches' spread."""
    for _ in range(warm):
        fn()
    s = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        s.append((time.perf_counter() - t0) / calls)
    s.sort()
    return {"s": s[len(s) // 2], "batches": s, "spread": s[-1] - s[0]}


def launches_per_call(fn, n=3) -> dict:
    """CUDA kernels per call of fn, and the runtime's launch calls by name
    (one ``cudaGraphLaunch`` per graph replay), from torch.profiler over n
    calls after one warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "memcpy" not in e.name.lower()
                  and "memset" not in e.name.lower())
    calls = {}
    for e in prof.key_averages():
        if re.match(r"cu(da)?\w*Launch", e.key):
            calls[e.key] = e.count / n
    return {"kernels": kernels / n, "launch_calls": calls}


def search_path(dev) -> None:
    """(a) The screened search of bench_search_perf.py over the recorded
    scenarios of BENCH_search.json (all but big_fleet), compiled without a
    calibrator: plan and VoS as recorded. (b) heavy_analytics compiled with
    ``KernelCalibrator()`` on the card, the counters set to 0 just before:
    window_agg and both flash kernels launch, and the search picks the
    plan the CPU's calibrator gives. (c) The same search through
    ``ParallelEvaluator(workers=2)``, forked long after this process made
    its CUDA context: the serial plan and VoS bit for bit, the pool used
    and not broken. (d) flash_crowd under ``OnlineController`` and
    crash_during_burst under ``ChaosController`` from their recorded specs:
    VoS within 1e-3 and fires as recorded."""
    import faulthandler

    from repro_torch import chaos, online
    from repro_torch.placement import (Evaluator, ParallelEvaluator,
                                       search_placement)
    from repro_torch.scenario import KernelCalibrator, ScenarioSpec

    placement = json.loads((ROOT / "BENCH_placement.json").read_text())
    recorded = json.loads((ROOT / "BENCH_search.json").read_text())

    def search(engine, sc, evaluator=None):
        sites = tuple(engine.info().fleet.site_names)
        ev = evaluator or Evaluator(engine)
        t0 = time.perf_counter()
        sr = search_placement(
            engine, chips_options=tuple(sc["search"]["chips_options"]),
            dvfs_options=(1.0, 0.7), evaluator=ev, edge_sites=sites)
        return sr, ev, time.perf_counter() - t0

    rows = {}
    for name, rec in recorded["scenarios"].items():
        if name == "big_fleet":
            continue
        sc = placement["scenarios"][name]
        engine = ScenarioSpec.from_dict(sc["spec"]).compile()
        t0 = time.perf_counter()
        engine._ensure_driven()
        drive_s = time.perf_counter() - t0
        sr, ev, wall = search(engine, sc)
        want = rec["new"]
        require(sr.plan.label == want["plan"]
                and abs(sr.result.vos - want["vos"]) <= 1e-3,
                f"search {name}: {sr.plan.label} {sr.result.vos!r}, recorded "
                f"{want['plan']} {want['vos']}")
        rows[name] = {"plan": sr.plan.label, "vos": sr.result.vos,
                      "recorded_vos": want["vos"], "drive_seconds": drive_s,
                      "search_seconds": wall, "evaluations": sr.evaluations,
                      "hits": ev.hits, "misses": ev.misses}

    sc = placement["scenarios"]["heavy_analytics"]
    spec = ScenarioSpec.from_dict(sc["spec"])
    counters = zeroed_counters()
    t0 = time.perf_counter()
    card = spec.compile(calibrator=KernelCalibrator())
    compile_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    require(all(launches[k] > 0 for k in ("window_agg",
                                           "flash_attention_wgmma",
                                           "flash_attention_3xtf32")),
            f"the calibrated compile missed a kernel: {launches}")
    a, ev_a, wall_a = search(card, sc)
    b, _, _ = search(spec.compile(calibrator=KernelCalibrator(
        device="cpu")), sc)
    require((a.plan.label, a.result.vos) == (b.plan.label, b.result.vos),
            f"calibrated search: card {a.plan.label} {a.result.vos!r}, CPU "
            f"{b.plan.label} {b.result.vos!r}")
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    try:
        with ParallelEvaluator(card, workers=2) as pev:
            p, _, wall_p = search(card, sc, evaluator=pev)
            pool = pev.stats()
            broken = pev._pool_broken
    finally:
        faulthandler.cancel_dump_traceback_later()
    require(pool["parallel_batches"] >= 1 and not broken,
            f"the forked pool was not used: {pool}, broken {broken}")
    require((p.plan.key(), p.result.vos, pev.history)
            == (a.plan.key(), a.result.vos, ev_a.history),
            f"forked search {p.plan.label} {p.result.vos!r} != serial "
            f"{a.plan.label} {a.result.vos!r}")
    calibrated = {"compile_seconds": compile_s, "launches": launches,
                  "plan": a.plan.label, "vos": a.result.vos,
                  "search_seconds": wall_a, "parallel": {
                      "search_seconds": wall_p, **pool}}

    controlled = {}
    for name, (bench, key, ctrl, kw) in CONTROLLERS.items():
        rec = json.loads((ROOT / bench).read_text())["scenarios"][name]
        t0 = time.perf_counter()
        engine = ScenarioSpec.from_dict(rec["spec"]).compile()
        cls = getattr(chaos if key == "chaos" else online, ctrl)
        r = engine.run(cls(**kw))
        wall = time.perf_counter() - t0
        got = r.summary()
        require(abs(r.vos - rec[key]["vos"]) <= 1e-3
                and got["fires"] == rec[key]["fires"],
                f"{name} under {ctrl}: VoS {r.vos!r} fires {got['fires']}, "
                f"recorded {rec[key]['vos']} {rec[key]['fires']}")
        require(r.ledger.conserved(), f"{name}: ledger not conserved")
        controlled[name] = {"controller": ctrl, "vos": r.vos,
                            "recorded_vos": rec[key]["vos"],
                            "fires": got["fires"], "seconds": wall,
                            "recorded_wall_s": rec["wall_s"]}
    emit("search", screened=rows, calibrated=calibrated,
         controllers=controlled)


def fluid_path(dev, smi0):
    """bench_robust.py's throughput shape: heavy_analytics, 256 sampled
    realizations and the nominal one × the first 32 plans of
    ``enumerate_plans`` on the card. The shape's first call runs op by op
    and its second captures a CUDA graph of the time loop; the replay
    (``jit=True``) and ``jit=False`` (op by op) must be equal bit for bit
    and within FLUID_RTOL of the same call on the CPU. Then
    ``robust_search`` over the same ensemble: its one fluid call timed
    as the search makes it, its scores within FLUID_RTOL of the CPU's on
    the same candidates and ranked alike; then BENCH_robust.json's
    agreement block on the card. Returns the fluid engine and the
    stepper's inputs, for ``fluid_launches``."""
    import numpy as np
    import torch

    from repro_torch.fluid import ScenarioEnsemble, rank_plans
    from repro_torch.placement import PlacementPlan, robust_search
    from repro_torch.placement.plan import enumerate_plans
    from repro_torch.scenario import ScenarioSpec

    require(not torch.backends.cuda.matmul.allow_tf32,
            "fp32 products would run in TF32")
    placement = json.loads((ROOT / "BENCH_placement.json").read_text())
    spec = ScenarioSpec.from_dict(
        placement["scenarios"]["heavy_analytics"]["spec"])
    engine = spec.compile()
    names = list(engine.order)
    sites = tuple(engine.info().fleet.site_names)
    plans = list(enumerate_plans(names, (4, 8, 16), (1.0,),
                                 edge_sites=sites))[:FLUID_M]
    t0 = time.perf_counter()
    ens = ScenarioEnsemble.from_spec(spec, n=FLUID_N, engine=engine)
    setup_s = time.perf_counter() - t0
    fl = ens.fluid
    require(fl.device == dev and not fl._hier, f"fluid on {fl.device}")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    first = ens.evaluate(plans)
    first_s = time.perf_counter() - t0
    require(fl.graph_captures == 0, "a shape's first call captured a graph")
    t0 = time.perf_counter()
    captured = ens.evaluate(plans)
    capture_s = time.perf_counter() - t0
    require(fl.graph_captures == 1, f"graphs captured {fl.graph_captures}")
    replayed = ens.evaluate(plans)
    eager = ens.evaluate(plans, jit=False)
    require(same_fluid(first, eager) and same_fluid(captured, eager)
            and same_fluid(replayed, eager),
            "graph replay != op-by-op run on the card")
    cpu_ens = ScenarioEnsemble(engine.fluid_engine(device="cpu"), ens.specs,
                               ens.realizations)
    t0 = time.perf_counter()
    cpu = cpu_ens.evaluate(plans)
    cpu_first_s = time.perf_counter() - t0
    err = fluid_err(eager, cpu, "heavy_analytics 257x32")
    N, M = eager.vos.shape
    require((N, M) == (FLUID_N + 1, FLUID_M) and fl.T > 1,
            f"shape {eager.vos.shape}")
    peak = torch.cuda.max_memory_allocated(dev)
    eager_t = host_median(lambda: ens.evaluate(plans, jit=False))
    graph_t = host_median(lambda: ens.evaluate(plans))
    cpu_t = host_median(lambda: cpu_ens.evaluate(plans), calls=1, batches=3,
                        warm=1)

    # robust_search's own fluid call: one evaluate of a shape this engine
    # has not seen, so op by op; the CPU scores the same candidates
    rec = RecordingEnsemble(ens)
    calls0, repeats0 = fl.evaluations, fl.repeated_shapes
    t0 = time.perf_counter()
    rs = robust_search(engine, rec, risk="cvar", chips_options=(4, 8, 16),
                       edge_sites=sites)
    robust_s = time.perf_counter() - t0
    (cands, kw, rs_fr, rs_fluid_s), = rec.calls
    rs_repeats = fl.repeated_shapes - repeats0
    require(fl.evaluations - calls0 == 1 and rs_repeats == 0,
            f"robust_search: {fl.evaluations - calls0} fluid calls, "
            f"{rs_repeats} of a shape seen before")
    t0 = time.perf_counter()
    rs_cpu = cpu_ens.evaluate(cands, **kw)
    rs_cpu_s = time.perf_counter() - t0
    rs_err = fluid_err(rs_fr, rs_cpu, "robust_search candidates")
    require((rank_plans(rs_fr.vos, "cvar")
             == rank_plans(rs_cpu.vos, "cvar")).all(),
            "robust_search: the card ranks its candidates otherwise")
    t0 = time.perf_counter()
    ens.evaluate(cands, **kw)
    rs_capture_s = time.perf_counter() - t0
    robust_tier = {"plan": rs.plan.label, "vos": rs.result.vos,
              "search_seconds": robust_s,
              "candidates": len(cands), "fluid_calls": 1,
              "fluid_calls_repeating_a_shape": rs_repeats,
              "fluid_call_seconds": rs_fluid_s,
              "cpu_call_seconds": rs_cpu_s,
              "second_call_with_capture_seconds": rs_capture_s,
              "max_abs_rel_err_vs_cpu": rs_err}

    # the stepper alone, on the card's clock
    Z = fl.lower_plans(plans)
    Z.pop("feasible")
    P = {k: torch.as_tensor(v).to(dev, torch.float32) for k, v in Z.items()}
    R = {k: torch.as_tensor(v).to(dev, torch.float32)
         for k, v in ens.realizations.items()}

    def stepper_ms(fn):
        fn()
        ms = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(3):
                fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b) / 3)
        ms.sort()
        return {"ms": ms[2], "batches": ms}

    step_eager = stepper_ms(lambda: fl._run(P, R))
    key = fl._shape_key(P, R)
    step_graph = stepper_ms(lambda: fl._replay(key, P, R))

    # BENCH_robust.json's agreement block on the card
    robust = json.loads((ROOT / "BENCH_robust.json").read_text())
    rows = robust["blocks"]["agreement"]["plans"]
    agreement = []
    for name, sc in placement["scenarios"].items():
        eng = ScenarioSpec.from_dict(sc["spec"]).compile()
        names = list(eng.order)
        anchors = [PlacementPlan.all_edge(names, site=s)
                   for s in eng.info().fleet.site_names]
        anchors += [PlacementPlan.all_dc(names, chips=c)
                    for c in sc["search"]["chips_options"]]
        fr = eng.fluid_engine().evaluate(anchors)
        want = [r for r in rows if r["scenario"] == name]
        require([p.label for p in anchors] == [r["plan"] for r in want],
                f"agreement {name}: plans {[p.label for p in anchors]}")
        for m, (plan, row) in enumerate(zip(anchors, want)):
            v = float(fr.vos[0, m])
            ok = (v == float("-inf") if row["fluid_vos"] is None
                  else abs(v - row["fluid_vos"]) <= 1e-3)
            require(ok, f"agreement {name} {plan.label}: fluid VoS {v!r}, "
                        f"recorded {row['fluid_vos']}")
            agreement.append({"scenario": name, "plan": plan.label,
                              "fluid_vos": v if np.isfinite(v) else None,
                              "recorded": row["fluid_vos"]})
    emit("fluid", scenario="heavy_analytics", realizations=N, plans=M,
         bins=fl.T, services=len(fl.order), setup_seconds=setup_s,
         first_call_seconds=first_s, capture_call_seconds=capture_s,
         cpu_first_call_seconds=cpu_first_s, eager_call=eager_t,
         graph_call=graph_t, cpu_call=cpu_t, robust_search=robust_tier,
         stepper_eager_ms=step_eager,
         stepper_graph_ms=step_graph,
         evaluations_per_second=N * M / graph_t["s"],
         max_abs_rel_err_vs_cpu=err, tolerance=FLUID_RTOL,
         max_memory_allocated=peak, agreement=agreement, nvidia_smi=smi0)
    return fl, P, R


class RecordingEnsemble:
    """A ScenarioEnsemble that keeps the plans each evaluate was given and
    what it returned."""

    def __init__(self, ens):
        self.ens, self.calls = ens, []

    @property
    def n_realizations(self):
        return self.ens.n_realizations

    @property
    def fluid(self):
        return self.ens.fluid

    def evaluate(self, plans, **kw):
        t0 = time.perf_counter()
        out = self.ens.evaluate(plans, **kw)
        self.calls.append((list(plans), kw, out, time.perf_counter() - t0))
        return out


def region_path(dev, smi0) -> None:
    """The repo's largest deployment, BENCH_fleet.json's generated fleet
    (500 sites, 8 regions, 24 services), from its recorded generator
    fields: the spec's sha256 as recorded (without its null chaos
    field, which postdates the record); ``region_search`` to VoS
    2107.735 (within 1e-3) serially and through a forked
    ``ParallelEvaluator``, bit-identical; then the search with a fluid
    ensemble of n=64 on the card (the hierarchical branch), whose one
    fluid call runs op by op: the finalists' scores within FLUID_RTOL of
    the CPU's on the same finalists and ranked alike under "cvar"; then
    a second call of that shape, which captures a CUDA graph, bit-equal
    to the first."""
    import faulthandler
    import hashlib

    import torch

    from repro_torch.fluid import ScenarioEnsemble, rank_plans
    from repro_torch.placement import ParallelEvaluator
    from repro_torch.region import FleetGenSpec, generate_fleet, region_search

    rec = json.loads((ROOT / "BENCH_fleet.json").read_text())
    gen = rec["generated"]
    fields = {f.name for f in dataclasses.fields(FleetGenSpec)}
    t0 = time.perf_counter()
    spec = generate_fleet(FleetGenSpec(**{k: v for k, v in gen.items()
                                          if k in fields}))
    sha = lambda d: hashlib.sha256(json.dumps(d, sort_keys=True)
                                   .encode()).hexdigest()
    d = spec.to_dict()
    digest = sha(d)
    # the recorded digest predates the spec's ``chaos`` field (null here):
    # without it the spec must hash as recorded, and with it as the JAX
    # package's spec of today does
    pre_chaos = sha({k: v for k, v in d.items() if k != "chaos"})
    require(d["chaos"] is None and pre_chaos == gen["spec_sha256"]
            and digest == FLEET_SPEC_SHA256,
            f"fleet spec sha256 {digest} (without chaos {pre_chaos}), "
            f"recorded {gen['spec_sha256']}")
    require((len(spec.sites), len(spec.services)) == (gen["sites"],
                                                       gen["services"]),
            f"fleet of {len(spec.sites)} sites, {len(spec.services)} services")
    cs = spec.compile()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs._ensure_driven()
    drive_s = time.perf_counter() - t0
    kw = dict(chips_options=(4, 8), seed=0, sweeps=2)
    t0 = time.perf_counter()
    sr = region_search(cs, **kw)
    search_s = time.perf_counter() - t0
    require(abs(sr.result.vos - rec["search"]["vos"]) <= 1e-3,
            f"region_search VoS {sr.result.vos!r} != {rec['search']['vos']}")
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    try:
        t0 = time.perf_counter()
        with ParallelEvaluator(cs, workers=2, spec=spec) as pev:
            sp = region_search(cs, evaluator=pev, **kw)
            pool, broken = pev.stats(), pev._pool_broken
        par_s = time.perf_counter() - t0
    finally:
        faulthandler.cancel_dump_traceback_later()
    require(pool["parallel_batches"] >= 1 and not broken,
            f"the forked pool was not used: {pool}, broken {broken}")
    require((sp.plan.key(), sp.result.vos) == (sr.plan.key(), sr.result.vos),
            f"parallel {sp.plan.label} {sp.result.vos!r} != serial "
            f"{sr.plan.label} {sr.result.vos!r}")

    t0 = time.perf_counter()
    ens = ScenarioEnsemble.from_spec(spec, n=FLEET_ENSEMBLE_N, engine=cs)
    ens_s = time.perf_counter() - t0
    require(ens.fluid._hier and ens.fluid.device == dev,
            f"fleet fluid: hierarchical {ens.fluid._hier} on {ens.fluid.device}")
    card_rec = RecordingEnsemble(ens)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    a = region_search(cs, ensemble=card_rec, risk="cvar", **kw)
    card_search_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    # the search's one fluid call is the shape's first: op by op
    (cands, ckw, card_fr, first_s), = card_rec.calls
    fl = ens.fluid
    require((fl.evaluations, fl.repeated_shapes, fl.graph_captures)
            == (1, 0, 0), f"region_search's fluid calls: {fl.evaluations}, "
            f"{fl.repeated_shapes} repeating a shape, {fl.graph_captures} "
            "captured")
    # the CPU scores the same finalists; the same order under "cvar" means
    # the same finalists reach the DES tier, so the same plan
    cpu_ens = ScenarioEnsemble(cs.fluid_engine(device="cpu"), ens.specs,
                               ens.realizations)
    t0 = time.perf_counter()
    cpu_fr = cpu_ens.evaluate(cands, **ckw)
    cpu_s = time.perf_counter() - t0
    err = fluid_err(card_fr, cpu_fr, "fleet finalists")
    require((rank_plans(card_fr.vos, "cvar")
             == rank_plans(cpu_fr.vos, "cvar")).all(),
            "cvar ranks the finalists otherwise on the card")
    t0 = time.perf_counter()
    captured = ens.evaluate(cands, **ckw)
    capture_s = time.perf_counter() - t0
    require(fl.graph_captures == 1 and same_fluid(captured, card_fr),
            "fleet: graph replay != op-by-op run")
    replay_t = host_median(lambda: ens.evaluate(cands, **ckw), calls=1,
                           batches=3, warm=0)
    eager_t = host_median(lambda: ens.evaluate(cands, jit=False, **ckw),
                          calls=1, batches=3, warm=0)
    emit("region", sites=len(spec.sites), regions=gen["regions"],
         services=len(spec.services), spec_sha256=digest,
         spec_sha256_without_chaos=pre_chaos,
         compile_seconds=compile_s, drive_seconds=drive_s,
         recorded_drive_wall_s=rec["drive_wall_s"], search_seconds=search_s,
         recorded_search_wall_s=rec["search"]["wall_s"], plan=sr.plan.label,
         vos=sr.result.vos, parallel={"search_seconds": par_s, **pool},
         fluid={"realizations": card_fr.vos.shape[0],
                "candidates": len(cands), "bins": ens.fluid.T,
                "sites": len(ens.fluid.site_names),
                "regions": ens.fluid.n_regions,
                "ensemble_setup_seconds": ens_s,
                "search_seconds": card_search_s,
                "fluid_calls": 1, "fluid_calls_repeating_a_shape": 0,
                "first_call_seconds": first_s, "cpu_call_seconds": cpu_s,
                "second_call_with_capture_seconds": capture_s,
                "graph_call": replay_t, "eager_call": eager_t,
                "max_abs_rel_err_vs_cpu": err, "tolerance": FLUID_RTOL,
                "cvar_plan": a.plan.label, "cvar_vos": a.result.vos,
                "max_memory_allocated": peak}, nvidia_smi=smi0)


def paper4() -> None:
    """examples/vos_scheduler_demo.py on the port's core."""
    from repro_torch import hardware as hw
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.heuristics import HEURISTICS
    from repro_torch.core.simulator import Simulator
    from repro_torch.core.tasks import PAPER_REGIME, TaskType, WorkloadGenerator

    cost = CostModel.analytic()
    types = [TaskType(a, s)
             for a in ("smollm-135m", "qwen3-1.7b", "yi-6b", "olmoe-1b-7b",
                       "jamba-v0.1-52b", "mamba2-1.3b")
             for s in ("train_4k", "prefill_32k", "decode_32k")]
    gen = WorkloadGenerator(types, cost, seed=7, **PAPER_REGIME)
    cap = hw.pod_power_cap_w(0.70)
    rows = {}
    for name, want in PAPER4_VOS.items():
        r = Simulator(HEURISTICS[name], cost, power_cap_w=cap).run(
            copy.deepcopy(gen.trace(120)))
        require(r.vos == want, f"§4 {name}: VoS {r.vos!r} != {want!r}")
        rows[name] = {"vos": r.vos, "completed": r.completed,
                      "dropped": r.dropped, "energy_j": r.total_energy_j}
    emit("paper4", heuristics=rows, power_cap_w=cap)


def kernel_device_ms(fn, n=10) -> dict:
    """Device time per call of each kernel that fn launches, by name, from
    torch.profiler over n calls after one warm-up. Only entries seen a
    multiple of n times count: the profiler's own buffer set-up shows as a
    device entry seen once. A trace that sees no kernel n times (the
    profiler drops a trace's device events now and then) is reported on a
    ``profiler_retry`` line and taken again, up to PROFILER_ATTEMPTS
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILER_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            if t > 0 and e.count % n == 0:
                name = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
                out[name.split("(")[0]] = t / n / 1e3
        if out:
            return out
        emit("profiler_retry", attempt=attempt)
    raise SmokeFailure(f"torch.profiler saw no device time in "
                       f"{PROFILER_ATTEMPTS} traces")


def time_attention_and_ssd(dev, gen, cuda_ms, smi0) -> dict:
    """Kernel, plain version and library call at full width by CUDA
    events, beside the bound; the kernel and the library call as the
    median of 5 batches of 20 launches after 5 warm-ups, with the spread
    (max - min) of the batches. Returns the timings by (kernel, dtype)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import attention_reference
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd
    from repro_torch.kernels.flash_attention.ops import flash_attention_flops
    from repro_torch.kernels.ssd_scan import ssd_scan_reference
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_blh
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_flops
    from repro_torch.kernels.sweeps import full_widths

    flash_full, ssd_full = full_widths()
    timed = {}
    for dt in ("bfloat16", "float32"):
        B, Sq, Skv, H, KV, d, causal = flash_full
        q, k, v = flash_inputs(dev, gen, B, Sq, Skv, H, KV, d, dt)
        nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
        flops = flash_attention_flops(q.shape, k.shape, causal)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        t = {**batches(cuda_ms, lambda: flash_attention_bshd(
                 q, k, v, causal=causal), "ms"),
             "plain_ms": cuda_ms(lambda: attention_reference(
                 q, k, v, causal=causal), 5, 1),
             # SDPA's is_causal is top-left aligned: the same mask at Sq = Skv
             **batches(cuda_ms, lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True), "library_ms"),
             **bound(nbytes, flops, dt), "flops": flops, "bytes": nbytes,
             "kernel": "wgmma" if dt == "bfloat16" else "3xtf32",
             "device_ms_by_kernel": kernel_device_ms(
                 lambda: flash_attention_bshd(q, k, v, causal=causal))}
        timed[("flash", dt)] = t
        emit("times", case="flash_attention qwen3-1.7b", shape=[list(q.shape),
             list(k.shape)], dtype=dt, causal=causal, nvidia_smi=smi0,
             library="scaled_dot_product_attention(is_causal, enable_gqa)",
             **t)
        del q, k, v, qt, kt, vt

        B, L, H, P, G, N, chunk = ssd_full
        x, dtt, A, Bm, Cm = ssd_inputs(dev, gen, B, L, H, P, G, N, dt)
        nbytes = sum(a.numel() * a.element_size()
                     for a in (x, dtt, A, Bm, Cm, x))
        # the bound counts the function's least work, that of the
        # recurrence h <- e^(dt·A)·h + dt·x·Bᵀ, y = C·h: one FMA per state
        # element and step to update h and one to read it out, 4·N·P flops
        # per step and head (the decay's multiply left out). The chunked
        # form that the calibrator counts (ssd_scan_flops) does more.
        flops = 4 * N * P * B * L * H
        t = {**batches(cuda_ms, lambda: ssd_scan_blh(x, dtt, A, Bm, Cm),
                       "ms"),
             "plain_ms": cuda_ms(lambda: ssd_scan_reference(
                 x, dtt, A, Bm, Cm), 2, 1),
             "library_ms": None, **bound(nbytes, flops, dt),
             "flops": flops, "bytes": nbytes,
             "calibrator_flops": ssd_scan_flops(x.shape, Bm.shape, chunk),
             "device_ms_by_kernel": kernel_device_ms(
                 lambda: ssd_scan_blh(x, dtt, A, Bm, Cm))}
        timed[("ssd", dt)] = t
        emit("times", case="ssd_scan mamba2-1.3b", shape=list(x.shape),
             d_state=N, chunk=chunk, dtype=dt, nvidia_smi=smi0,
             library=None, **t)
        del x, dtt, A, Bm, Cm
    return timed


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on a CUDA card")
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.kernels.sweeps import (SEGMENT_SUM_RTOL, WINDOW_SWEEP,
                                            WINDOW_TOL)
    from repro_torch.kernels.window_agg import (window_aggregate,
                                                window_aggregate_reference)
    from repro_torch.kernels.window_agg.kernel import (launch_plan,
                                                       segment_reduce,
                                                       segment_reduce_plain)
    from repro_torch.pipeline import (Broker, HybridExecutor, NeubotFarm,
                                      Pipeline, TimeSeriesStore,
                                      neubot_query_1, neubot_query_2)
    from repro_torch.pipeline.operators import (init_cnn_classifier, lloyd,
                                                linear_regression)

    dev = torch.device("cuda", 0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # ---- card ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi0 = smi.splitlines()[0]
    print(smi0, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=smi0, name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- build ----------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build(build.SOURCES)
    ptxas = {n: build.ptxas_usage(n) for n in build.SOURCES}
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()],
         ptxas=ptxas)
    spills = {k: u for n in ("window_agg", "flash_attention_sm90_f32")
              for k, u in ptxas[n].items()
              if u["spill_stores"] or u["spill_loads"]}
    require(not spills, f"kernels that spill registers: {spills}")

    # ---- kernel vs plain --------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def check_segment(x, stride, agg, name):
        """The kernel against the plain version on x, in the load width
        that launch_plan gives x; returns max |err|."""
        plan = launch_plan(*x.shape, stride, x.element_size(),
                           x.data_ptr() % 16 == 0, sms)
        width = "vector" if plan.vec > 1 else "scalar"
        before = (segment_reduce.vector_launches,
                  segment_reduce.scalar_launches)
        k = segment_reduce(x, agg=agg, stride=stride)
        went = (segment_reduce.vector_launches - before[0],
                segment_reduce.scalar_launches - before[1])
        require(went == ((1, 0) if width == "vector" else (0, 1)),
                f"{name}: (vector, scalar) launches {went}, plan {plan}")
        k2 = segment_reduce(x, agg=agg, stride=stride)
        p = segment_reduce_plain(x, agg=agg, stride=stride)
        torch.cuda.synchronize()
        require(k.shape == p.shape and k.dtype == x.dtype,
                f"{name}: shape {tuple(k.shape)} dtype {k.dtype}")
        require(torch.equal(bits(k), bits(k2)), f"{name}: rerun differs")
        nan = p.isnan()
        require(torch.equal(k.isnan(), nan), f"{name}: NaN positions differ")
        kf, pf = k.float()[~nan], p.float()[~nan]
        err = (kf - pf).abs()
        if agg in ("max", "min"):
            require(torch.equal(bits(k)[~nan], bits(p)[~nan]),
                    f"{name}: not bit-equal to plain")
            tol = "bit-equal"
            rel = 0.0
        else:
            rtol = SEGMENT_SUM_RTOL[str(x.dtype).split(".")[1]]
            scale = segment_reduce_plain(x.abs(), agg="sum",
                                         stride=stride).float()[~nan]
            require(bool((err <= rtol * scale).all()),
                    f"{name}: |kernel - plain| > {rtol} * sum|x|")
            tol = f"|err| <= {rtol} * sum|x| per segment"
            rel = float((err / scale).max()) if err.numel() else 0.0
        e = float(err.max()) if err.numel() else 0.0
        emit("kernel", case=name, max_abs_err=e, max_err_over_sum_abs=rel,
             tolerance=tol, width=width, plan=plan._asdict())
        return e

    for T, C, w, s, agg, dt in WINDOW_SWEEP:
        x = (torch.randn(T, C, device=dev, generator=gen) * 10).to(dtypes[dt])
        for a in ("max", "min", "sum"):
            check_segment(x, s, a, f"sweep[{T},{C}]/{s} {dt} {a}")
        out = window_aggregate(x, agg=agg, window=w, stride=s)
        ref = window_aggregate_reference(x, agg=agg, window=w, stride=s)
        tol = WINDOW_TOL[dt]
        require(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                f"window_aggregate[{T},{C}] w{w}/s{s} {agg} {dt} vs reference")

    # the calibrator's dry-run shapes (KernelCalibrator.window_shape, [T, 1]
    # with window m·64 and stride 64) at every ratio m that the calibrate
    # and scenario phases hand it, in f32 and bf16; its ones and seeded
    # values, from a generator of their own so the draws below stay as
    # they were
    from repro_torch.scenario import KernelCalibrator
    cal_ratios = calibrator_window_ratios()
    g_cal = torch.Generator(device=dev).manual_seed(SEED + 1)
    for m in cal_ratios:
        T, w, s = KernelCalibrator().window_shape(m)
        seeded = torch.randn(T, 1, device=dev, generator=g_cal) * 10
        for (name, x), dt in itertools.product(
                (("ones", torch.ones(T, 1, device=dev)), ("randn", seeded)),
                dtypes):
            x = x.to(dtypes[dt])
            for a in ("max", "min", "sum"):
                check_segment(x, s, a, f"calibrator dry-run m={m} "
                                       f"[{T},1]/{s} {name} {dt} {a}")
            for a in ("max", "min", "sum", "mean"):
                out = window_aggregate(x, agg=a, window=w, stride=s)
                ref = window_aggregate_reference(x, agg=a, window=w, stride=s)
                torch.cuda.synchronize()
                what = (f"window_aggregate calibrator dry-run m={m} {name} "
                        f"{dt} {a}: {out.flatten().tolist()} vs "
                        f"{ref.flatten().tolist()}")
                require(out.shape == ref.shape == ((T - w) // s + 1, 1)
                        and out.dtype == ref.dtype, what)
                if a in ("max", "min"):
                    ok = torch.equal(bits(out), bits(ref))
                elif dt == "float32" or name == "ones":
                    ok = torch.allclose(out.float(), ref.float(),
                                        rtol=WINDOW_TOL[dt],
                                        atol=WINDOW_TOL[dt])
                else:   # bf16 rounds each segment's sum before the combine
                    scale = window_aggregate_reference(
                        x.abs(), agg=a, window=w, stride=s).float()
                    ok = bool(((out.float() - ref.float()).abs()
                               <= SEGMENT_SUM_RTOL[dt] * scale).all())
                require(ok, what)

    # NaN in each width, and through a split's partials
    for T, C, s in ((1000, 4, 100), (1000, 5, 100), (64_000, 128, 16_000)):
        xn = torch.randn(T, C, device=dev, generator=gen)
        xn[5, 1] = float("nan")
        for a in ("max", "min", "sum"):
            check_segment(xn, s, a, f"nan[{T},{C}]/{s} {a}")
    # views whose pointer is off 16 bytes take one element per load: x[1:]
    # of a contiguous [T, 5] (20 bytes off), in many segments and in one
    # split segment, and [T, 128] rows 4 bytes off
    for T, C, s in ((100_000, 5, 100), (100_000, 5, 100_000),
                    (100_001, 128, 100_001)):
        off = 5 if C == 5 else 1
        flat = torch.randn(T * C + off, device=dev, generator=gen) * 10
        x = flat[off:].view(T, C)
        require(x.data_ptr() % 16 != 0, f"[{T},{C}] view is aligned")
        for a in ("max", "min", "sum"):
            check_segment(x, s, a, f"misaligned[{T},{C}]+{off}/{s} {a}")
    del flat, x

    def neubot_speeds(n, g):
        """n download speeds in bit/s, shaped like the producers' records."""
        return (torch.randn(n, device=dev, generator=g) * 4e6
                + 20e6).clamp_min_(0.1e6)

    def main_shapes():
        """The kernel's inputs at the main path's shape (the Q2 fold of
        82,944,000 speeds, one segment) and at the fleet shape."""
        T, C, w, s = FLEET
        fleet = {f"fleet_{dt}": ((torch.randn(T, C, device=dev, generator=gen)
                                  * 10).to(dtypes[dt]), s) for dt in dtypes}
        return {"q2_fold": (neubot_speeds(Q2_RECORDS, gen).view(-1, 128),
                            Q2_RECORDS // 128), **fleet}

    shape_err = {}
    for name, (x, stride) in main_shapes().items():
        for a in ("max", "min", "sum"):
            e = check_segment(x, stride, a, f"{name}{list(x.shape)}/{stride} {a}")
            shape_err[name] = max(shape_err.get(name, 0.0), e)
    del x
    full_err = check_attention_and_ssd(dev, gen)

    # ---- main path ---------------------------------------------------------------
    segment_reduce.launches = 0
    segment_reduce.vector_launches = segment_reduce.scalar_launches = 0
    torch.cuda.reset_peak_memory_stats(dev)

    broker = Broker()
    stores = [TimeSeriesStore("speedtests", chunk_seconds=3600.0)
              for _ in range(2)]
    farm = NeubotFarm(broker, n_things=N_THINGS, rate_hz=RATE_HZ, seed=SEED)
    q1 = neubot_query_1(broker, stores[0])
    q2 = neubot_query_2(broker, stores[1])
    pipe = Pipeline(broker).add_farm(farm).add_service(q1).add_service(q2)
    t0 = time.perf_counter()
    for minute in range(1, int(HOURS * 60) + 1):      # fetch every minute
        pipe.advance_to(60.0 * minute)
    edge_s = time.perf_counter() - t0
    r1, r2 = q1.results, q2.results
    require(len(r1) == 60 and len(r2) == 12, f"fires: Q1 {len(r1)}, Q2 {len(r2)}")
    # Q1 oracle: the same farm regenerated, its records scanned with numpy
    farm2 = NeubotFarm(Broker(), n_things=N_THINGS, rate_hz=RATE_HZ, seed=SEED)
    farm2.advance_to(HOURS * 3600.0)
    recs = list(farm2.producers[0].q.buf)
    ts = np.array([r.ts for r in recs])
    dl = np.array([r.values["download_speed"] for r in recs])
    for r in r1:
        m = (ts >= r["ts"] - 180.0) & (ts < r["ts"])
        require(r["n"] == int(m.sum()) and r["value"] == dl[m].max(),
                f"Q1 at {r['ts']}: {r['n']} records, {r['value']}")
    for r in r2:
        require(0 < r["n"] <= int((ts < r["ts"]).sum())
                and dl.min() <= r["value"] <= dl.max(),
                f"Q2 at {r['ts']}: {r['n']} records, {r['value']}")

    hx = HybridExecutor()
    runs = []
    # Q2's own window at the end of the hour, out of the store and buffer
    live = q2._window_values(HOURS * 3600.0)
    v = hx.run_window(live, "mean")
    require(v == r2[-1]["value"], f"Q2 window through the executor: {v}")
    runs.append({"n": len(live), "agg": "mean", "source": "store+buffer",
                 "value": v})
    rng = np.random.default_rng(SEED)
    hist = np.maximum(rng.standard_normal(Q2_RECORDS, dtype=np.float32)
                      * np.float32(4e6) + np.float32(20e6), np.float32(0.1e6))
    for n in Q2_WINDOWS:
        vals = hist[:n]
        for agg in ("mean", "max"):
            t0 = time.perf_counter()
            v = hx.run_window(vals, agg)
            dt_s = time.perf_counter() - t0
            if agg == "max":
                ref = float(vals.max())
                require(v == ref, f"Q2 n={n} max {v} != {ref}")
            else:
                ref = float(vals.mean(dtype=np.float64))
                require(abs(v - ref) <= Q2_MEAN_RTOL * abs(ref),
                        f"Q2 n={n} mean {v} vs {ref}")
            runs.append({"n": n, "agg": agg, "value": v, "reference": ref,
                         "rel_err": abs(v - ref) / abs(ref),
                         "offload": n > hx.edge_budget, "seconds": dt_s})
    # a window already on the card is used where it lies
    on_card = torch.from_numpy(hist).to(dev)
    t0 = time.perf_counter()
    v = hx.run_window(on_card, "mean")
    dt_s = time.perf_counter() - t0
    ref = float(hist.mean(dtype=np.float64))
    require(abs(v - ref) <= Q2_MEAN_RTOL * abs(ref), f"on-card Q2 mean {v}")
    runs.append({"n": Q2_RECORDS, "agg": "mean", "source": "tensor on card",
                 "value": v, "reference": ref, "rel_err": abs(v - ref) / ref,
                 "offload": True, "seconds": dt_s})
    del on_card

    n_off = sum(n > hx.edge_budget for n in Q2_WINDOWS) * 2 + 1
    n_edge = 1 + sum(n <= hx.edge_budget for n in Q2_WINDOWS) * 2
    launches = segment_reduce.launches
    widths = {"vector": segment_reduce.vector_launches,
              "scalar": segment_reduce.scalar_launches}
    require(hx.offloads == n_off and hx.edge_runs == n_edge,
            f"offloads {hx.offloads} (want {n_off}), edge runs "
            f"{hx.edge_runs} (want {n_edge})")
    require(launches == n_off, f"kernel launches {launches} != offloads {n_off}")
    peak = torch.cuda.max_memory_allocated(dev)
    emit("main", q1_fires=len(r1), q2_fires=len(r2), edge_hour_seconds=edge_s,
         buffer_evictions=[q1.buffer_evictions, q2.buffer_evictions],
         edge_runs=hx.edge_runs,
         offloads=hx.offloads, segment_reduce_launches=launches,
         segment_reduce_launches_by_width=widths,
         max_memory_allocated=peak, windows=runs)

    # ---- the fleet path: Q1 for 1,024 things over a day, in each type ------------
    T, C, w, s = FLEET
    g_fleet = torch.Generator(device=dev).manual_seed(SEED + 2)
    fleet_launches = {}
    for dt in dtypes:
        x = neubot_speeds(T * C, g_fleet).view(T, C).to(dtypes[dt])
        segment_reduce.launches = 0
        segment_reduce.vector_launches = segment_reduce.scalar_launches = 0
        out = window_aggregate(x, agg="max", window=w, stride=s)
        torch.cuda.synchronize()
        went = {"launches": segment_reduce.launches,
                "vector": segment_reduce.vector_launches,
                "scalar": segment_reduce.scalar_launches}
        ref = window_aggregate_reference(x, agg="max", window=w, stride=s)
        require(out.shape == ref.shape == ((T - w) // s + 1, C)
                and torch.equal(bits(out), bits(ref)),
                f"fleet Q1 {dt}: not bit-equal to the plain version")
        require(went == {"launches": 1, "vector": 1, "scalar": 0},
                f"fleet Q1 {dt}: launches {went}")
        fleet_launches[dt] = went["launches"]
        emit("fleet", shape=[T, C], window=w, stride=s, agg="max", dtype=dt,
             segment_reduce_launches=went)
    del x, out, ref

    # analytics operators on the card against the same code on the CPU;
    # fp32 convolutions in full precision (cuDNN defaults to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    feats = rng.standard_normal((4096, 2)).astype(np.float32)
    init = feats[rng.choice(4096, 3, replace=False)]
    c_gpu, a_gpu = lloyd(torch.from_numpy(feats).to(dev),
                         torch.from_numpy(init).to(dev), 15)
    c_cpu, a_cpu = lloyd(torch.from_numpy(feats), torch.from_numpy(init), 15)
    km_err = float((c_gpu.cpu() - c_cpu).abs().max())
    require(km_err <= 1e-5 and torch.equal(a_gpu.cpu(), a_cpu),
            f"k-means on the card vs CPU: {km_err}")
    xr = rng.standard_normal(1000).astype(np.float32)
    yr = (3.0 * xr + 1.0 + 0.1 * rng.standard_normal(1000)).astype(np.float32)
    b_gpu, _ = linear_regression(xr, yr)
    b_cpu, _ = linear_regression(xr, yr, device="cpu")
    lr_err = float((b_gpu.cpu() - b_cpu).abs().max())
    require(lr_err <= 1e-4, f"linear regression on the card vs CPU: {lr_err}")
    cnn = init_cnn_classifier(seed=SEED)
    wins = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    with torch.no_grad():
        lg_gpu = cnn(wins.to(dev)).cpu()
        lg_cpu = cnn.cpu()(wins)
    cnn_err = float((lg_gpu - lg_cpu).abs().max())
    require(bool(torch.isfinite(lg_gpu).all()) and cnn_err <= 1e-5,
            f"CNN logits on the card vs CPU: {cnn_err}")
    emit("operators", cudnn_allow_tf32=False, kmeans_max_abs_err=km_err,
         linreg_max_abs_err=lr_err, cnn_max_abs_err=cnn_err)

    # ---- the JITA-4DS path and the paper's §4 experiment -------------------------
    cal_launches = calibration_path()
    scenario_path(cal_ratios)
    search_path(dev)
    fluid = fluid_path(dev, smi0)
    region_path(dev, smi0)
    paper4()

    # ---- times ---------------------------------------------------------------------
    def cuda_ms(fn, reps=50, warm=3):
        for _ in range(warm):
            fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    library = {"max": torch.amax, "sum": torch.sum}
    timed = {}
    for name, (x, stride) in main_shapes().items():
        n_seg = x.shape[0] // stride
        for agg in ("sum", "max"):
            lib = library[agg]
            if n_seg == 1:
                def lib_call(x=x, lib=lib):
                    return lib(x, 0)
            else:
                def lib_call(x=x, lib=lib, n_seg=n_seg, stride=stride):
                    return lib(x.view(n_seg, stride, x.shape[1]), 1)
            nbytes = (n_seg * stride + n_seg) * x.shape[1] * x.element_size()
            # one fp32 compare or add per element
            t = {**batches(cuda_ms, lambda: segment_reduce(
                     x, agg=agg, stride=stride), "ms"),
                 "plain_ms": cuda_ms(lambda: segment_reduce_plain(
                     x, agg=agg, stride=stride)),
                 **batches(cuda_ms, lib_call, "library_ms"),
                 **bound(nbytes, n_seg * stride * x.shape[1], "float32")}
            timed[(name, agg)] = t
            emit("times", case=name, shape=list(x.shape), dtype=str(x.dtype),
                 stride=stride, agg=agg, nvidia_smi=smi0, **t)
    del x
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = torch.from_numpy(hist).to(dev)
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    emit("times", case="h2d_copy", bytes=hist.nbytes, seconds=h2d_s,
         gb_per_s=hist.nbytes / h2d_s / 1e9)
    del on_card
    emit("times", case="run_window_e2e",
         windows=[{k: r[k] for k in ("n", "agg", "seconds")}
                  for r in runs if "seconds" in r],
         max_memory_allocated=peak, nvidia_smi=smi0)
    timed_full = time_attention_and_ssd(dev, gen, cuda_ms, smi0)
    # the fluid stepper's kernels per call, traced last: after a trace of
    # the stepper, torch.profiler saw no device time in later traces. One
    # call each, then a probe trace of one small kernel: whether the
    # profiler still sees device time after a trace of this length
    fl, P, R = fluid
    key = fl._shape_key(P, R)
    emit("fluid_launches",
         eager=launches_per_call(lambda: fl._run(P, R), n=1),
         graph=launches_per_call(lambda: fl._replay(key, P, R), n=1))
    ones = torch.ones(1 << 20, device=dev)
    try:
        probe = kernel_device_ms(lambda: ones.sum())
    except SmokeFailure:
        probe = {}
    emit("profiler_probe", after="fluid_launches",
         device_time_seen=bool(probe), kernels=probe)

    # ---- result ----------------------------------------------------------------------
    # window_agg at the Q2 fold and the fleet shape (sum), its launches on
    # the pipeline's path and on the fleet path; flash attention's and the SSD scan's two kernels
    # each at full width in their types (bf16: wgmma; fp32: 3xTF32 for
    # flash, FMA for the SSD), their launches on the calibration path
    window = "src/repro/kernels/window_agg/kernel.py:45"
    flash = "src/repro/kernels/flash_attention/kernel.py:87"
    ssd = "src/repro/kernels/ssd_scan/kernel.py:71"
    rows = [(f"window_agg.segment_reduce {shape}", "window_agg", window, n,
             shape_err[shape], timed[(shape, "sum")])
            for shape, n in (("q2_fold", launches),
                             ("fleet_float32", fleet_launches["float32"]),
                             ("fleet_bfloat16", fleet_launches["bfloat16"]))]
    rows += [("flash_attention.flash_attention_wgmma", "flash_attention_sm90",
              flash, cal_launches["flash_attention_wgmma"],
              full_err[("flash", "bfloat16")],
              timed_full[("flash", "bfloat16")]),
             ("flash_attention.flash_attention_3xtf32",
              "flash_attention_sm90_f32", flash,
              cal_launches["flash_attention_3xtf32"],
              full_err[("flash", "float32")],
              timed_full[("flash", "float32")]),
             ("ssd_scan.ssd_scan_wgmma", "ssd_scan", ssd,
              cal_launches["ssd_scan_wgmma"], full_err[("ssd", "bfloat16")],
              timed_full[("ssd", "bfloat16")]),
             ("ssd_scan.ssd_scan_fma", "ssd_scan", ssd,
              cal_launches["ssd_scan_fma"], full_err[("ssd", "float32")],
              timed_full[("ssd", "float32")])]
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}.cu",
        "replaces": replaces, "launches": n, "max_abs_err": err,
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes" if t["bound_by"] == "bytes" else "operations",
        "library_ms": t["library_ms"], "bound_detail": t["bound_by"],
        "ms_spread": t["ms_spread"]}
        for name, src, replaces, n, err, t in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
