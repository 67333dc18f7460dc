#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. It builds the port's CUDA kernels from
``src/repro_torch/kernels/csrc`` (into ``build/kernels``), then runs these
phases, each printing one JSON line; any failure exits non-zero:

  card    nvidia-smi's name and power limit (also printed raw), torch's name
  build   the kernels' build, timed as set-up
  kernel  every kernel against its plain torch version on the card, at the
          test sweep's shapes and the main path's, plus a NaN case and a
          bitwise rerun check
  main    the paper's §3 use case through the port's entry points: a Neubot
          farm of 8 things at 1 Hz → broker → Q1 and Q2 stream services
          (fetch → bounded buffer → spill to the store) for one simulated
          hour on the edge, then Q2 windows of up to 82,944,000 records
          (120 days at 1 Hz for 8 things) through ``HybridExecutor()``,
          checked against float64 numpy; the kernel's launch counter shows
          that the offloads ran it; then the analytics operators on the card
          against the same operators on the CPU
  times   kernel, plain version and one library call by CUDA events at the
          main path's shape and the fleet shape, beside the bound; the
          host-to-device copy and ``run_window`` end to end; peak memory

Then one line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device":
{...}}``. With no CUDA card it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
SEED = 0
N_THINGS, RATE_HZ, HOURS = 8, 1.0, 1.0
Q2_RECORDS = 120 * 86400 * N_THINGS          # 82,944,000
Q2_WINDOWS = (10_000, 1_000_000, 10_368_000, Q2_RECORDS)
FLEET = (86_400, 1_024, 180, 60)              # T, C, window, stride: Q1 for 1,024 things
# the sweep of tests/test_kernels_window.py: T, C, window, stride, agg, dtype
SWEEP = ((600, 5, 180, 60, "max", "float32"),
         (600, 5, 180, 60, "mean", "float32"),
         (1024, 130, 256, 64, "sum", "float32"),
         (777, 3, 120, 40, "min", "float32"),
         (2000, 1, 500, 100, "mean", "float32"),
         (512, 128, 128, 128, "max", "bfloat16"))
RTOL_SUM = {"float32": 1e-5, "bfloat16": 1e-1}
Q2_MEAN_RTOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false; this "
                 "script runs only on a CUDA card")
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.kernels.window_agg import (window_aggregate,
                                                window_aggregate_reference)
    from repro_torch.kernels.window_agg.kernel import (segment_reduce,
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
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()])

    # ---- kernel vs plain --------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    def check_segment(x, stride, agg, name):
        """The kernel against the plain version on x; returns max |err|."""
        k = segment_reduce(x, agg=agg, stride=stride)
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
            rtol = RTOL_SUM[str(x.dtype).split(".")[1]]
            scale = segment_reduce_plain(x.abs(), agg="sum",
                                         stride=stride).float()[~nan]
            require(bool((err <= rtol * scale).all()),
                    f"{name}: |kernel - plain| > {rtol} * sum|x|")
            tol = f"|err| <= {rtol} * sum|x| per segment"
            rel = float((err / scale).max()) if err.numel() else 0.0
        e = float(err.max()) if err.numel() else 0.0
        emit("kernel", case=name, max_abs_err=e, max_err_over_sum_abs=rel,
             tolerance=tol)
        return e

    for T, C, w, s, agg, dt in SWEEP:
        x = (torch.randn(T, C, device=dev, generator=gen) * 10).to(dtypes[dt])
        for a in ("max", "min", "sum"):
            check_segment(x, s, a, f"sweep[{T},{C}]/{s} {dt} {a}")
        out = window_aggregate(x, agg=agg, window=w, stride=s)
        ref = window_aggregate_reference(x, agg=agg, window=w, stride=s)
        tol = 1e-4 if dt == "float32" else 1e-1
        require(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
                f"window_aggregate[{T},{C}] w{w}/s{s} {agg} {dt} vs reference")

    xn = torch.randn(1000, 4, device=dev, generator=gen)
    xn[5, 1] = float("nan")
    for a in ("max", "min", "sum"):
        check_segment(xn, 100, a, f"nan[1000,4]/100 {a}")

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

    fold_err = 0.0
    for name, (x, stride) in main_shapes().items():
        for a in ("max", "min", "sum"):
            e = check_segment(x, stride, a, f"{name}{list(x.shape)}/{stride} {a}")
            if name == "q2_fold":
                fold_err = max(fold_err, e)
    del x

    # ---- main path ---------------------------------------------------------------
    segment_reduce.launches = 0
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
    require(hx.offloads == n_off and hx.edge_runs == n_edge,
            f"offloads {hx.offloads} (want {n_off}), edge runs "
            f"{hx.edge_runs} (want {n_edge})")
    require(launches == n_off, f"kernel launches {launches} != offloads {n_off}")
    peak = torch.cuda.max_memory_allocated(dev)
    emit("main", q1_fires=len(r1), q2_fires=len(r2), edge_hour_seconds=edge_s,
         buffer_evictions=[q1.buffer_evictions, q2.buffer_evictions],
         edge_runs=hx.edge_runs,
         offloads=hx.offloads, segment_reduce_launches=launches,
         max_memory_allocated=peak, windows=runs)

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

    def bound(x, stride):
        n_seg = x.shape[0] // stride
        nbytes = (n_seg * stride + n_seg) * x.shape[1] * x.element_size()
        ops = n_seg * stride * x.shape[1]
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        return max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

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
            b_ms, b_by = bound(x, stride)
            t = {"ms": cuda_ms(lambda: segment_reduce(x, agg=agg,
                                                      stride=stride)),
                 "plain_ms": cuda_ms(lambda: segment_reduce_plain(
                     x, agg=agg, stride=stride)),
                 "library_ms": cuda_ms(lib_call),
                 "bound_ms": b_ms, "bound_by": b_by}
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

    # ---- result ----------------------------------------------------------------------
    fold_t = timed[("q2_fold", "sum")]
    print(json.dumps({"kernels": [{
        "name": "window_agg.segment_reduce",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/window_agg.cu",
        "replaces": "src/repro/kernels/window_agg/kernel.py:45",
        "launches": launches,
        "max_abs_err": fold_err,
        "ms": fold_t["ms"], "plain_ms": fold_t["plain_ms"],
        "bound_ms": fold_t["bound_ms"], "bound_by": fold_t["bound_by"],
        "library_ms": fold_t["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
