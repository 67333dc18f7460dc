"""One run of one cell of the benchmark of ``repro_torch`` on NVIDIA
GPUs:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each compared number with its limit); the checks are
also the last lines of standard error. With ``--trace 0`` the metrics
are the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics. Exits non-zero, printing no result, where there is no CUDA
device or fewer than the cell asks for, where the program cannot be
imported, or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    """The checkout's root (for ``portbench``) and ``src`` (the program)
    on the import path; every build and kernel cache inside the
    checkout, at fixed paths."""
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is JAX's, jaxlib's,
    flax's or the JAX package's, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def result(cell, out, trace: bool, device, checks: dict, correct: bool,
           readers=None) -> dict:
    import torch
    from portbench.harness import trace as TR
    metrics = {}
    if trace:
        for name, read in readers.items():
            v = read(out.run)
            if v is not None:
                unit = next(m["unit"] for m in cell.per_layer
                            if m["name"] == name)
                metrics[name] = {"value": v, "unit": unit}
    else:
        for m in cell.end_to_end:
            v = out.setup_s if m["name"] == "setup_s" \
                else out.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": dev}
    tl = out.run.timeline if trace else None
    if tl is not None and tl.spans:
        lo, hi = tl.window()
        iv = [(a.start_ns, a.end_ns) for a in tl.activities]
        dev["busy_s"] = TR.union_ns(iv, lo, hi) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        total = TR.union_ns(iv, min(iv)[0], max(e for _, e in iv)) \
            if iv else 0
        print(f"timeline: {dev['busy_s']:.6f} s of the device's "
              f"{total / 1e9:.6f} s busy lie inside the traced spans",
              file=sys.stderr)
        line["breakdown"] = TR.breakdown(tl, out.run.ops, lo, hi)
    if trace and out.run.ops is not None:
        for op in sorted({c.name for c in out.run.ops.ops}):
            calls = out.run.ops.calls(op)
            print(f"ops: {op} {len(calls)} calls, "
                  f"{sum(c.device_ns for c in calls) / 1e6 / len(calls):.4f} "
                  f"ms of device time a call", file=sys.stderr)
        n = sum(a.inferred for a in out.run.ops.activities)
        print(f"ops: {n} of {len(out.run.ops.activities)} device activities "
              f"had their launch inferred", file=sys.stderr)
    line["checks"] = checks
    return line


def run(workload: str, seed: int, seconds: float, trace: bool, device,
        cell=None, wrap=None) -> dict:
    """One run; ``cell`` (a resolved cell) and ``wrap`` are for tests."""
    from portbench.harness import cells, compare, manifest
    if cell is None:
        cell = manifest.resolve(workload, manifest.load_manifest(ROOT))
    kind = cell.traffic["kind"]
    go = cells.train if kind == "train" else cells.serve
    out = go(cell, seed, seconds, trace, device, T_START, wrap)
    checks = compare.check(out.readings, cell.limits)
    correct = compare.passed(checks) and out.failed == 0
    line = result(cell, out, trace, device, checks, correct,
                  manifest.readers(cell) if trace else None)
    checks = line.pop("checks")
    line["readings"] = out.readings       # every number, for the record
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch
    from portbench.harness import manifest
    cell = manifest.resolve(args.workload, manifest.load_manifest(ROOT))
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run(args.workload, args.seed, args.seconds, bool(args.trace),
               torch.device("cuda", 0), cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}: the run may not load JAX or the "
              f"JAX package", file=sys.stderr)
        return 3
    print("readings " + json.dumps(line.pop("readings")), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
