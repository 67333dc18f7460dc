"""The two backward kernels of the bf16 training path, on the card, against
the parent commit's and against variants of their tile constants, timed in
turns in one process.

Run from the root of a checkout, on a machine with ``nvcc`` and a card:

    python3 scripts/bwd_turns.py [--parent DIR] [--trace]

DIR (default ``build/parent``) is a checkout of the commit to compare with,
unpacked there beforehand, e.g. ``git archive HEAD~1 | tar -x -C
build/parent``. Its ``csrc/flash_attention_bwd_sm90.cu`` and
``csrc/ssd_scan_bwd_sm90.cu`` are built as ``parent`` (an SSD build
without ``ssd_scan_bwd_sm90_heads_per_block`` is called with per-head
partials of dB and dC, as it was before). This checkout's sources are built
as ``base`` and, with one constant set to another value and nothing else
changed, as each of VARIANTS. Every build
goes into ``build/kernels/turns/<source>/<build>/`` with
``build.NVCC_FLAGS``, one nvcc each, all started together.

Prints one JSON object per line: the card's name and power limit; per build
ptxas's largest register count and its spill bytes; per case of CASES each
build's gradients against the base's and the base's against the formula
in fp32 (max |diff| / max|g| per gradient, NaN where one is not finite);
at the TIMED training shapes the same against the base, and each build's
time: 5 warm-ups of each, then 5 rounds of one batch of 20 launches of
every build in turn (CUDA events), the median batch's ms per call, the
batches and their spread. With ``--trace``, the device ms per call of each
kernel of ``parent`` and ``base`` at the TIMED shapes, from torch.profiler,
each in a process of its own (``--trace-child``).
"""
import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention.backward import (  # noqa: E402
    flash_attention_backward)
from repro_torch.kernels.ssd_scan import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd_scan.backward import (  # noqa: E402
    ssd_scan_backward)

FLASH, SSD = "flash_attention_bwd_sm90", "ssd_scan_bwd_sm90"
VARIANTS = {FLASH: {"bn1_64": {"kBN1": 64}},
            SSD: {"hb4": {"kHeadsPerBlock": 4},
                  "hb8": {"kHeadsPerBlock": 8}}}
# flash (B, Sq, Skv, H, KV, d, causal); SSD (B, L, H, P, G, N)
CASES = {FLASH: ((1, 1100, 1300, 4, 2, 128, True),
                 (1, 160, 96, 5, 1, 64, True),
                 (2, 200, 300, 4, 2, 16, False)),
         SSD: ((1, 328, 64, 64, 1, 128), (1, 200, 32, 16, 2, 32))}
TIMED = {FLASH: (("qwen3-1.7b", (2, 4096, 4096, 16, 8, 128, True)),
                 ("granite-moe-1b-a400m", (2, 4096, 4096, 16, 8, 64, True))),
         SSD: (("mamba2-1.3b", (2, 4096, 64, 64, 1, 128)),)}


def build_dir(source: str, name: str) -> Path:
    return build.BUILD_DIR / "turns" / source / name


def build_all(parent: Path) -> dict:
    """(source, build) → ptxas's {registers, spill_bytes}; one nvcc per
    build, all started together."""
    procs = {}
    for source in (FLASH, SSD):
        csrc = {"parent": parent / "src/repro_torch/kernels/csrc",
                "base": build.CSRC}
        texts = {n: (d / f"{source}.cu").read_text() for n, d in csrc.items()}
        headers = {n: sorted(d.glob("*.cuh")) for n, d in csrc.items()}
        for name, consts in VARIANTS[source].items():
            text = texts["base"]
            for const, value in consts.items():
                text, k = re.subn(rf"constexpr int {const} = \d+;",
                                  f"constexpr int {const} = {value};", text)
                assert k == 1, f"{const} not found once in {source}.cu"
            texts[name], headers[name] = text, headers["base"]
        for name, text in texts.items():
            out = build_dir(source, name)
            shutil.rmtree(out, ignore_errors=True)
            out.mkdir(parents=True)
            for header in headers[name]:
                shutil.copy(header, out)
            (out / f"{source}.cu").write_text(text)
            procs[source, name] = subprocess.Popen(
                [build.find_nvcc(), *build.NVCC_FLAGS, "-o",
                 str(out / f"lib{source}.so"), str(out / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    usage = {}
    for (source, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {source} {name}:\n{log}")
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        usage[source, name] = {"registers": max(regs),
                               "spill_bytes": sum(spills)}
    return usage


def backward_fn(source: str, name: str):
    """The backward of build ``name`` of ``source`` as a function of its
    inputs, counting no launch."""
    lib = ctypes.CDLL(str(build_dir(source, name) / f"lib{source}.so"))
    if source == FLASH:
        FK._bind(lib, FLASH, 9, ("query", "key"), "backward")
        return lambda *a: FK.backward_launch(lib, *a)
    if hasattr(lib, "ssd_scan_bwd_sm90_heads_per_block"):
        SK.bind_backward(lib)
        return lambda *a: SK.backward_launch(lib, *a)
    # a build from before the adjoint took several heads a block: per-head
    # partials of dB and dC
    fn = lib.ssd_scan_bwd_sm90_backward
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int64] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def parent_ssd(x, dt, A, B_, C, dy):
        Bb, L, H, P = x.shape
        G, N = B_.shape[2], B_.shape[3]
        nc = -(-L // 64)
        f32, dev = torch.float32, x.device
        dx, dB, dC = (torch.empty_like(t) for t in (x, B_, C))
        ddt = torch.empty((Bb, L, H), dtype=f32, device=dev)
        dA = torch.empty(H, dtype=f32, device=dev)
        states = torch.empty(Bb * H * nc * N * P, dtype=f32, device=dev)
        hin, ds = torch.empty((2, states.numel()), dtype=torch.bfloat16,
                              device=dev)
        per_chunk = torch.empty((2, Bb * H * nc), dtype=f32, device=dev)
        parts = torch.empty((2, Bb, L, H, N), dtype=f32, device=dev)
        ptrs = (x, dt, A, B_, C, dy, dx, ddt, dA, dB, dC, states,
                per_chunk[0], hin, ds, parts[0], parts[1], per_chunk[1])
        err = fn(*(t.data_ptr() for t in ptrs), Bb, L, H, G, P, N,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent ssd backward failed ({err})")
        return dx, ddt, dA, dB, dC
    return parent_ssd


def inputs(source: str, shape, seed: int) -> tuple:
    """Seeded bf16 inputs on the card, as the training path gives them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev, bf = torch.device("cuda", 0), torch.bfloat16

    def rn(*s):
        return torch.randn(s, device=dev, generator=gen)
    if source == FLASH:
        B, Sq, Skv, H, KV, d, causal = shape
        return (rn(B, Sq, H, d).to(bf), rn(B, Skv, KV, d).to(bf),
                rn(B, Skv, KV, d).to(bf), rn(B, Sq, H, d).to(bf), causal)
    B, L, H, P, G, N = shape
    return (rn(B, L, H, P).to(bf), torch.nn.functional.softplus(rn(B, L, H)),
            -torch.exp(rn(H) * 0.5), (rn(B, L, G, N) * 0.3).to(bf),
            (rn(B, L, G, N) * 0.3).to(bf), rn(B, L, H, P).to(bf))


def formula(source: str, args) -> tuple:
    """The formula in fp32 on the same values."""
    if source == FLASH:
        *t, causal = args
        return flash_attention_backward(*(x.float() for x in t), causal)
    *ins, dy = args
    return ssd_scan_backward(*(x.float() for x in ins), 64, dy.float())


def rel(got, want) -> list:
    """max |got - want| / max|want| per gradient; NaN if not finite."""
    return [float((a.float() - b.float()).abs().max()
                  / b.float().abs().max().clamp(min=1e-30))
            if bool(torch.isfinite(a.float()).all()) else math.nan
            for a, b in zip(got, want)]


def batch_ms(fn, reps=20) -> float:
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def turns(fns: dict) -> dict:
    """5 warm-ups of each, then 5 rounds of one batch of 20 of each in
    turn: the median batch, the batches, their spread."""
    for fn in fns.values():
        for _ in range(5):
            fn()
    ms = {n: [] for n in fns}
    for _ in range(5):
        for n, fn in fns.items():
            ms[n].append(batch_ms(fn))
    return {n: {"ms": sorted(t)[2], "batches": sorted(t),
                "spread": max(t) - min(t)} for n, t in ms.items()}


def trace_child(source: str, name: str, index: int) -> None:
    """Prints {kernel: device ms per call} of build ``name`` at
    TIMED[source][index], from torch.profiler over 10 calls after 3."""
    from torch.profiler import ProfilerActivity, profile
    fn = backward_fn(source, name)
    args = inputs(source, TIMED[source][index][1], 0)
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0 and e.count % 10 == 0:
            key = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
            out[key.split("(")[0]] = t / 10 / 1e3
    if not out:
        raise SystemExit("torch.profiler saw no device time")
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"))
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--trace-child", nargs=3)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if a.trace_child:
        source, name, index = a.trace_child
        trace_child(source, name, int(index))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    usage = build_all(Path(a.parent))
    print(json.dumps({"build": {f"{s} {n}": u
                                for (s, n), u in usage.items()}}), flush=True)
    for source in (FLASH, SSD):
        fns = {n: backward_fn(source, n) for (s, n) in usage if s == source}
        for i, case in enumerate(CASES[source]):
            args = inputs(source, case, i)
            base = fns["base"](*args)
            print(json.dumps({
                "source": source, "case": list(case),
                "base_vs_fp32_formula": rel(base, formula(source, args)),
                "vs_base": {n: rel(fn(*args), base)
                            for n, fn in fns.items()}}), flush=True)
        for label, shape in TIMED[source]:
            args = inputs(source, shape, 0)
            base = fns["base"](*args)
            errs = {n: rel(fn(*args), base) for n, fn in fns.items()}
            t = turns({n: (lambda fn=fn: fn(*args)) for n, fn in fns.items()})
            print(json.dumps({"source": source, "arch": label,
                              "shape": list(shape), "vs_base": errs,
                              "times": t}), flush=True)
            del args, base
            torch.cuda.empty_cache()
    if a.trace:
        for source in (FLASH, SSD):
            for index, (label, _) in enumerate(TIMED[source]):
                for name in ("parent", "base"):
                    child = subprocess.run(
                        [sys.executable, __file__, "--trace-child", source,
                         name, str(index)], capture_output=True, text=True,
                        timeout=300)
                    print(json.dumps({
                        "source": source, "arch": label, "build": name,
                        "exit": child.returncode,
                        "device_ms": (json.loads(child.stdout.splitlines()[-1])
                                      if child.returncode == 0 else None),
                        "stderr": child.stderr[-800:]}), flush=True)


if __name__ == "__main__":
    main()
