"""Tile variants of the bf16 flash attention backward kernel, on the card.

Run from the root of the checkout, on a machine with ``nvcc`` and a card:

    python3 scripts/flash_bwd_tiles.py

Each variant is ``csrc/flash_attention_bwd_sm90.cu`` with some of its tile
constants (``kBN1``, ``kStages1``, ``kStages2``) set to other values and
nothing else changed, built with ``build.NVCC_FLAGS`` into
``build/kernels/variants/`` (the unchanged source too, as ``base``). So a
variant whose code does not follow its constant shows wrong results here:
this measures what a constant buys before the code is written for it.

Prints one JSON object per line: the card's name and power limit; per
variant ptxas's largest register count and its spill bytes; per case of
CASES each variant's gradients against the base kernel's and the base's
against the formula in fp32 (max |diff| / max|g| per gradient, NaN where
a gradient is not finite); and at qwen3-1.7b's and granite-moe-1b-a400m's
training shapes each variant's time, 6 rounds of 20 launches after 5
warm-ups, the variants interleaved round by round (CUDA events, ms per
call, sorted).
"""
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.kernels.flash_attention.backward import (  # noqa: E402
    flash_attention_backward)

NAME = "flash_attention_bwd_sm90"
VARIANTS = {"base": {},
            "ring3": {"kStages1": 3, "kStages2": 3},
            "bn1_128": {"kBN1": 128},
            "bn1_128_ring3": {"kBN1": 128, "kStages2": 3}}
# (B, Sq, Skv, H, KV, d, causal)
CASES = ((1, 1100, 1300, 4, 2, 128, True), (1, 160, 96, 5, 1, 64, True),
         (2, 200, 300, 4, 2, 16, False))
TIMED = (("qwen3-1.7b", (2, 4096, 4096, 16, 8, 128, True)),
         ("granite-moe-1b-a400m", (2, 4096, 4096, 16, 8, 64, True)))


def build_variants() -> dict:
    """name → (bound library, {registers, spill_bytes}); one nvcc per
    variant, all started together."""
    src = (build.CSRC / f"{NAME}.cu").read_text()
    nvcc = build.find_nvcc()
    procs = {}
    for name, consts in VARIANTS.items():
        text = src
        for const, value in consts.items():
            text, n = re.subn(rf"constexpr int {const} = \d+;",
                              f"constexpr int {const} = {value};", text)
            assert n == 1, f"{const} not found once in {NAME}.cu"
        out = build.BUILD_DIR / "variants" / name
        out.mkdir(parents=True, exist_ok=True)
        for header in build.CSRC.glob("*.cuh"):
            shutil.copy(header, out)
        (out / f"{NAME}.cu").write_text(text)
        lib = out / f"lib{NAME}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(lib), str(out / f"{NAME}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        libs[name] = (K._bind(ctypes.CDLL(str(lib)), NAME, 9,
                              ("query", "key"), "backward"),
                      {"registers": max(regs), "spill_bytes": sum(spills)})
    return libs


def backward(lib, q, k, v, do, causal):
    """``flash_attention_backward_wgmma`` on the library ``lib``, with no
    launch counted."""
    tile = lib.flash_attention_bwd_sm90_query_tile()
    B, Sq, H, _ = q.shape
    sq_pad = -(-Sq // tile) * tile
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    stats = torch.empty((2, B, H, sq_pad), dtype=torch.float32,
                        device=q.device)
    K._launch(lib, NAME, "flash_attention_backward_wgmma",
              tuple(t.data_ptr() for t in (q, k, v, do, dq, dk, dv, stats[0],
                                           stats[1])), q, k, causal,
              entry="backward")
    return dq, dk, dv


def inputs(gen, B, Sq, Skv, H, KV, d, causal):
    dev = torch.device("cuda", 0)
    q, do = (torch.randn(B, Sq, H, d, device=dev, generator=gen)
             .to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(B, Skv, KV, d, device=dev, generator=gen)
            .to(torch.bfloat16) for _ in range(2))
    return q, k, v, do


def rel(got, want) -> list:
    """max |got - want| / max|want| per gradient; NaN if not finite."""
    return [float((a.float() - b.float()).abs().max()
                  / b.float().abs().max())
            if bool(torch.isfinite(a).all()) else math.nan
            for a, b in zip(got, want)]


def ms_per_call(fn, reps=20) -> float:
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    libs = build_variants()
    print(json.dumps({"build": {n: u for n, (_, u) in libs.items()}}),
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in CASES:
        x = inputs(gen, *case)
        base = backward(libs["base"][0], *x, case[-1])
        exact = flash_attention_backward(*(t.float() for t in x), case[-1])
        print(json.dumps({
            "case": list(case), "base_vs_fp32_formula": rel(base, exact),
            "vs_base": {n: rel(backward(lib, *x, case[-1]), base)
                        for n, (lib, _) in libs.items()}}), flush=True)
    for arch, shape in TIMED:
        x = inputs(gen, *shape)
        base = backward(libs["base"][0], *x, shape[-1])
        errs = {n: rel(backward(lib, *x, shape[-1]), base)
                for n, (lib, _) in libs.items()}
        for lib, _ in libs.values():
            ms_per_call(lambda: backward(lib, *x, shape[-1]), 5)
        ms = {n: [] for n in libs}
        for _ in range(6):
            for n, (lib, _) in libs.items():
                ms[n].append(ms_per_call(
                    lambda: backward(lib, *x, shape[-1])))
        print(json.dumps({"arch": arch, "shape": list(shape),
                          "vs_base": errs,
                          "ms": {n: sorted(t) for n, t in ms.items()}}),
              flush=True)


if __name__ == "__main__":
    main()
