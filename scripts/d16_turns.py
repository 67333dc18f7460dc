"""The fp32 flash kernel at head dim 16 (``csrc/flash_d16.cuh``, built into
``csrc/flash_attention_sm90_f32.cu``) on the card, against the parent
commit's and against variants of its source, checked and timed in turns.

Run from the root of a checkout, on a machine with ``nvcc`` and a card:

    python3 scripts/d16_turns.py [--parent DIR] [--trace]

DIR (default ``build/parent``) is a checkout of the commit to compare with,
unpacked there beforehand, e.g. ``git archive HEAD~1 | tar -x -C
build/parent``. Its ``flash_attention_sm90_f32.cu`` and headers are built as
``parent``, this checkout's as ``base`` and, with the edits of one entry
of VARIANTS made to ``flash_d16.cuh`` and nothing else changed, as that
entry (each edit a regular expression that must match exactly once and
its replacement; a throwaway script may set VARIANTS and call
``main``). Every build goes into ``build/kernels/turns/d16/<build>/`` with
``build.NVCC_FLAGS``, one nvcc each, all started together.

Prints one JSON object per line: the card's name and power limit; per build
ptxas's registers and spill bytes of the d 16 kernel; per case of CASES
each build's max |kernel - plain| (``attention_reference`` in fp32),
whether a rerun is bit-identical, whether the rows that see no key are 0,
and whether it equals the base bit for bit; at the TIMED shapes each
build's time and SDPA's: 5 warm-ups of each, then 5 rounds of one batch of
20 launches of every one in turn (CUDA events), the median batch's ms per
call, the batches and their spread, beside the bound. With ``--trace``, the
device ms per call of each build and of SDPA at the TIMED shapes, from
torch.profiler over 50 calls, each in a process of its own
(``--trace-child``), the builds in the order parent, base, variants,
variants reversed, base, parent.
"""
import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_reference)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_flops)

sys.path.insert(0, str(ROOT / "scripts"))
from bwd_turns import turns  # noqa: E402

SOURCE, HEADER = "flash_attention_sm90_f32", "flash_d16.cuh"
# one warp per 16 query rows (kKeySplit 1): 4 warps and 64 queries a CTA,
# or 2 warps and 32
VARIANTS = {"rows64": [(r"constexpr int kKeySplit = \d+;",
                        "constexpr int kKeySplit = 1;")],
            "rows32": [(r"constexpr int kKeySplit = \d+;",
                        "constexpr int kKeySplit = 1;"),
                       (r"constexpr int kWarps = \d+;",
                        "constexpr int kWarps = 2;")]}
# (B, Sq, Skv, H, KV, d, causal): the card tests' d 16 cases, then the
# shapes timed
CASES = ((8, 128, 128, 4, 2, 16, True), (2, 200, 200, 4, 1, 16, True),
         (1, 96, 160, 4, 2, 16, False), (1, 160, 96, 2, 2, 16, True),
         (1, 64, 64, 3, 3, 16, False), (2, 1000, 1000, 4, 2, 16, True))
TIMED = (("smollm-135m reduced train", (8, 128, 128, 4, 2, 16, True)),
         ("off-path", (8, 2048, 2048, 4, 2, 16, True)))
HBM_BYTES_PER_S, TF32_OPS_PER_S = 3.35e12, 495e12


def build_dir(name: str) -> Path:
    return build.BUILD_DIR / "turns" / "d16" / name


def build_all(parent: Path) -> dict:
    """build → ptxas's {registers, spill_bytes} of the d 16 kernel; one
    nvcc per build, all started together."""
    csrc = {"parent": parent / "src/repro_torch/kernels/csrc",
            "base": build.CSRC}
    headers = {n: {p.name: p.read_text() for p in d.glob("*.cuh")}
               for n, d in csrc.items()}
    sources = {n: (d / f"{SOURCE}.cu").read_text() for n, d in csrc.items()}
    for name, edits in VARIANTS.items():
        text = headers["base"][HEADER]
        for pattern, replacement in edits:
            text, k = re.subn(pattern, lambda _: replacement, text)
            assert k == 1, f"{pattern!r} not found once in {HEADER}"
        headers[name] = {**headers["base"], HEADER: text}
        sources[name] = sources["base"]
    procs = {}
    for name, text in sources.items():
        out = build_dir(name)
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        for header, body in headers[name].items():
            (out / header).write_text(body)
        (out / f"{SOURCE}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o",
             str(out / f"lib{SOURCE}.so"), str(out / f"{SOURCE}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    usage = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        # the d 16 kernel's part of the report
        part = log[log.index("flash_forward_d16"):]
        part = part.split("Compiling entry function", 1)[0]
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                           r"loads", part)
        usage[name] = {
            "registers": int(re.search(r"Used (\d+) registers",
                                       part).group(1)),
            "spill_bytes": int(spills.group(1)) + int(spills.group(2))}
    return usage


def forward_fn(name: str):
    """The d 16 forward of build ``name`` as a function of (q, k, v,
    causal), counting no launch."""
    lib = ctypes.CDLL(str(build_dir(name) / f"lib{SOURCE}.so"))
    FK._bind(lib, SOURCE, 8, ("query", "key"))

    def run(q, k, v, causal):
        out = torch.empty_like(q)
        FK._launch(lib, SOURCE, "flash_attention_d16",
                   (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr()) + (None,) * 4, q, k, causal)
        return out
    return run


def sdpa(q, k, v, causal):
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=True)


def inputs(shape, seed: int) -> tuple:
    """Seeded fp32 q, k, v on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    B, Sq, Skv, H, KV, d, _ = shape
    return tuple(torch.randn(s, device="cuda", generator=gen)
                 for s in ((B, Sq, H, d), (B, Skv, KV, d), (B, Skv, KV, d)))


def bound(shape) -> dict:
    """The least time: q, k, v, o once over HBM, or the kept pairs' flops
    three times over (3xTF32) at the tf32 peak, the larger."""
    B, Sq, Skv, H, KV, d, causal = shape
    nbytes = 4 * d * (2 * B * Sq * H + 2 * B * Skv * KV)
    flops = flash_attention_flops((B, Sq, H, d), (B, Skv, KV, d), causal)
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = 3 * flops / TF32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations_3xtf32",
            "bytes": nbytes, "flops": flops}


def trace_child(name: str, index: int) -> None:
    """Prints {kernel: device ms per call} of build ``name`` (or SDPA) at
    TIMED[index], from torch.profiler over 50 calls after 3: the mean of
    the launches seen times the launches a call."""
    from torch.profiler import ProfilerActivity, profile
    fn = sdpa if name == "sdpa" else forward_fn(name)
    shape = TIMED[index][1]
    q, k, v = inputs(shape, 0)
    for _ in range(3):
        fn(q, k, v, shape[-1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            fn(q, k, v, shape[-1])
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        # a trace may drop a launch or two; the profiler's own set-up
        # shows as an entry seen once
        per_call = round(e.count / 50)
        if t > 0 and per_call >= 1:
            key = re.sub(r"^void |\(anonymous namespace\)::", "", e.key)
            out[key.split("(")[0]] = t / e.count * per_call / 1e3
    if not out:
        raise SystemExit("torch.profiler saw no device time")
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"))
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--trace-child", nargs=2)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if a.trace_child:
        trace_child(a.trace_child[0], int(a.trace_child[1]))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    usage = build_all(Path(a.parent))
    print(json.dumps({"build": usage}), flush=True)
    fns = {n: forward_fn(n) for n in usage}
    for i, case in enumerate(CASES):
        q, k, v = inputs(case, i)
        causal = case[-1]
        ref = attention_reference(q, k, v, causal=causal)
        base = fns["base"](q, k, v, causal)
        row = {"case": list(case)}
        for n, fn in fns.items():
            out = fn(q, k, v, causal)
            again = fn(q, k, v, causal)
            dead = case[1] - case[2] if causal and case[1] > case[2] else 0
            row[n] = {"max_abs_err": float((out - ref).abs().max()),
                      "rerun_bit_identical": torch.equal(
                          out.view(torch.int32), again.view(torch.int32)),
                      "rows_without_keys_zero": not bool(
                          out[:, :dead].any()),
                      "equals_base": torch.equal(out.view(torch.int32),
                                                 base.view(torch.int32))}
        print(json.dumps(row), flush=True)
    for label, shape in TIMED:
        q, k, v = inputs(shape, 0)
        causal = shape[-1]
        calls = {n: (lambda fn=fn: fn(q, k, v, causal))
                 for n, fn in fns.items()}
        calls["sdpa"] = lambda: sdpa(q, k, v, causal)
        print(json.dumps({"shape_name": label, "shape": list(shape),
                          **bound(shape), "times": turns(calls)}),
              flush=True)
    if a.trace:
        order = ["parent", "base", *VARIANTS, *reversed(VARIANTS), "base",
                 "parent", "sdpa"]
        for index, (label, _) in enumerate(TIMED):
            for name in order:
                child = subprocess.run(
                    [sys.executable, __file__, "--trace-child", name,
                     str(index)], capture_output=True, text=True,
                    timeout=300)
                print(json.dumps({
                    "shape_name": label, "build": name,
                    "exit": child.returncode,
                    "device_ms": (json.loads(child.stdout.splitlines()[-1])
                                  if child.returncode == 0 else None),
                    "stderr": child.stderr[-800:]}), flush=True)


if __name__ == "__main__":
    main()
