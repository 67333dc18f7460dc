"""What ``repro_torch.tracing`` costs on the host's clock: the median
train step of the benchmark's ``mamba2-1.3b.train_4k`` cell and the
median decode step of its ``granite-moe-1b-a400m.chat`` cell, at full
size on one card, in five modes: ``off``; ``on`` (``tracing.enable()``);
``prof``, under a CUDA-only ``torch.profiler`` as the benchmark's
timeline part runs, which turns the spans and their profiler ranges on;
``prof_untraced``, the same profiler with the spans held off;
``prof_unmirrored``, the same profiler with the spans on by
``enable()`` but hidden from the profiler's flag, so that they open no
profiler range. A checkout older than its spans has ``off`` and
``prof`` alone. On a checkout whose train step replays a CUDA graph
while tracing is off, and runs op by op while it is on, the train
cell's ``off`` steps that follow a traced step capture the graph again:
its train numbers then time capture and replay against steps op by op,
not the spans' cost; the decode cell's are unchanged.

Run on a machine with a card, from any directory:

    python3 scripts/tracing_cost.py [--root DIR] [--steps 12] [--rounds 3]

DIR (default: the checkout holding this script) is the checkout whose
program and benchmark (``portbench``) are imported, so that one copy of
this script times two commits in turns, each in a process of its own.
The cells are set up as ``portbench`` sets them up (weights and inputs
from ``--seed``); the train cell's three warm-up steps, and the decode
cell's prefill at its longest prompt and one decode step, are not
timed. Then ``--rounds`` rounds of two blocks, one without the profiler
(``off``, ``on``) and one inside one profiler session
(``prof_untraced``, ``prof_unmirrored``, ``prof``), the blocks' order
swapped from one round to the next; a block runs ``--steps`` steps of each of its modes, the modes
taking turns step by step, so that the host's drift reaches both alike.
A train step is timed to its loss on the host, a decode step to its
token on the host; every decode step writes and reads the same
position, so that each does the same work however many are timed.
Prints one JSON line: the card, the modes' step seconds and medians,
the median of the paired differences (each mode less the block's first
mode in the same turn) in % of the first mode's median, and the spans
one step records with tracing on.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

TRAIN, CHAT = "mamba2-1.3b.train_4k", "granite-moe-1b-a400m.chat"
BLOCKS = (("off", "on"), ("prof_untraced", "prof_unmirrored", "prof"))


def blocks(tracing, rnd: int):
    order = BLOCKS if rnd % 2 == 0 else BLOCKS[::-1]
    return order if tracing is not None else [("off",), ("prof",)][
        ::1 if rnd % 2 == 0 else -1]


@contextlib.contextmanager
def profiled(on: bool):
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        yield


def switch(tracing, flag, mode: str) -> None:
    """The spans as ``mode`` has them for the next step: on after
    ``enable()`` in ``on`` and ``prof_unmirrored``, on through the
    profiler's flag in ``prof``, off in ``off`` and ``prof_untraced``;
    the profiler's flag hidden from them in the last two ``prof``
    modes."""
    if tracing is None:
        return
    (tracing.enable if mode in ("on", "prof_unmirrored")
     else tracing.disable)()
    hidden = mode in ("prof_untraced", "prof_unmirrored")
    tracing._profiling = (lambda: False) if hidden else flag


def timed(one_step, tracing, steps: int, rounds: int) -> dict:
    """Runs ``one_step`` (which waits for its result on the host) in
    every mode → {"step_s": {mode: [s]}, "median_s", "paired_pct",
    "spans_a_step"}."""
    flag = tracing._profiling if tracing is not None else None
    out, pairs = {}, {}
    try:
        for rnd in range(rounds):
            for block in blocks(tracing, rnd):
                with profiled(block[-1] == "prof"):
                    for j in range(steps * len(block)):
                        mode = block[j % len(block)]
                        switch(tracing, flag, mode)
                        s = time.perf_counter()
                        one_step()
                        out.setdefault(mode, []).append(
                            time.perf_counter() - s)
                        if tracing is not None:
                            tracing.reset()
                        if j % len(block):
                            pairs.setdefault((block[0], mode), []).append(
                                out[mode][-1] - out[block[0]][-1])
        spans = None
        if tracing is not None:
            switch(tracing, flag, "on")
            one_step()
            spans = len(tracing.spans())
    finally:
        switch(tracing, flag, "off")
        if tracing is not None:
            tracing.reset()
    med = {k: statistics.median(v) for k, v in out.items()}
    return {"step_s": out, "median_s": med,
            "paired_pct": {f"{b} over {a}": 100 * statistics.median(v)
                           / med[a] for (a, b), v in pairs.items()},
            "spans_a_step": spans}


def train_cost(manifest, cells, T, tracing, seed, steps, rounds, dev):
    import torch
    cell = manifest.resolve(TRAIN, manifest.load_manifest())
    step, state, _ = cells.first_steps(cell, seed, dev)
    at = {"state": state, "i": 3}

    def one_step():
        at["state"], m = step(at["state"], T.train_batch(
            cell.traffic, cell.config, seed, at["i"], dev))
        float(m["loss"])
        at["i"] += 1

    out = timed(one_step, tracing, steps, rounds)
    del at, state, step
    torch.cuda.empty_cache()
    return out


def decode_cost(manifest, cells, T, tracing, seed, steps, rounds, dev):
    import torch
    cell = manifest.resolve(CHAT, manifest.load_manifest())
    mdl, pairs = cells.serve_setup(cell, seed, dev)
    L = max(pairs)
    prefill, decode = pairs[L]
    prompt = torch.randint(0, cell.config["vocab_size"],
                           (cell.traffic["batch"], L), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed))
    logits, cache = prefill(mdl, {"tokens": prompt})
    at = {"tok": logits.argmax(-1)[:, None], "cache": cache}

    def one_step():
        logits, at["cache"] = decode(mdl, at["cache"], at["tok"], L)
        at["tok"] = logits.argmax(-1)[:, None]
        at["tok"].cpu()

    one_step()
    return timed(one_step, tracing, steps, rounds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--seed", type=int, default=2**31 + 4099)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    from portbench.harness import cells, manifest
    from portbench.harness import traffic as T
    try:
        from repro_torch import tracing
    except ImportError:            # a checkout older than its spans
        tracing = None
    if not torch.cuda.is_available():
        raise SystemExit("tracing_cost: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    line = {"root": str(root), "card": card, "tracing": tracing is not None}
    line["train"] = train_cost(manifest, cells, T, tracing, args.seed,
                               args.steps, args.rounds, dev)
    line["decode"] = decode_cost(manifest, cells, T, tracing, args.seed,
                                 args.steps, args.rounds, dev)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
