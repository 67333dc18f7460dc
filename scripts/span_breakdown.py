"""Where a traced run of one benchmark cell spends its time, by the
program's spans (``repro_torch.tracing``).

    python3 scripts/span_breakdown.py --workload <cell> [--seed N] \\
        [--seconds 51] [--out FILE]

Runs the cell as ``portbench/run.py --trace 1`` does, on one CUDA card,
and prints one JSON object (also written to FILE):

* ``step_device_s``: the device seconds launched inside the ops part's
  ``portbench.step`` spans, the base of the step shares;
* ``by_span``: that time by the innermost program range open on the
  launching thread (``harness/spans.py``), in %: ``<name>`` in the
  forward, ``<name> (recompute)`` where the range lies inside a
  backward part, ``<name>.backward``, and ``(none)`` outside every
  range; each with its five busiest kernels in seconds;
* ``decode_host_share``: for a serving cell, the share of the timeline
  part's decode spans during which the thread that ran
  ``serve.decode`` was inside each span of the in-memory record.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def innermost(chain) -> str:
    if not chain:
        return "(none)"
    name = chain[0]
    if not name.endswith(".backward") and any(
            c.endswith(".backward") for c in chain[1:]):
        return name + " (recompute)"
    return name


def by_span(trace) -> dict:
    from portbench.harness import spans as S
    step = S.in_steps(trace)
    total = S.device_s(step)
    if total <= 0:
        return {}
    time_of = collections.Counter()
    kernels = collections.defaultdict(collections.Counter)
    for a, chain in S.open_at(trace, step):
        key = innermost(chain)
        s = (a.end_ns - a.start_ns) / 1e9
        time_of[key] += s
        kernels[key][a.name[:80]] += s
    return {"step_device_s": total,
            "by_span": {k: {"share": 100.0 * v / total,
                            "kernels": kernels[k].most_common(5)}
                        for k, v in time_of.most_common()}}


def decode_host_share(run) -> dict:
    from portbench.harness import spans as S
    rec = S.program_record()
    if rec is None:
        return {}
    names = sorted({s.name for s in rec.spans()})
    out = {n: S.host_share(run, n, "portbench.decode", "serve.decode")
           for n in names}
    return {n: v for n, v in out.items() if v is not None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 4099)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench.harness import cells, manifest
    if not torch.cuda.is_available():
        raise SystemExit("span_breakdown: needs a CUDA card")
    cell = manifest.resolve(args.workload, manifest.load_manifest(ROOT))
    go = cells.train if cell.traffic["kind"] == "train" else cells.serve
    out = go(cell, args.seed, args.seconds, True, torch.device("cuda", 0),
             time.perf_counter(), None)
    line = {"workload": args.workload, "seed": args.seed}
    if out.run.ops is not None:
        line.update(by_span(out.run.ops))
    line["decode_host_share"] = decode_host_share(out.run)
    text = json.dumps(line)
    if args.out:
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
