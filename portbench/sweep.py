"""The serving cells' rate sweep (not a benchmark run): one set-up, then
a window of about ``--seconds`` (whole blocks of the traffic's lengths)
at each rate, in requests a second:

    python3 portbench/sweep.py --workload <name> --seed <n> \\
        --seconds 30 --rates 0.1,0.2,0.3

One JSON line a rate: requests sent and their completions a second over
the window, the longest wait of a request behind its arrival, time to
first token and the gap between tokens (median and p95). The knee is the
highest rate whose waits stay under one request's service time; a cell
below it is sent at about four fifths of it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import run as RUN


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    RUN._paths()
    import torch
    from portbench.harness import cells, manifest
    from portbench.harness import stats as S
    from portbench.harness import traffic as T
    cell = manifest.resolve(args.workload, manifest.load_manifest(RUN.ROOT))
    device = torch.device("cuda", 0)
    mdl, steps = cells.serve_setup(cell, args.seed, device)
    for rate in (float(r) for r in args.rates.split(",")):
        tr = dict(cell.traffic, rate_per_s=rate)
        c = dataclasses.replace(cell, traffic=tr)
        block = tr["block"]
        seconds = math.ceil(args.seconds * rate / block) * block / rate
        reqs = T.requests(tr, args.seed, seconds)
        prompts = {r.index: T.prompt(tr, cell.config, args.seed, r, device)
                   for r in reqs}
        served, _, _ = cells.serve_window(c, mdl, steps, reqs, prompts,
                                          device, False)
        gaps = [g for x in served for g in x.gaps_s]
        ttft = [x.ttft_s for x in served]
        service = [x.done_s - x.req.arrival_s - x.wait_s for x in served]
        print(json.dumps({
            "rate_per_s": rate, "sent": len(reqs),
            "completed_per_s": len(served) / max(x.done_s for x in served),
            "service_s_mean": sum(service) / len(service),
            "wait_s_max": max(x.wait_s for x in served),
            "ttft_ms_median": 1e3 * S.median(ttft),
            "ttft_ms_p95": 1e3 * S.percentile(ttft, 95),
            "itl_ms_median": 1e3 * S.median(gaps),
            "itl_ms_p95": 1e3 * S.percentile(gaps, 95)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
