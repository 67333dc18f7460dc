"""The readings that a cell's limits are set from, on the chip at the
cell's own size (not a benchmark run):

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds S]

For each seed, one JSON line: the program's readings against the
reference (the lower reading is their largest over the seeds); for the
control seeds, each control's (the reference in the program's place in
fp8, e4m3 and e5m2: the upper reading is the smallest over both
formats and the seeds); for the fault seeds, each
fault's that needs a run (``harness/faults.py``). Training reads the
first three steps only; serving runs a window of ``--seconds`` (long
enough to finish the requests a run compares) and reads the program's
served tokens and the control's picks at the same positions.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import run as RUN


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    RUN._paths()
    import torch
    from portbench.harness import cells, compare, faults, manifest
    cell = manifest.resolve(args.workload, manifest.load_manifest(RUN.ROOT))
    device = torch.device(args.device)
    for seed in sorted(set(args.seeds) | set(args.control_seeds)
                       | set(args.fault_seeds)):
        t = time.perf_counter()
        line = {"seed": seed}
        if cell.traffic["kind"] == "train":
            ref = compare.reference_train(cell.config, cell.traffic, seed,
                                          device)
            runs = {}
            if seed in args.seeds:
                runs["program"] = None
            if seed in args.fault_seeds:
                runs["half_batch"] = faults.train_half_batch
            order = compare.names(cell.config)
            for name, wrap in runs.items():
                _, _, got = cells.first_steps(cell, seed, device, wrap)
                cells._free(device)
                line[name] = compare.train_readings(got, ref)
                line[name]["worst"] = compare.worst_leaves(got, ref, order)
            for p in compare.CONTROLS if seed in args.control_seeds else ():
                low = compare.reference_train(cell.config, cell.traffic, seed,
                                              device, precision=p)
                line.setdefault("control", {})[p] = \
                    compare.train_readings(low, ref)
                line["control"][p]["worst"] = compare.worst_leaves(low, ref,
                                                                   order)
                del low
        else:
            ctl = compare.CONTROLS if seed in args.control_seeds else ()
            out = cells.serve(cell, seed, args.seconds, False, device,
                              time.perf_counter(), controls=ctl)
            r = out.readings
            line["program"] = {k: r[k] for k in ("logit_gap",
                                                 "logit_gap_mean")}
            if "control" in r:
                line["control"] = r["control"]
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        cells._free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
