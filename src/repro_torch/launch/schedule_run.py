"""The full JITA-4DS loop on real (reduced) jobs: the VoS scheduler
composes VDCs (here: job slots on the card), launches actual training
jobs per assignment, earns value on completion — the end-to-end
integration of core/ with the training substrate.

  PYTHONPATH=src python -m repro_torch.launch.schedule_run --jobs 6 \\
      --heuristic VPTR [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.costmodel import CostModel
from repro_torch.core.heuristics import HEURISTICS
from repro_torch.core.simulator import Simulator
from repro_torch.core.tasks import PAPER_REGIME, TaskType, WorkloadGenerator
from repro_torch.launch.train import train_loop

EDGE_ARCHS = ["smollm-135m", "qwen3-1.7b", "mamba2-1.3b"]


def plan(jobs: int, heuristic: str = "VPTR"):
    """The scheduler's plan for ``jobs`` train_4k jobs of EDGE_ARCHS under
    the analytic cost model → (SimResult, its ``[plan]`` line)."""
    cost = CostModel.analytic()
    types = [TaskType(a, "train_4k") for a in EDGE_ARCHS]
    gen = WorkloadGenerator(types, cost, seed=0, **PAPER_REGIME)
    trace = gen.trace(jobs)
    result = Simulator(HEURISTICS[heuristic], cost).run([t for t in trace])
    return result, (f"[plan] {heuristic}: VoS={result.vos:.1f} "
                    f"completed={result.completed}/{jobs}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--heuristic", default="VPTR", choices=sorted(HEURISTICS))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    result, line = plan(args.jobs, args.heuristic)
    print(line)

    # execute the planned jobs for real (reduced configs)
    for task in result.tasks:
        if task.start is None:
            print(f"  job {task.tid} ({task.ttype.name}): not scheduled")
            continue
        t0 = time.perf_counter()
        _, losses = train_loop(task.ttype.arch, steps=args.steps, batch=2,
                               seq=64, log_every=10**9, device=args.device)
        dt = time.perf_counter() - t0
        print(f"  job {task.tid} ({task.ttype.arch:14s}): "
              f"planned {task.chips} chips f={task.dvfs_f:.1f} "
              f"V̂={task.earned:.2f} | ran {args.steps} real steps in "
              f"{dt:.1f}s loss {losses[0]:.3f}->{losses[-1]:.3f}")


if __name__ == "__main__":
    main()
