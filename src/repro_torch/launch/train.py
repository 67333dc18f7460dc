"""Training launcher: the end-to-end driver with checkpointing, failure
injection and straggler monitoring, on the card unless ``device="cpu"``.

Reduced configs by default; ``--full`` trains the assigned config, whose
weights are the port's own seeded initialization, made on the device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (CheckpointManager, FailureInjector,
                                    run_with_restarts)
from repro_torch.configs import get_arch
from repro_torch.data import ShardedLoader
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train import TrainHParams, init_train_state, make_train_step


def train_loop(arch: str, *, steps: int = 100, batch: int = 8,
               seq: int = 128, full: bool = False,
               ckpt_dir: Optional[str] = None, save_every: int = 50,
               p_fail: float = 0.0, seed: int = 0,
               hp: Optional[TrainHParams] = None, log_every: int = 10,
               device: DeviceLike = None,
               on_step: Optional[Callable[[int, dict], None]] = None):
    """Train ``arch`` for ``steps`` steps → (state, losses). Without
    ``hp`` the JAX package's defaults for this loop (peak lr 1e-3, 20
    warm-up steps, no remat). Each step's time is the host clock around
    the step, read after the loss comes back to the host (a device sync).
    ``on_step(step, record)``, if given, gets each step's record: loss,
    grad_norm, lr, loss_total and seconds."""
    dev = resolve_device(device)
    cfg = get_arch(arch) if full else get_arch(arch).reduced()
    hp = hp or TrainHParams(peak_lr=1e-3, warmup_steps=20, total_steps=steps,
                            grad_accum=1, remat="none")
    loader = ShardedLoader(cfg, seq, batch, seed=seed, device=dev)
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    state = init_train_state(model)
    step_fn = make_train_step(cfg, hp)

    mon = StragglerMonitor(n_hosts=1)
    losses = []

    def one_step(state, step):
        t0 = time.perf_counter()
        batch_d = loader(step)
        state, metrics = step_fn(state, batch_d)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        mon.record_step(step, [dt])
        losses.append(loss)
        if on_step is not None:
            on_step(step, {**{k: float(metrics[k]) for k in
                              ("loss", "grad_norm", "lr", "loss_total")},
                           "seconds": dt})
        if step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        return state, {"loss": loss, "t": dt}

    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, save_every=save_every)
        inj = FailureInjector(p_fail=p_fail, seed=seed)
        state, history, restarts = run_with_restarts(
            init_state=state, train_one_step=one_step, ckpt_manager=mgr,
            n_steps=steps, injector=inj)
        print(f"done: {len(history)} step records, {restarts} restarts")
    else:
        for step in range(steps):
            state, _ = one_step(state, step)
    return state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--p-fail", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    _, losses = train_loop(args.arch, steps=args.steps, batch=args.batch,
                           seq=args.seq, full=args.full,
                           ckpt_dir=args.ckpt_dir,
                           save_every=args.save_every, p_fail=args.p_fail,
                           seed=args.seed, device=args.device)
    print(f"first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean loss {np.mean(losses[-10:]):.4f}")


if __name__ == "__main__":
    main()
