"""Training launcher: the end-to-end driver with checkpointing, failure
injection, straggler monitoring and (optionally) a mesh, on the card
unless ``device="cpu"``.

Reduced configs by default; ``--full`` trains the assigned config, whose
weights are the port's own seeded initialization, made on the device.
With a mesh the parameters are replicated DTensors, the loader shards the
batch over the mesh's data axes, and the step runs under
``sharding.use_mesh``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --mesh 1x1
"""
from __future__ import annotations

import argparse
import contextlib
import time
from typing import Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding as shd
from repro_torch.checkpoint import (CheckpointManager, FailureInjector,
                                    run_with_restarts)
from repro_torch.configs import ArchConfig, get_arch
from repro_torch.data import ShardedLoader
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.mesh import init_local_world, make_dev_mesh
from repro_torch.models import model as M
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.train import TrainHParams, init_train_state, make_train_step


def train_loop(arch: Union[str, ArchConfig], *, steps: int = 100,
               batch: int = 8,
               seq: int = 128, full: bool = False,
               ckpt_dir: Optional[str] = None, save_every: int = 50,
               p_fail: float = 0.0, seed: int = 0,
               hp: Optional[TrainHParams] = None, log_every: int = 10,
               device: DeviceLike = None, mesh=None,
               on_step: Optional[Callable[[int, dict], None]] = None):
    """Train ``arch`` for ``steps`` steps → (state, losses). ``arch`` is a
    registered name (its ``reduced()`` config, or with ``full`` the
    assigned one) or an ``ArchConfig``, trained as it is. Without
    ``hp`` the JAX package's defaults for this loop (peak lr 1e-3, 20
    warm-up steps, no remat). Each step's time is the host clock around
    the step, read after the loss comes back to the host (a device sync).
    ``on_step(step, record)``, if given, gets each step's record: loss,
    grad_norm, lr, loss_total and seconds. ``mesh``: a ``DeviceMesh`` on
    ``device``'s type, whose ranks all run this loop with the same
    arguments."""
    dev = resolve_device(device)
    if isinstance(arch, ArchConfig):
        cfg = arch
    else:
        cfg = get_arch(arch) if full else get_arch(arch).reduced()
    hp = hp or TrainHParams(peak_lr=1e-3, warmup_steps=20, total_steps=steps,
                            grad_accum=1, remat="none")
    loader = ShardedLoader(cfg, seq, batch, mesh=mesh, seed=seed, device=dev)
    model = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    if mesh is not None:
        # every rank drew the same weights from the seed: no broadcast
        shd.distribute_model(model, mesh)
    state = init_train_state(model)
    step_fn = make_train_step(cfg, hp)

    mon = StragglerMonitor(n_hosts=1)
    losses = []

    def one_step(state, step):
        t0 = time.perf_counter()
        batch_d = loader(step)
        state, metrics = step_fn(state, batch_d)
        loss = _host(metrics["loss"])
        dt = time.perf_counter() - t0
        mon.record_step(step, [dt])
        losses.append(loss)
        if on_step is not None:
            on_step(step, {**{k: _host(metrics[k]) for k in
                              ("loss", "grad_norm", "lr", "loss_total")},
                           "seconds": dt})
        if step % log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {_host(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
        return state, {"loss": loss, "t": dt}

    with shd.use_mesh(mesh), _mixing(mesh):
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


def _host(x) -> float:
    """A metric as a Python float (a DTensor's whole value: the reduction
    of a partial one)."""
    from torch.distributed.tensor import DTensor
    return float(x.full_tensor() if isinstance(x, DTensor) else x)


def _mixing(mesh):
    """Under a mesh, plain tensors made inside the step (positions, masks,
    zeros) meet DTensors as replicated values."""
    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def parse_mesh(spec: str):
    """"DxM" → (data, model)."""
    try:
        data, model = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh wants DxM, got {spec!r}") from None
    return data, model


def main(argv=None):
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
    ap.add_argument("--mesh", default=None,
                    help="DxM: train on a (data, model) mesh; 1x1 starts a "
                         "one-rank group itself, larger meshes need a "
                         "launcher's environment (torchrun)")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        data, model = parse_mesh(args.mesh)
        dev_type = resolve_device(args.device).type
        if data * model == 1:
            init_local_world(dev_type)
        else:
            dist.init_process_group("nccl" if dev_type == "cuda" else "gloo")
        mesh = make_dev_mesh(data, model, device_type=dev_type)
    try:
        _, losses = train_loop(args.arch, steps=args.steps, batch=args.batch,
                               seq=args.seq, full=args.full,
                               ckpt_dir=args.ckpt_dir,
                               save_every=args.save_every,
                               p_fail=args.p_fail, seed=args.seed,
                               device=args.device, mesh=mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    print(f"first-10 mean loss {np.mean(losses[:10]):.4f} -> "
          f"last-10 mean loss {np.mean(losses[-10:]):.4f}")


if __name__ == "__main__":
    main()
