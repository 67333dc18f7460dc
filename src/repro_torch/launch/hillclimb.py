"""Perf hillclimbing driver: re-run a dry-run cell under candidate
changes (sharding rules, mesh geometry, accumulation, serve profile) and
report the roofline terms. Its bytes, and so t_memory and a "memory"
bottleneck, are the dry-run's upper estimate (``dryrun.BYTES_NOTE``):
t_compute and t_collective do not rest on it.

The port of the JAX package's ``launch/hillclimb.py``, over the port's
dry-run (``launch.dryrun``): a mesh is a fake world's, built here.

  python -m repro_torch.launch.hillclimb --arch smollm-135m \\
      --shape train_4k --mesh 4x4 --accum 1
"""
from __future__ import annotations

import argparse
import contextlib
import json
from typing import Dict, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch import roofline as RL
from repro_torch import sharding as shd
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import dryrun as DR
from repro_torch.train import TrainHParams


def make_mesh(spec: str):
    """A mesh over a fake world of its size: "16" is ("model",), "4x4"
    ("data", "model"), "2x4x4" ("pod", "data", "model")."""
    dims = [int(x) for x in spec.split("x")]
    names = {1: ("model",), 2: ("data", "model"),
             3: ("pod", "data", "model")}[len(dims)]
    size = 1
    for d in dims:
        size *= d
    DR.ensure_fake_world(size)
    return init_device_mesh("cpu", tuple(dims), mesh_dim_names=names)


@contextlib.contextmanager
def rule_override(profile: str, **updates):
    """Temporarily rewrite logical-axis rules, e.g. heads=('data','model')."""
    rules = shd.PROFILES[profile]
    saved = dict(rules)
    rules.update({k: tuple(v) if isinstance(v, (list, tuple)) else (v,)
                  for k, v in updates.items()})
    try:
        yield
    finally:
        rules.clear()
        rules.update(saved)


def run_variant(arch: str, shape_name: str, *, mesh_spec: str = "16x16",
                accum: Optional[int] = None,
                rules: Optional[Dict] = None, profile: str = "train",
                label: str = "variant", verbose: bool = True, **hp_kwargs):
    """The cell's report under the variant: one dry run gives its costs
    and its memory (the JAX package compiles twice for them)."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    mesh = make_mesh(mesh_spec)
    hp = None
    if shape.kind == "train":
        hp_accum = accum if accum is not None else cfg.grad_accum
        hp = TrainHParams(grad_accum=hp_accum, **hp_kwargs)
    ctx = rule_override(profile, **rules) if rules else contextlib.nullcontext()
    with ctx:
        run = DR.lower_cell(cfg, shape, mesh, verbose=verbose, hp=hp)
    rep = RL.analyze(run, cfg, shape, mesh_spec, mesh.size(),
                     note=f"{label} ({DR.BYTES_NOTE})")
    if verbose:
        print(f"[{label}] {arch}×{shape_name} @{mesh_spec}: "
              f"t_comp={rep.t_compute:.4f} t_mem={rep.t_memory:.4f} "
              f"t_coll={rep.t_collective:.4f} -> {rep.bottleneck}; "
              f"frac={rep.roofline_fraction:.2%} "
              f"HBM={(rep.arg_bytes+rep.temp_bytes)/2**30:.1f}GiB "
              f"({DR.BYTES_NOTE})")
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--label", default="variant")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    try:
        rep = run_variant(args.arch, args.shape, mesh_spec=args.mesh,
                          accum=args.accum, label=args.label)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep.to_dict(), f, indent=1)


if __name__ == "__main__":
    main()
