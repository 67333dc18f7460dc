"""Multi-pod dry-run: run every (arch × shape) cell on the production
meshes without a device, and emit per-device costs, memory and roofline
reports.

The port of the JAX package's ``launch/dryrun.py``. Where the reference
lowers and compiles each cell for 256 or 512 fake XLA devices, the port
starts a fake process group of that many ranks (``launch.mesh
.init_fake_world``) and runs the cell's step once, as rank 0, under
``FakeTensorMode``: the parameters are DTensors placed by ``specs``, the
ops run on fake local shards, and the collectives DTensor places are
recorded, not sent. ``CostCounter``, a dispatch mode, reads the run:

- the FLOPs of each local op (``FlopCounterMode``'s formulas, the custom
  ops' own), its operand and result bytes, and each collective's kind,
  count and ring-model bytes under the keys of
  ``utils.hlo.CollectiveStats``. It counts only ops on plain (local)
  tensors: an op on DTensors is passed on to DTensor, whose local op it
  then sees, so nothing is counted twice;
- the peak of the local storages alive (the state and inputs, and every
  op's results until they are freed), the counterpart of
  ``memory_analysis()``. ``torch.distributed._tools.mem_tracker``'s
  ``MemTracker`` does the same but refuses a module called twice in one
  step, which remat's recompute and the microbatches do.

Costs are per device, as XLA's ``cost_analysis`` is. The bytes are an
upper estimate beside XLA's fused count (every op reads and writes its
operands); the FLOPs count matrix products and the custom ops, not
elementwise work. Fake execution runs every layer, so ``extrapolated_costs``
runs the cell at full depth: the reference's r=1/r=2 variants exist
because XLA's cost analysis counts a scanned loop's body once.

The simulated DC of the roofline is the TPU-v5e pod of ``hardware.py``:
these are the model's terms, not times of the card.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod both --out DIR
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch import roofline as RL
from repro_torch import sharding as shd
from repro_torch.configs import (SHAPES, ArchConfig, ShapeSpec, get_arch,
                                 list_archs, supports_shape)
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.models import model as M
from repro_torch.train import TrainHParams, init_train_state, make_train_step
from repro_torch.utils.hlo import CollectiveStats

TRAIN_ACCUM = 4
# CostCounter's bytes are an upper estimate (every op reads and writes its
# operands; 1.44-2.07x XLA's fused count on tests/test_torch_dryrun.py's
# cells), so t_memory is high, and a "memory" bottleneck and the
# roofline_fraction it sets may be the estimate's, not the program's
BYTES_NOTE = ("bytes are an upper estimate: t_memory, the bottleneck and "
              "roofline_fraction follow it")

# torch's functional collectives → the HLO collective kinds
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _group_size(func, args) -> int:
    """The collective's group size: its ``group_size`` argument, else the
    size of the group its name resolves to."""
    for a in func._schema.arguments:
        if a.name == "group_size":
            return int(args[[x.name for x in func._schema.arguments]
                            .index("group_size")])
    name = args[[x.name for x in func._schema.arguments].index("group_name")]
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Per-device FLOPs, bytes and collectives of the local ops run under
    it, and the peak of the local storages alive (see the module's
    docstring). ``track`` adds tensors made before it (the parameters,
    the optimizer's state, the inputs) to the live set."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.counts = {k: 0 for k in set(_COLLECTIVES.values())}
        self.bytes_by_kind = {k: 0.0 for k in self.counts}
        self.live = 0
        self.peak = 0
        self._storages = {}
        self._paused = 0

    @contextlib.contextmanager
    def over_local_ops(self):
        """Count under this mode, except inside DTensor's sharding
        propagation: it runs each new op once on fake tensors of the
        global shapes to learn its output's shape, and prices placements
        with small helper tensors, none of it a device's work. The
        propagation runs with the fake mode lifted, so that those helper
        tensors hold values (a private hook of torch, on the propagation
        and on the index arithmetic of a strided shard, which runs on
        helper tensors too; the ops' sharding rules take another, see
        ``kernels.sharding_rules``)."""
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor._sharding_prop import (
            ShardingPropagator)
        from torch.distributed.tensor.placement_types import _StridedShard
        hooks = [(ShardingPropagator, "propagate_op_sharding_non_cached"),
                 (_StridedShard, "local_shard_size_and_offset")]
        saved = [getattr(cls, name) for cls, name in hooks]

        def lifted(fn):
            def run(*args, **kwargs):
                self._paused += 1
                try:
                    with unset_fake_temporarily():
                        return fn(*args, **kwargs)
                finally:
                    self._paused -= 1
            return run
        for (cls, name), fn in zip(hooks, saved):
            setattr(cls, name, lifted(fn))
        try:
            with self:
                yield self
        finally:
            for (cls, name), fn in zip(hooks, saved):
                setattr(cls, name, fn)

    def track(self, *tensors) -> None:
        """Count each tensor's local storage as alive until it is freed."""
        from torch.distributed.tensor import DTensor
        for t in tensors:
            if isinstance(t, DTensor):
                t = t.to_local()
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()

            def freed(_, key=key, n=n):
                if self._storages.pop(key, None) is not None:
                    self.live -= n
            self._storages[key] = weakref.ref(st, freed)
            self.live += n
            self.peak = max(self.peak, self.live)

    @property
    def collectives(self) -> CollectiveStats:
        return CollectiveStats(counts=dict(self.counts),
                               bytes_by_kind=dict(self.bytes_by_kind))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented          # DTensor runs the local ops
        out = func(*args, **kwargs)
        if self._paused:
            return out
        self.track(*tree_flatten(out)[0])
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in ("_c10d_functional", "c10d_functional") and \
                name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            g = _group_size(func, args)
            frac = (g - 1) / g if g > 0 else 1.0
            size = sum(_nbytes(t) for t in tree_flatten(out)[0]
                       if isinstance(t, torch.Tensor))
            if kind == "reduce-scatter":
                size = sum(_nbytes(t) for t in flat
                           if isinstance(t, torch.Tensor))
            self.counts[kind] += 1
            self.bytes_by_kind[kind] += (2 * size * frac if kind ==
                                         "all-reduce" else size * frac)
            return out
        if ns in ("_c10d_functional", "c10d_functional", "c10d") or \
                func.is_view:
            return out
        pkt = func._overloadpacket
        if pkt in flop_registry:
            shape = tree_map(lambda x: x.shape if isinstance(
                x, torch.Tensor) else x, (args, kwargs, out))
            self.flops += flop_registry[pkt](*shape[0], **shape[1],
                                             out_val=shape[2])
        self.bytes += sum(_nbytes(t) for t in flat + tree_flatten(out)[0]
                          if isinstance(t, torch.Tensor))
        return out


@dataclasses.dataclass
class CellRun:
    """What one dry run of a cell measured, per device."""
    flops: float
    bytes: float
    collectives: CollectiveStats
    arg_bytes: int          # parameters, optimizer state, inputs
    temp_bytes: int         # the peak beyond them
    out_bytes: int          # results that are new tensors
    seconds: float          # the dry run's host wall time

    @property
    def peak_bytes(self) -> int:
        return self.arg_bytes + self.temp_bytes


def ensure_fake_world(n: int) -> None:
    """A fake world of ``n`` ranks (a running one of another size is
    ended first)."""
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    init_fake_world(n)


def _local_storages(tree):
    """{storage pointer: bytes} of the local tensors in ``tree``."""
    from torch.distributed.tensor import DTensor
    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def _distribute(tree, shardings):
    """Place a dict (or list of dicts) of tensors by their (mesh,
    placements), each rank keeping its chunk."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, list):
        return [_distribute(t, s) for t, s in zip(tree, shardings)]
    return {k: distribute_tensor(v, *shardings[k], src_data_rank=None)
            for k, v in tree.items()}


def _model(cfg: ArchConfig, mesh, profile: str, dtype) -> M.LM:
    """The fake model of ``cfg`` in ``dtype``, its parameters placed by
    ``profile``."""
    model = SP.fake_model(cfg)
    pl = shd.build_param_placements(
        mesh, M.param_axes(cfg),
        {k: p.shape for k, p in model.named_parameters()}, profile)
    return shd.distribute_model(model, mesh, pl, dtype=dtype)


def lower_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
               grad_accum: int = TRAIN_ACCUM, verbose: bool = True,
               hp: Optional[TrainHParams] = None) -> CellRun:
    """Run one (arch × shape) cell on ``mesh`` (a mesh over a fake world)
    under ``FakeTensorMode`` → its per-device ``CellRun``; every layer
    runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    if hp is None:
        accum = cfg.grad_accum if grad_accum == TRAIN_ACCUM else grad_accum
        hp = TrainHParams(grad_accum=accum if shape.kind == "train" else 1)
    if shape.kind == "train" and hp.grad_accum > 1:
        width = 1
        for a in ("pod", "data"):
            if a in mesh.mesh_dim_names:
                width *= mesh.size(mesh.mesh_dim_names.index(a))
        micro = shape.global_batch // hp.grad_accum
        if micro % width and width % micro:
            print(f"  WARNING: microbatch {micro} vs batch-shard width "
                  f"{width}: compute will replicate (fix grad_accum)")
    B = shape.global_batch
    t0 = time.perf_counter()
    with FakeTensorMode(), shd.use_mesh(mesh):
        batch = _distribute(SP.batch_specs(cfg, shape, device="cpu"),
                            SP.batch_shardings(mesh, cfg, shape))
        if shape.kind == "train":
            model = _model(cfg, mesh, "train", torch.float32)
            state = init_train_state(model)
            step = make_train_step(cfg, hp)
            external = [*state.opt.mu.values(), *state.opt.nu.values(),
                        *batch.values()]

            def run():
                return step(state, batch)
        elif shape.kind == "prefill":
            model = _model(cfg, mesh, "serve", torch.bfloat16)
            external = [*batch.values()]
            cache_sh = SP.cache_shardings(mesh, cfg, B)

            def run():
                logits, cache = M.prefill(cfg, model, batch, shape.seq_len)
                b_ax = shd.batch_axes_for(mesh, B)
                logits = shd.act_constraint(logits, shd.P(b_ax, "model"))
                cache = [{k: v.redistribute(*cs[k]) for k, v in c.items()}
                         for c, cs in zip(cache, cache_sh)]
                return logits, cache
        else:  # decode
            long_ctx = B == 1
            model = _model(cfg, mesh, "serve_long" if long_ctx else "serve",
                           torch.bfloat16)
            cache = _distribute(
                SP.cache_sds(cfg, B, shape.seq_len, device="cpu"),
                SP.cache_shardings(mesh, cfg, B, long_ctx))
            b_ax = shd.batch_axes_for(mesh, B)
            token = _distribute(
                {"t": torch.zeros((B, 1), dtype=torch.int32)},
                {"t": (mesh, shd.placements_for(mesh, shd.P(b_ax), 2))})["t"]
            external = [token, *[t for c in cache for t in c.values()]]

            def run():
                logits, new = M.decode_step(cfg, model, cache, token,
                                            shape.seq_len - 1)
                return shd.act_constraint(logits, shd.P(b_ax, "model")), new
        state_in = [*model.parameters(), *external]
        args = _local_storages(state_in)
        counter = CostCounter()
        counter.track(*state_in)
        with counter.over_local_ops(), implicit_replication():
            out = run()
        peak = counter.peak
        new = {k: v for k, v in _local_storages(out).items() if k not in args}
    run_s = time.perf_counter() - t0
    arg_bytes = sum(args.values())
    if verbose:
        print(f"    ran in {run_s:.1f}s ({cfg.n_layers} layers, "
              f"fake world of {dist.get_world_size()})")
    return CellRun(flops=counter.flops, bytes=counter.bytes,
                   collectives=counter.collectives, arg_bytes=arg_bytes,
                   temp_bytes=max(0, peak - arg_bytes),
                   out_bytes=sum(new.values()), seconds=run_s)


def extrapolated_costs(cfg: ArchConfig, shape: ShapeSpec, mesh,
                       verbose: bool = True, hp=None):
    """Per-device (flops, bytes, coll_bytes, counts) at the true depth R.

    The port runs the cell at full depth: fake execution runs every
    layer, so nothing is counted once for many, and the reference's
    r=1/r=2 variants and their linear extrapolation are not needed."""
    run = lower_cell(cfg, shape, mesh, verbose=verbose, hp=hp)
    return RL.raw_costs(run)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             out_dir: Optional[str] = None, verbose: bool = True,
             skip_roofline: bool = False):
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    ok, why = supports_shape(cfg, shape)
    mesh_name = _mesh_name(multi_pod)
    if not ok:
        print(f"SKIP {arch} × {shape_name} [{mesh_name}]: {why}")
        return "skip"
    ensure_fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    chips = mesh.size()
    print(f"CELL {arch} × {shape_name} [{mesh_name}] kind={shape.kind}")

    run = lower_cell(cfg, shape, mesh, verbose=verbose)
    print(f"  memory(/dev): args={run.arg_bytes/2**30:.2f}GiB "
          f"temp={run.temp_bytes/2**30:.2f}GiB "
          f"out={run.out_bytes/2**30:.2f}GiB")
    print(f"  costs(/dev): flops={run.flops:.3e} bytes={run.bytes:.3e}")
    mem = (run.arg_bytes, run.temp_bytes, run.out_bytes)
    if skip_roofline or multi_pod:
        # the multi-pod pass shows the "pod" axis shards; the roofline is
        # one pod's
        rep = None
    else:
        flops, nbytes, coll, counts = RL.raw_costs(run)
        rep = RL.analyze_costs(flops, nbytes, coll, counts, cfg, shape,
                               mesh_name, chips, mem=mem, note=BYTES_NOTE)
        print(f"  roofline: t_comp={rep.t_compute:.4f}s "
              f"t_mem={rep.t_memory:.4f}s t_coll={rep.t_collective:.4f}s "
              f"-> {rep.bottleneck}-bound; useful={rep.useful_ratio:.3f} "
              f"frac={rep.roofline_fraction:.1%} ({BYTES_NOTE})")
        print(f"  collectives: {rep.collective_counts}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = f"{arch}__{shape_name}__{mesh_name}.json"
        body = rep.to_dict() if rep is not None else {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "ran": True, "arg_bytes": run.arg_bytes,
            "temp_bytes": run.temp_bytes, "out_bytes": run.out_bytes}
        with open(os.path.join(out_dir, fn), "w") as f:
            json.dump(body, f, indent=1)
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-roofline", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]

    reports, failures, n_cells = [], [], 0
    try:
        for mp in pods:
            for a in archs:
                for s in shapes:
                    try:
                        rep = run_cell(a, s, mp, out_dir=args.out,
                                       skip_roofline=args.skip_roofline)
                        if rep not in (None, "skip"):
                            reports.append(rep)
                        if rep != "skip":
                            n_cells += 1
                    except Exception as e:   # one cell's failure is reported
                        failures.append((a, s, mp, repr(e)))
                        traceback.print_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if reports:
        print("\n" + RL.format_table(reports))
        print(f"({BYTES_NOTE})")
    print(f"\n{n_cells} cells ran, {len(failures)} failures")
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        sys.exit(1)


if __name__ == "__main__":
    main()
