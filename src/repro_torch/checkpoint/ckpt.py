"""Checkpointing: step-atomic snapshots of a state tree with a manifest,
async writes and retention, in the JAX package's format.

Format: one ``step_<8 digits>.npz`` per checkpoint, its leaves keyed by
their path in the tree, plus ``manifest.json``. A path is written as the
JAX package's ``keystr`` writes one: ``['key']`` for a dict entry,
``[i]`` for a list or tuple item, ``.name`` for a dataclass field, and
``.<state-dict key>`` for each parameter and buffer of an ``nn.Module``
(``.params.blocks.0.attn.wq``). Leaves are tensors (bf16 stored as its
int16 bits), numpy arrays and Python numbers.

The device→host copy is taken when the save is called, so a step that
updates the state in place afterwards does not reach the file; the file
write can then run on an executor. ``restore_checkpoint`` checks every
leaf's path and shape against a template and writes the values into the
template's tensors in place (a module through its parameters), since the
port's train step updates its state in place as the JAX package donates
its buffers.

Under a mesh a DTensor leaf is saved whole (``full_tensor()``, which every
rank calls; rank 0 writes the file), in the same format; restoring into a
DTensor leaf keeps each rank's chunk. In a process group a blocking save,
and ``CheckpointManager.finalize`` (which ``restore_latest`` calls), end
with a barrier after rank 0's write, so no rank reads the directory
before the file is there. ``restore_checkpoint(shardings=)``
is the elastic path: each leaf is placed onto a ``(mesh, placements)``
that may differ from the mesh that wrote it, each rank taking its chunk
of the saved array (no scatter).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import re
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn


def _items(tree, path: str):
    """(path, child) of a tree's direct children, or None for a leaf."""
    if isinstance(tree, nn.Module):
        return [(f"{path}.{k}", v) for k, v in
                tree.state_dict(keep_vars=True).items()]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f"{path}.{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, Mapping):
        return [(f"{path}[{k!r}]", v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return [(f"{path}[{i}]", v) for i, v in enumerate(tree)]
    return None


def _leaves(tree, path: str = ""):
    items = _items(tree, path)
    if items is None:
        yield path, tree
        return
    for p, child in items:
        yield from _leaves(child, p)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    return np.array(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    """Every leaf as a numpy copy, keyed by its path (device→host here)."""
    return {k: _to_numpy(v) for k, v in _leaves(tree)}


def _restore(tree, path: str, flat: Dict[str, np.ndarray]):
    items = _items(tree, path)
    if items is None:
        if path not in flat:
            raise KeyError(f"checkpoint missing leaf {path}")
        arr = flat[path]
        shape = tuple(tree.shape) if hasattr(tree, "shape") else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"{path}: shape {arr.shape} != {shape}")
        if isinstance(tree, torch.Tensor):
            src = torch.from_numpy(arr)
            if tree.dtype == torch.bfloat16:
                src = src.view(torch.bfloat16)
            with torch.no_grad():
                if _is_dtensor(tree):
                    tree.to_local().copy_(_chunk(src, tree.device_mesh,
                                                 tree.placements))
                else:
                    tree.copy_(src)
            return tree
        if isinstance(tree, np.ndarray):
            return arr.astype(tree.dtype)
        return type(tree)(arr.item())
    if isinstance(tree, nn.Module):
        for p, child in items:
            _restore(child, p, flat)
        return tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _restore(getattr(tree, f.name), p, flat)
            for f, (p, _) in zip(dataclasses.fields(tree), items)})
    if isinstance(tree, Mapping):
        return type(tree)({k: _restore(v, p, flat)
                           for (k, v), (p, _) in zip(tree.items(), items)})
    return type(tree)(_restore(v, p, flat)
                      for v, (p, _) in zip(tree, items))


def _chunk(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's chunk of ``full`` under ``placements`` (no collective)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full, mesh, placements,
                             src_data_rank=None).to_local()


def _writer() -> bool:
    """Whether this process writes files: rank 0 of a running process
    group, or a process without one."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _sync_ranks() -> None:
    """In a process group, wait until every rank gets here."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    blocking: bool = True, executor=None):
    """Write ``tree`` at ``step`` atomically (tmp + rename). With
    blocking=False and an ``executor``, the device→host copy happens now
    but the file write is async (returns a future). The caller owns the
    executor's lifecycle; without one the write is synchronous. In a
    process group every rank calls it (a DTensor leaf is gathered) and
    rank 0 writes; the others return the path it writes. A synchronous
    save ends, on every rank, after rank 0's write; after an async one
    every rank must wait for it (``CheckpointManager.finalize``)."""
    flat = _flatten(tree)  # device→host sync point
    final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    sync = blocking or executor is None
    if not _writer():
        if sync:
            _sync_ranks()
        return final
    os.makedirs(ckpt_dir, exist_ok=True)

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)
        with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
            json.dump({"latest_step": step,
                       "steps": sorted(all_steps(ckpt_dir))}, f)
        return final

    if sync:
        _write()
        _sync_ranks()
        return final
    return executor.submit(_write)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for fn in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)\.npz$", fn)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _place(tree, shardings, path: str = ""):
    """``tree`` with each leaf under a ``(mesh, placements)`` leaf of
    ``shardings`` (a tree of the same structure) as a DTensor of this
    rank's chunk; a None in ``shardings`` keeps its subtree as it is."""
    if shardings is None:
        return tree
    if isinstance(shardings, tuple) and len(shardings) == 2 and hasattr(
            shardings[0], "mesh_dim_names"):
        from torch.distributed.tensor import DTensor
        mesh, placements = shardings
        full = torch.as_tensor(tree)
        return DTensor.from_local(_chunk(full, mesh, placements), mesh,
                                  placements, run_check=False,
                                  shape=full.shape, stride=full.stride())
    items = _items(tree, path)
    if items is None or isinstance(tree, nn.Module):
        raise ValueError(f"{path or 'the tree'}: shardings must reach its "
                         f"leaves with (mesh, placements)")
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _place(getattr(tree, f.name),
                           getattr(shardings, f.name), p)
            for f, (p, _) in zip(dataclasses.fields(tree), items)})
    if isinstance(tree, Mapping):
        return type(tree)({k: _place(v, shardings[k], p)
                           for (k, v), (p, _) in zip(tree.items(), items)})
    return type(tree)(_place(v, s, p)
                      for v, s, (p, _) in zip(tree, shardings, items))


def restore_checkpoint(ckpt_dir: str, template, step: Optional[int] = None,
                       shardings=None):
    """Restore into ``template``'s structure (its tensors in place) →
    (tree, step). Every leaf of the template must be in the checkpoint
    with its shape. With ``shardings`` (a tree like the template's whose
    leaves are ``(mesh, placements)``), each leaf comes back as a DTensor
    on that mesh, this rank holding its chunk: THE ELASTIC PATH, the mesh
    may differ from the one that wrote the checkpoint."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _place(_restore(template, "", flat), shardings), step


class CheckpointManager:
    """Retention + cadence policy around save/restore."""

    def __init__(self, ckpt_dir: str, save_every: int = 100,
                 keep: int = 3, async_write: bool = True):
        self.dir = ckpt_dir
        self.save_every = save_every
        self.keep = keep
        self.async_write = async_write
        self._pending = None
        # each manager owns its write thread (made at the first async
        # save, shut down in finalize)
        self._executor = None

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.save_every:
            return False
        if self._pending is not None:
            self._pending.result()  # one write in flight at a time
            self._pending = None
        if self.async_write and self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(1)
        res = save_checkpoint(self.dir, step, tree,
                              blocking=not self.async_write,
                              executor=self._executor)
        if not isinstance(res, str):
            self._pending = res
        self._gc()
        return True

    def finalize(self):
        """Wait for the write in flight, and in a process group for every
        rank (all call it): after it each rank reads what rank 0 wrote."""
        if self._pending is not None:
            self._pending.result()
            self._pending = None
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        self._gc()
        _sync_ranks()

    def _gc(self):
        if not _writer():
            return
        steps = all_steps(self.dir)
        for s in steps[:-self.keep]:
            try:
                os.remove(os.path.join(self.dir, f"step_{s:08d}.npz"))
            except OSError:
                pass

    def restore_latest(self, template, shardings=None):
        self.finalize()
        return restore_checkpoint(self.dir, template, shardings=shardings)
