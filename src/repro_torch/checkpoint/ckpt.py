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
its buffers. The JAX package's elastic restore onto another mesh waits
for the port's mesh.
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


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
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


def save_checkpoint(ckpt_dir: str, step: int, tree, *,
                    blocking: bool = True, executor=None):
    """Write ``tree`` at ``step`` atomically (tmp + rename). With
    blocking=False and an ``executor``, the device→host copy happens now
    but the file write is async (returns a future). The caller owns the
    executor's lifecycle; without one the write is synchronous."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)  # device→host sync point

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}.npz")
        final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)
        with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
            json.dump({"latest_step": step,
                       "steps": sorted(all_steps(ckpt_dir))}, f)
        return final

    if blocking or executor is None:
        return _write()
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


def restore_checkpoint(ckpt_dir: str, template, step: Optional[int] = None,
                       shardings=None):
    """Restore into ``template``'s structure (its tensors in place) →
    (tree, step). Every leaf of the template must be in the checkpoint
    with its shape. ``shardings`` (the JAX package's elastic placement)
    needs a mesh, which the port does not have yet: it must be None."""
    if shardings is not None:
        raise NotImplementedError("restore onto a mesh waits for the port's "
                                  "mesh")
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return _restore(template, "", flat), step


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
        if self._pending is not None:
            self._pending.result()
            self._pending = None
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        self._gc()

    def _gc(self):
        steps = all_steps(self.dir)
        for s in steps[:-self.keep]:
            try:
                os.remove(os.path.join(self.dir, f"step_{s:08d}.npz"))
            except OSError:
                pass

    def restore_latest(self, template, shardings=None):
        self.finalize()
        return restore_checkpoint(self.dir, template, shardings=shardings)
