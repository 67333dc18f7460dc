"""The training loader: ``make_batch``'s step-keyed arrays as tensors on
the loader's device (the card unless the caller asks for the CPU).

With a mesh, each rank takes only its slice of the global batch, the rows
that the batch axes (``sharding.batch_axes_for``) give its coordinates,
copies that slice to its device and wraps it as a DTensor sharded over
those axes (``DTensor.from_local``): the JAX package's
``make_array_from_callback``. No rank's device holds the whole batch.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs import ArchConfig
from repro_torch.data.tokens import make_batch
from repro_torch.device import DeviceLike, resolve_device


class ShardedLoader:
    def __init__(self, cfg: ArchConfig, seq_len: int, global_batch: int,
                 mesh=None, seed: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.mesh = mesh
        self.seed = seed
        self.device = resolve_device(device)

    def rows(self) -> slice:
        """This rank's rows of the global batch (all of them without a
        mesh or without a batch axis that divides it)."""
        from repro_torch import sharding as shd
        B = self.global_batch
        b_ax = None if self.mesh is None else shd.batch_axes_for(self.mesh, B)
        if b_ax is None:
            return slice(0, B)
        names = list(self.mesh.mesh_dim_names)
        coord = self.mesh.get_coordinate()
        idx, n = 0, 1
        for a in (b_ax if isinstance(b_ax, tuple) else (b_ax,)):
            i = names.index(a)
            idx = idx * self.mesh.size(i) + coord[i]
            n *= self.mesh.size(i)
        per = B // n
        return slice(idx * per, (idx + 1) * per)

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        host = make_batch(self.cfg, self.seq_len, self.global_batch, step,
                          self.seed)
        if self.mesh is None:
            return {k: torch.as_tensor(v).to(self.device)
                    for k, v in host.items()}
        from torch.distributed.tensor import DTensor
        from repro_torch import sharding as shd
        b_ax = shd.batch_axes_for(self.mesh, self.global_batch)
        sl = self.rows()
        out = {}
        for k, v in host.items():
            pl = shd.placements_for(self.mesh, shd.P(b_ax), v.ndim)
            local = torch.as_tensor(v[sl]).to(self.device)
            out[k] = DTensor.from_local(local, self.mesh, pl,
                                        run_check=False)
        return out
