"""The training loader: ``make_batch``'s step-keyed arrays as tensors on
the loader's device (the card unless the caller asks for the CPU).

The JAX package's ``ShardedLoader`` also assembles the global batch
across a mesh, each host building its slice; the port has no mesh yet,
so passing one raises.
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
        if mesh is not None:
            raise NotImplementedError("ShardedLoader has no mesh branch in "
                                      "the port yet")
        self.cfg = cfg
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.mesh = mesh
        self.seed = seed
        self.device = resolve_device(device)

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        host = make_batch(self.cfg, self.seq_len, self.global_batch, step,
                          self.seed)
        return {k: torch.as_tensor(v).to(self.device) for k, v in host.items()}
