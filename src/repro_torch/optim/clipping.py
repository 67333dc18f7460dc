"""Gradient clipping by global norm, over a dict of tensors (or any
iterable of them for the norm)."""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ Σ x²) in float32, the leaves summed in the order given."""
    total = None
    for x in tensors:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(grads · min(1, max_norm / (norm + 1e-9)), norm), each gradient
    scaled in float32 and returned in its own type."""
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, \
        norm
