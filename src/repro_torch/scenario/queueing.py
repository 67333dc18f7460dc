"""Queueing-inflation knee shared by every analytic ranking tier.

One curve, three callers: the online controller's scalar
``ForecastModel``, the tier-1 vectorized ``ScreeningModel`` (numpy), and
the batched fluid ensemble engine (``repro_torch.fluid``, torch).
The knee says: a work-conserving server fed deterministic slide-aligned
arrivals is stable below saturation, inflates mildly approaching it, and
cliffs at it (``NEVER_S`` — the backlog diverges and fires effectively
never complete).

The numpy variants are the JAX package's, carried as they are;
``q_factor_torch`` is the twin of its ``q_factor_jnp``. Edit the shape
here, nowhere else.
"""
from __future__ import annotations

import numpy as np
import torch

NEVER_S = 1e9
Q_KNEE = 0.7
Q_CLIFF = 0.95


def q_factor(u):
    """Queueing inflation factor for utilization ``u``. Polymorphic:
    a float returns a float, a numpy array maps elementwise."""
    if isinstance(u, np.ndarray):
        return q_factor_np(u)
    if u >= Q_CLIFF:
        return NEVER_S
    if u <= Q_KNEE:
        return 1.0
    return 1.0 + (u - Q_KNEE) / (Q_CLIFF - u)


def q_factor_np(u: np.ndarray) -> np.ndarray:
    """Vectorized :func:`q_factor` over a numpy array."""
    out = np.ones_like(u)
    mid = (u > Q_KNEE) & (u < Q_CLIFF)
    out[mid] = 1.0 + (u[mid] - Q_KNEE) / (Q_CLIFF - u[mid])
    out[u >= Q_CLIFF] = NEVER_S
    return out


def q_factor_torch(u: torch.Tensor) -> torch.Tensor:
    """torch twin of :func:`q_factor` (same knee/cliff/NEVER semantics);
    keeps ``u``'s dtype and device. The mid-branch denominator is guarded
    because ``torch.where`` evaluates both sides."""
    mid = 1.0 + (u - Q_KNEE) / torch.clamp_min(Q_CLIFF - u, 1e-12)
    return torch.where(u >= Q_CLIFF, NEVER_S,
                       torch.where(u <= Q_KNEE, 1.0, mid))
