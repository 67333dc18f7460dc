"""Big data/stream operators (paper §3): windowed aggregations and the
analytics services (k-means, linear regression, a CNN classifier).

``aggregate`` is the edge path and stays numpy. The analytics operators
are torch and run on an explicit device: the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    kind: str          # sliding | landmark
    width_s: float     # window width (ignored for landmark)
    slide_s: float     # recurrence / stride


def aggregate(values: np.ndarray, agg: str) -> float:
    """Edge-path aggregation over one window (numpy, tiny)."""
    if len(values) == 0:
        return float("nan")
    return float({"max": np.max, "min": np.min, "mean": np.mean,
                  "sum": np.sum, "count": len}[agg](values))


def _kmeans_step(centers: torch.Tensor, xs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    d = ((xs[:, None, :] - centers[None]) ** 2).sum(-1)
    assign = d.argmin(1)
    onehot = F.one_hot(assign, centers.shape[0]).to(xs.dtype)
    counts = onehot.sum(0).clamp_min(1.0)
    return (onehot.T @ xs) / counts[:, None], assign


def lloyd(xs: torch.Tensor, centers: torch.Tensor, iters: int = 20
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd steps from the given initial centers; returns the
    last centers and the assignment to the centers before them (as the
    JAX package's loop does)."""
    assign = None
    for _ in range(iters):
        centers, assign = _kmeans_step(centers, xs)
    return centers, assign


def kmeans(xs, k: int, iters: int = 20, seed: int = 0, *,
           device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means (the paper's analytics service example). The k
    initial centers are distinct points drawn by a ``torch.Generator``
    seeded from ``seed`` (not the JAX package's draws: ``jax.random``
    streams have no torch counterpart)."""
    xs = torch.as_tensor(xs, device=resolve_device(device))
    gen = torch.Generator().manual_seed(seed)
    idx = torch.randperm(xs.shape[0], generator=gen)[:k].to(xs.device)
    return lloyd(xs, xs[idx], iters)


def linear_regression(x, y, *, device: DeviceLike = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OLS fit via normal equations (analytics service)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    X = torch.stack([torch.ones_like(x), x], dim=1)
    beta = torch.linalg.solve(X.T @ X, X.T @ y)
    return beta, y - X @ beta


# ---------------------------------------------------------------------------
# CNN analytics service (the paper's §3 operator list includes CNN): a tiny
# 1-D conv classifier over fixed-length measurement windows — e.g. labeling
# connectivity traces as {stable, degraded, bursty}.
# ---------------------------------------------------------------------------
def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """XLA's SAME padding along the last axis: the odd element of the
    total goes to the end, e.g. (1, 2) for T = 64, k = 5, s = 2."""
    T = x.shape[-1]
    total = max((-(-T // s) - 1) * s + k - T, 0)
    return F.pad(x, (total // 2, total - total // 2))


class CNNClassifier(nn.Module):
    """windows [B, T] → logits [B, n_classes]: per-window standardization
    (population std), two stride-2 SAME convolutions with ReLU, a max-pool
    over time (bursts are sparse events) and a linear head, no biases."""

    def __init__(self, n_classes: int = 3, channels: int = 8,
                 kernel: int = 5):
        super().__init__()
        self.conv1 = nn.Conv1d(1, channels, kernel, stride=2, bias=False)
        self.conv2 = nn.Conv1d(channels, channels, kernel, stride=2,
                               bias=False)
        self.head = nn.Linear(channels, n_classes, bias=False)

    def forward(self, windows: torch.Tensor) -> torch.Tensor:
        mu = windows.mean(1, keepdim=True)
        sd = windows.std(1, keepdim=True, correction=0) + 1e-6
        x = ((windows - mu) / sd)[:, None, :]                 # [B, 1, T]
        for conv in (self.conv1, self.conv2):
            x = F.relu(conv(_same_pad(x, conv.kernel_size[0],
                                      conv.stride[0])))
        return self.head(x.amax(-1))                          # [B, n_classes]


def init_cnn_classifier(n_classes: int = 3, channels: int = 8, *,
                        seed: int = 0, device: DeviceLike = None
                        ) -> CNNClassifier:
    """A classifier with the JAX package's init scales (normal × 0.3, 0.2,
    0.3), drawn from a ``torch.Generator`` seeded from ``seed``."""
    model = CNNClassifier(n_classes, channels)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p, scale in ((model.conv1.weight, 0.3), (model.conv2.weight, 0.2),
                         (model.head.weight, 0.3)):
            p.copy_(torch.randn(p.shape, generator=gen) * scale)
    return model.to(resolve_device(device))


def cnn_classify(model: CNNClassifier, windows) -> torch.Tensor:
    """windows: [B, T] series → logits [B, n_classes], on the model's
    device."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        return model(torch.as_tensor(windows, device=dev))
