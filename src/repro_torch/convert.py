"""Carries the JAX package's parameters across to the port.

The JAX package draws its initial k-means centers and its CNN weights
from ``jax.random``, whose streams torch cannot reproduce. To hold the
port against it on the same numbers, those arrays are handed over as
numpy and converted here; nothing in this module imports JAX.

The JITA-4DS core, the calibrator and the flash attention and SSD
kernels carry no parameters: their inputs are numpy arrays and traces
made from a seed, the same in both packages, so nothing here is needed
for them.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.pipeline.operators import CNNClassifier


def cnn_from_jax(params: Mapping[str, np.ndarray], *,
                 device: DeviceLike = None) -> CNNClassifier:
    """A ``CNNClassifier`` with the JAX classifier's weights: convolutions
    ``[K, I, O]`` (WIO) → ``Conv1d.weight [O, I, K]``, head ``[C, n]`` →
    ``Linear.weight [n, C]``."""
    conv1 = np.asarray(params["conv1"], np.float32)
    conv2 = np.asarray(params["conv2"], np.float32)
    head = np.asarray(params["head"], np.float32)
    model = CNNClassifier(n_classes=head.shape[1], channels=head.shape[0],
                          kernel=conv1.shape[0])
    with torch.no_grad():
        model.conv1.weight.copy_(torch.tensor(conv1.transpose(2, 1, 0)))
        model.conv2.weight.copy_(torch.tensor(conv2.transpose(2, 1, 0)))
        model.head.weight.copy_(torch.tensor(head.T))
    return model.to(resolve_device(device))


def centers_from_jax(centers: np.ndarray, *,
                     device: DeviceLike = None) -> torch.Tensor:
    """k-means initial centers ``[k, d]``, taken as they are."""
    return torch.as_tensor(np.asarray(centers), device=resolve_device(device))
