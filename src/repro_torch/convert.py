"""Carries the JAX package's parameters across to the port.

The JAX package draws its initial k-means centers and its CNN weights
from ``jax.random``, whose streams torch cannot reproduce. To hold the
port against it on the same numbers, those arrays are handed over as
numpy and converted here; nothing in this module imports JAX.

The language models' parameters are drawn from ``jax.random`` too;
``lm_params_from_jax`` carries a JAX parameter tree into the port's
per-layer modules, and ``train_state_from_jax`` a JAX train state (the
parameters, AdamW's moments and counters) into the port's.

The JITA-4DS core, the calibrator and the flash attention and SSD
kernels carry no parameters: their inputs are numpy arrays and traces
made from a seed, the same in both packages, so nothing here is needed
for them.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import LM
from repro_torch.optim import AdamWState
from repro_torch.pipeline.operators import CNNClassifier
from repro_torch.train.state import TrainState


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


def _flat(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """The leaves of a nested dict as {"a.b.c": array}."""
    for name, v in tree.items():
        if isinstance(v, Mapping):
            _flat(v, f"{prefix}{name}.", out)
        else:
            out[prefix + name] = np.asarray(v)


def _unstack(groups, layers: str, n_layers: int, out) -> None:
    """Stacked groups (one dict of [R, ...] leaves per pattern position j)
    to ``{layers}.{r * len(groups) + j}.<path>``."""
    for j, group in enumerate(groups):
        flat: Dict[str, np.ndarray] = {}
        _flat(group, "", flat)
        for path, a in flat.items():
            if a.shape[0] * len(groups) != n_layers:
                raise ValueError(f"{layers}: {len(groups)} groups of "
                                 f"{a.shape[0]} for {n_layers} layers")
            for r in range(a.shape[0]):
                out[f"{layers}.{r * len(groups) + j}.{path}"] = a[r]


def lm_arrays_from_jax(cfg: ArchConfig, params: Mapping
                       ) -> Dict[str, np.ndarray]:
    """A JAX parameter tree, or one shaped like it (its gradients, AdamW's
    moments), as {the port's parameter name: array}."""
    sd: Dict[str, np.ndarray] = {}
    top = {k: v for k, v in params.items()
           if k not in ("blocks", "enc_blocks")}
    _flat(top, "", sd)
    _unstack(params["blocks"], "blocks", cfg.n_layers, sd)
    if cfg.enc_dec is not None:
        _unstack(params["enc_blocks"], "enc_blocks",
                 cfg.enc_dec.n_enc_layers, sd)
    return sd


def lm_params_from_jax(cfg: ArchConfig, params: Mapping, *,
                       device: DeviceLike = None) -> LM:
    """An ``LM`` of ``cfg`` with the JAX package's parameters (a tree of
    arrays as its ``models.model.init_params`` returns, numpy or anything
    ``np.asarray`` reads). ``params["blocks"]`` holds one stacked group per
    pattern position, [R, ...] each; layer r · P + j of the port's
    ``blocks`` takes row r of group j. Every tensor keeps its layout
    (``wq`` [D, H, dh], ``w_gate`` [E, D, F], ...), which the port reads
    with the reference's einsums. Every parameter of the port must be
    given, and nothing else."""
    dev = resolve_device(device)
    sd = lm_arrays_from_jax(cfg, params)
    model = LM(cfg, torch.Generator(device=dev).manual_seed(0))
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in sd.items()}, strict=True)
    return model


def train_state_from_jax(cfg: ArchConfig, state, *,
                         device: DeviceLike = None) -> TrainState:
    """The port's ``TrainState`` from the JAX package's (``params``,
    ``opt.mu``, ``opt.nu``, ``opt.count``, ``step``; arrays as
    ``np.asarray`` reads them): the parameters through
    ``lm_params_from_jax``, the moments through the same path map onto the
    model's parameter names, in their own type."""
    dev = resolve_device(device)
    model = lm_params_from_jax(cfg, state.params, device=dev)
    names = dict(model.named_parameters())

    def moments(tree):
        flat = lm_arrays_from_jax(cfg, tree)
        if set(flat) != set(names):
            raise ValueError(f"moments and parameters differ: "
                             f"{sorted(set(flat) ^ set(names))}")
        return {k: torch.from_numpy(np.array(a, np.float32)).to(
                    dev, torch.bfloat16 if a.dtype.name == "bfloat16"
                    else torch.float32)
                for k, a in ((k, np.asarray(flat[k])) for k in names)}
    opt = AdamWState(mu=moments(state.opt.mu), nu=moments(state.opt.nu),
                     count=int(np.asarray(state.opt.count)))
    return TrainState(params=model, opt=opt, step=int(np.asarray(state.step)))
