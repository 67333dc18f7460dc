"""Abstract stand-ins for every model input, parameter, train state and
cache (no allocation), and their shardings, for the dry-run and the
launchers.

The port of the JAX package's ``launch/specs.py``. Its
``ShapeDtypeStruct``s are meta tensors here (shape and type, no storage);
the dry-run makes the same shapes as fake tensors under
``FakeTensorMode``, where ``fake_model`` draws a whole model without
allocating it. A sharding is a ``(mesh, placements)`` pair, the form
``checkpoint.restore_checkpoint(shardings=)`` takes; the ``*_specs``
functions give the partition specs under them, and take a ``MeshShape``
as well as a ``DeviceMesh``.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from repro_torch import sharding as shd
from repro_torch.configs import ArchConfig, ShapeSpec
from repro_torch.models import model as M
from repro_torch.optim import AdamWState
from repro_torch.train.state import TrainState

META = torch.device("meta")


def _sds(shape, dtype, device=META) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec,
                device=META) -> Dict[str, torch.Tensor]:
    """Input stand-ins for a train/prefill batch."""
    B, S = shape.global_batch, shape.seq_len
    out = {"tokens": _sds((B, S), torch.int32, device)}
    if shape.kind == "train":
        out["labels"] = _sds((B, S), torch.int32, device)
    if cfg.frontend == "patch_stub":
        out["patches"] = _sds((B, cfg.n_prefix_tokens, cfg.d_model),
                              torch.bfloat16, device)
    if cfg.enc_dec is not None:
        out["frames"] = _sds((B, cfg.enc_dec.enc_seq, cfg.d_model),
                             torch.bfloat16, device)
    return out


def batch_shardings(mesh, cfg: ArchConfig, shape: ShapeSpec):
    """{input name: (mesh, placements)}: the batch over the data axes."""
    b_ax = shd.batch_axes_for(mesh, shape.global_batch)
    return {k: (mesh, shd.placements_for(mesh, shd.P(b_ax), v.ndim))
            for k, v in batch_specs(cfg, shape).items()}


def fake_model(cfg: ArchConfig) -> M.LM:
    """The model of ``cfg`` drawn under the active ``FakeTensorMode`` (on
    the CPU, without storage)."""
    return M.init_params(cfg, torch.Generator().manual_seed(0))


def param_sds(cfg: ArchConfig, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{parameter name: meta tensor} of ``cfg``'s model (never
    materialized: drawn under a fake mode, described on meta)."""
    from torch._guards import active_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = active_fake_mode()
    with FakeTensorMode() if mode is None else contextlib.nullcontext():
        shapes = {k: tuple(p.shape)
                  for k, p in fake_model(cfg).named_parameters()}
    return {k: _sds(s, dtype) for k, s in shapes.items()}


def train_state_sds(cfg: ArchConfig) -> TrainState:
    """The parameters' stand-ins with float32 AdamW moments beside them;
    the counters are Python ints, as in the port's state."""
    p = param_sds(cfg)
    f32 = {k: _sds(v.shape, torch.float32) for k, v in p.items()}
    return TrainState(params=p, opt=AdamWState(mu=f32, nu=dict(f32),
                                               count=0), step=0)


def param_specs(mesh, cfg: ArchConfig, profile: str) -> Dict[str, shd.P]:
    return shd.build_param_specs(
        mesh, M.param_axes(cfg),
        {k: v.shape for k, v in param_sds(cfg).items()}, profile)


def param_shardings(mesh, cfg: ArchConfig, profile: str):
    """{parameter name: (mesh, placements)} under ``profile``."""
    sds = param_sds(cfg)
    return {k: (mesh, shd.placements_for(mesh, s, sds[k].ndim))
            for k, s in param_specs(mesh, cfg, profile).items()}


def train_state_shardings(mesh, cfg: ArchConfig) -> TrainState:
    """The train profile for the parameters and both moments; the
    counters are host ints (None: not placed)."""
    ps = param_shardings(mesh, cfg, "train")
    return TrainState(params=ps, opt=AdamWState(mu=ps, nu=dict(ps),
                                                count=None), step=None)


def cache_sds(cfg: ArchConfig, batch: int, cache_len: int,
              dtype=torch.bfloat16, device=META) -> List[dict]:
    return M.init_cache(cfg, batch, cache_len, dtype, device=device)


def cache_specs(mesh, cfg: ArchConfig, batch: int,
                long_context: bool = False) -> List[Dict[str, shd.P]]:
    """One dict of specs per layer (decode rules). The JAX package's
    caches carry a leading stacked-layers dim, never sharded; the port's
    per-layer caches do not, so each spec drops that entry."""
    def spec_for(d):
        out = {}
        for name, leaf in d.items():
            if name in ("k", "v", "xk", "xv"):
                kv, dh = leaf.shape[-2], leaf.shape[-1]
                s = shd.kv_cache_spec(mesh, batch, kv, dh, long_context)
            elif name == "conv":
                s = shd.P(None, shd.batch_axes_for(mesh, batch), None,
                          "model")
            elif name == "h":
                n_heads = leaf.shape[-3]
                s = shd.ssm_cache_specs(mesh, batch, n_heads)["h"]
            else:
                raise KeyError(f"no cache rule for {name!r}")
            out[name] = shd.P(*s[1:])
        return out
    return [spec_for(d) for d in cache_sds(cfg, batch, 8)]  # structure only


def cache_shardings(mesh, cfg: ArchConfig, batch: int,
                    long_context: bool = False) -> List[dict]:
    """One dict of (mesh, placements) per layer."""
    sds = cache_sds(cfg, batch, 8)
    return [{k: (mesh, shd.placements_for(mesh, s, d[k].ndim))
             for k, s in specs.items()}
            for specs, d in zip(cache_specs(mesh, cfg, batch, long_context),
                                sds)]
