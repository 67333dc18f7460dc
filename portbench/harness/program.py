"""The system under test, ``repro_torch``, reached through its public
entry points only: the model (``models.model``), the train step
(``train.make_train_step`` on ``init_train_state``) and the serving
steps (``train.serve_step.make_prefill_step`` / ``make_decode_step``).
This is the one module of the benchmark that imports the program."""
from __future__ import annotations

import dataclasses
import inspect
from typing import Dict

import torch

from repro_torch.configs import MoEConfig, SSMConfig, get_arch
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw_update, cosine_schedule
from repro_torch.train import TrainHParams, init_train_state, make_train_step
from repro_torch.train.serve_step import make_decode_step, make_prefill_step

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def arch(cfg: dict):
    """The program's configuration of ``cfg["arch"]`` with every size the
    configuration file states. Raises where the program cannot run the
    file as stated (a padding or an MoE capacity factor of its own)."""
    a = get_arch(cfg["arch"])
    fields = dict(n_layers=cfg["n_layers"], d_model=cfg["d_model"],
                  vocab_size=cfg["vocab_size"], norm_eps=cfg["norm_eps"],
                  tie_embeddings=cfg["tie_embeddings"])
    if "ssm" in cfg:
        s = cfg["ssm"]
        fields["ssm"] = SSMConfig(d_state=s["d_state"], d_conv=s["d_conv"],
                                  expand=s["expand"], head_dim=s["head_dim"],
                                  n_groups=s["n_groups"],
                                  chunk_size=s["chunk_size"])
    if "moe" in cfg:
        m = cfg["moe"]
        fields.update(n_heads=cfg["n_heads"], n_kv_heads=cfg["n_kv_heads"],
                      d_head=cfg["head_dim"], rope_theta=cfg["rope_theta"])
        fields["moe"] = MoEConfig(n_experts=m["n_experts"], top_k=m["top_k"],
                                  d_ff_expert=m["d_ff_expert"],
                                  aux_loss_weight=m["aux_loss_weight"])
        if MOE.CAPACITY_FACTOR != m["capacity_factor"]:
            raise ValueError(f"the program's MoE capacity factor is "
                             f"{MOE.CAPACITY_FACTOR}, the configuration "
                             f"states {m['capacity_factor']}")
    a = dataclasses.replace(a, **fields)
    if a.padded_vocab != cfg["padded_vocab"]:
        raise ValueError(f"the program pads the vocabulary to "
                         f"{a.padded_vocab}, the configuration states "
                         f"{cfg['padded_vocab']}")
    return a


def model(a, weights: Dict[str, torch.Tensor], device: torch.device):
    """The program's model of ``a`` holding ``weights`` (the benchmark's,
    assigned in place of the program's own draw)."""
    m = M.init_params(a, torch.Generator(device=device).manual_seed(0))
    m.load_state_dict(weights, strict=True, assign=True)
    return m


def trainer(a, traffic: dict, mdl):
    """(train_step, state): the program's step with the traffic's
    optimizer settings, remat and compute type, on a fresh state. The
    step fixes AdamW's b1, b2, eps and the schedule's final share of the
    peak rate itself: raises where the traffic, which the reference
    follows, states others."""
    o = traffic["optimizer"]
    fixed = {k: inspect.signature(adamw_update).parameters[k].default
             for k in ("b1", "b2", "eps")}
    fixed["final_lr_frac"] = \
        inspect.signature(cosine_schedule).parameters["final_lr_frac"].default
    for k, v in fixed.items():
        if o[k] != v:
            raise ValueError(f"the program's train step fixes {k} = {v}, "
                             f"the traffic states {o[k]}")
    hp = TrainHParams(peak_lr=o["peak_lr"], warmup_steps=o["warmup_steps"],
                      total_steps=o["total_steps"],
                      weight_decay=o["weight_decay"], clip_norm=o["clip_norm"],
                      remat=traffic["remat"],
                      compute_dtype=DTYPES[traffic["compute_dtype"]])
    return make_train_step(a, hp), init_train_state(mdl)


def first_moments(state) -> Dict[str, torch.Tensor]:
    """AdamW's first moment of each parameter, as the step leaves it."""
    return state.opt.mu


def parameters(state) -> Dict[str, torch.Tensor]:
    return dict(state.params.named_parameters())


def server(a, traffic: dict, cache_len: int):
    dtype = DTYPES[traffic["compute_dtype"]]
    return (make_prefill_step(a, cache_len, compute_dtype=dtype),
            make_decode_step(a, compute_dtype=dtype))
