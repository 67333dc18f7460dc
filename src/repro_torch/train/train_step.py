"""The train step: compute in ``compute_dtype`` (bf16 by default) over
float32 masters, per-layer remat, microbatch gradient accumulation,
clipping by global norm, the cosine schedule and AdamW.

The JAX package's step is a jitted pure function of the state; here
autograd fills each parameter's ``.grad`` and the optimizer updates the
parameters and moments in place (the JAX package donates those buffers),
so the state that comes back holds the same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw_update, clip_by_global_norm, cosine_schedule
from repro_torch.train.state import TrainState


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_accum: int = 1          # microbatches per step
    remat: str = "full"          # none | dots | full
    q_chunk: int = 512
    compute_dtype: Any = torch.bfloat16
    # the JAX package's loop unrolling for its dry-run cost variants and
    # its once-per-step gather of mesh-sharded weights: accepted, and
    # without a mesh (or a compiler) they change nothing, as q_chunk
    unroll: bool = False
    gather_once: bool = False


def make_train_step(cfg: ArchConfig, hp: TrainHParams):
    """Returns train_step(state, batch) -> (state, metrics): metrics
    ``loss``, ``aux_loss``, ``n_tokens`` (means over the microbatches),
    ``grad_norm`` (before clipping), ``lr`` and ``loss_total`` (loss +
    aux), as 0-d float32 tensors."""

    def loss_and_backward(model: M.LM, mb: M.Batch):
        total, metrics = M.loss_fn(cfg, model, mb,
                                   compute_dtype=hp.compute_dtype,
                                   remat=hp.remat, q_chunk=hp.q_chunk)
        total.backward()
        return total.detach(), {k: v.detach() for k, v in metrics.items()}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.params
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        if hp.grad_accum <= 1:
            l, metrics = loss_and_backward(model, batch)
            grads = {k: p.grad for k, p in params.items()}
        else:
            # microbatches along the batch dim; autograd adds each one's
            # gradient to .grad, so the sum is seeded with microbatch 0's
            n = hp.grad_accum
            mbs = [{k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                    for k, v in batch.items()} for i in range(n)]
            l0, m0 = loss_and_backward(model, mbs[0])
            ls, ms = [], []
            for mb in mbs[1:]:
                li, mi = loss_and_backward(model, mb)
                ls.append(li)
                ms.append(mi)
            l = (sum(ls[1:], ls[0]) + l0) / n
            metrics = {k: (sum((m[k] for m in ms[1:]), ms[0][k]) + m0[k]) / n
                       for k in m0}
            grads = {k: p.grad / n for k, p in params.items()}
        grads, gnorm = clip_by_global_norm(grads, hp.clip_norm)
        for p in params.values():
            p.grad = None
        lr = cosine_schedule(state.step, hp.warmup_steps, hp.total_steps,
                             hp.peak_lr)
        opt = adamw_update(grads, state.opt, params, lr=lr,
                           weight_decay=hp.weight_decay)
        del grads
        new_state = TrainState(params=model, opt=opt, step=state.step + 1)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr, loss_total=l)
        return new_state, metrics

    return train_step
