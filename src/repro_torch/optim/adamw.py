"""AdamW with float32 master moments and decoupled weight decay, over
dicts of tensors keyed alike (a model's ``named_parameters``).

The order of operations is the JAX package's, so the two agree float for
float up to the libraries' own rounding:

    m = b1·m + (1 - b1)·g;  v = b2·v + (1 - b2)·g²
    step = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd·p
    p = p - lr·step

``torch.optim.AdamW`` applies the weight decay as a separate multiply
of p before the Adam step, which rounds differently, so it is not used.
``adamw_update`` writes the new parameters and moments into the given
tensors in place (the JAX package donates those buffers to the step),
through ``torch._foreach_*`` in float32. The rate and the bias
corrections reach those calls as 0-d float32 tensors on the parameters'
device, so that a step whose count lives on the device (the train
step's counter) holds no host number that changes from step to step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamWState:
    mu: Tensors
    nu: Tensors
    count: int


def adamw_init(params: Tensors, moment_dtype=torch.float32) -> AdamWState:
    """Zero moments beside each parameter. ``moment_dtype=bfloat16``
    halves the optimizer's memory; updates still run in float32."""
    zeros = {k: torch.zeros_like(p, dtype=moment_dtype)
             for k, p in params.items()}
    return AdamWState(mu=zeros, nu={k: torch.zeros_like(z)
                                    for k, z in zeros.items()}, count=0)


def bias_corrections(count, b1: float, b2: float):
    """(1 - b1^t, 1 - b2^t) in float32 for the step count t, a host int
    or a 0-d tensor; 0-d float32 tensors on the count's device."""
    t = torch.as_tensor(count).to(torch.float32)
    return 1.0 - b1 ** t, 1.0 - b2 ** t


_GROUP = 32     # tensors per group of foreach calls


def _foreach_step(p, g, m, v, lr, b1, b2, bc1, bc2, eps, weight_decay):
    """The float32 update of one group of tensors, in place."""
    torch._foreach_mul_(m, b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(v, b2)
    torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g),
                                              1 - b2))
    mhat = torch._foreach_div(m, bc1)
    vhat = torch._foreach_div(v, bc2)
    torch._foreach_sqrt_(vhat)
    torch._foreach_add_(vhat, eps)
    step = torch._foreach_div(mhat, vhat)
    del mhat, vhat
    torch._foreach_add_(step, torch._foreach_mul(p, weight_decay))
    torch._foreach_mul_(step, lr)
    torch._foreach_sub_(p, step)


@torch.no_grad()
def adamw_update(grads: Tensors, state: AdamWState, params: Tensors, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, count=None) -> AdamWState:
    """One AdamW step on ``params`` (updated in place, as are the
    moments); returns the state with its count advanced. ``lr`` is a
    float or a 0-d tensor (read as float32). ``count`` is this step's
    count, ``state.count + 1``, as a 0-d tensor on the parameters'
    device where the caller keeps it there; by default it is taken from
    the state."""
    keys = list(params)
    dev = params[keys[0]].device if keys else None
    bcs = bias_corrections(state.count + 1 if count is None else count,
                           b1, b2)
    lr, bc1, bc2 = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in (lr, *bcs))
    # in groups, so that the temporaries stay a fraction of the model
    for i in range(0, len(keys), _GROUP):
        group = keys[i:i + _GROUP]
        # float32 views: the tensors themselves where they are float32
        # (updated in place), float32 copies of the others (bf16
        # moments), written back after
        p, g, m, v = ([t[k].float() for k in group]
                      for t in (params, grads, state.mu, state.nu))
        _foreach_step(p, g, m, v, lr, b1, b2, bc1, bc2, eps, weight_decay)
        for t, views in ((params, p), (state.mu, m), (state.nu, v)):
            for k, f in zip(group, views):
                if t[k] is not f:
                    t[k].copy_(f)
    return AdamWState(mu=state.mu, nu=state.nu, count=state.count + 1)
