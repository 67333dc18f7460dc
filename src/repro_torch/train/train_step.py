"""The train step: compute in ``compute_dtype`` (bf16 by default) over
float32 masters, per-layer remat, microbatch gradient accumulation,
clipping by global norm, the cosine schedule and AdamW.

The JAX package's step is a jitted pure function of the state; here
autograd fills each parameter's ``.grad`` and the optimizer updates the
parameters and moments in place (the JAX package donates those buffers),
so the state that comes back holds the same tensors.

Under a mesh (``sharding.use_mesh``) the parameters are DTensors and the
batch is sharded by the loader; the step is the same code, DTensor
placing the collectives. With ``gather_once`` the step first casts every
parameter to ``compute_dtype`` and redistributes it to the "serve"
profile's placements (TP only, no FSDP), once per step, and the
microbatches read those copies: one gather a step instead of one per
layer and microbatch. Their gradients are summed in float32 and go back
to the masters' placements once.

The schedule's step and AdamW's count live on the device as well as in
the state's host ints: the step reads the rate and the bias corrections
from that counter and advances it in place, so that no host number of
the step changes from one step to the next. That lets the step replay
itself on the card: on a CUDA device, without a mesh, with one
microbatch and without ``gather_once``, the whole step (forward with
remat, backward, clipping, the schedule, AdamW) runs by
``repro_torch.graphs``' rule, one graph held at a time: a batch shape's
first call op by op, later ones from one CUDA graph. While tracing is on
(``tracing.enable()`` or any ``torch.profiler``) the step runs op by op,
after releasing the graph, so that the spans and the profiler see every
op; the next call without it captures again. The tallies
``train.graph.*`` of ``repro_torch.tracing`` count how each call ran.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict

import torch

from repro_torch import graphs as G
from repro_torch import sharding as shd
from repro_torch import tracing
from repro_torch.configs import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim import (AdamWState, adamw_update, clip_by_global_norm,
                               cosine_schedule)
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
    compute_dtype: Any = torch.bfloat16
    # gather the mesh-sharded weights once per step (bf16, serve profile)
    # instead of per layer per microbatch; nothing without a mesh
    gather_once: bool = False


def make_train_step(cfg: ArchConfig, hp: TrainHParams):
    """Returns train_step(state, batch) -> (state, metrics): metrics
    ``loss``, ``aux_loss``, ``n_tokens`` (means over the microbatches),
    ``grad_norm`` (before clipping), ``lr`` and ``loss_total`` (loss +
    aux), as 0-d float32 tensors of their own. Its phases are the spans
    ``train.forward``, ``train.backward`` and ``train.optimizer``. The
    parameters and moments are updated in place; on the card the step
    may replay a CUDA graph (the module's docstring says when)."""
    counters = _Counters()
    graphs = G.Graphs(capacity=1)     # a pool holds a step's activations

    def loss_and_backward(model: M.LM, mb: M.Batch):
        with tracing.span("train.forward"):
            total, metrics = M.loss_fn(cfg, model, mb,
                                       compute_dtype=hp.compute_dtype,
                                       remat=hp.remat)
        with tracing.span("train.backward"):
            total.backward()
        return total.detach(), {k: v.detach() for k, v in metrics.items()}

    def warm(state: TrainState, batch: Dict[str, torch.Tensor]) -> None:
        """The forward and backward alone, the gradients dropped: the
        state is left as it was."""
        loss_and_backward(state.params, batch)
        for p in state.params.parameters():
            p.grad = None

    def run(state: TrainState, batch: Dict[str, torch.Tensor],
            ctr: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The step op by op on the device counter ``ctr`` ([step,
        count], advanced in place) -> the metrics."""
        model = state.params
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        mesh = shd.current_mesh()
        if hp.gather_once and mesh is not None:
            l, metrics, grads = _gathered_step(cfg, hp, model, params, batch,
                                               mesh)
        elif hp.grad_accum <= 1:
            l, metrics = loss_and_backward(model, batch)
            grads = {k: p.grad for k, p in params.items()}
        else:
            # microbatches along the batch dim; autograd adds each one's
            # gradient to .grad, so the sum is seeded with microbatch 0's
            n = hp.grad_accum
            mbs = _microbatches(batch, n)
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
        with tracing.span("train.optimizer"):
            grads, gnorm = clip_by_global_norm(grads, hp.clip_norm)
            for p in params.values():
                p.grad = None
            lr = cosine_schedule(ctr[0], hp.warmup_steps, hp.total_steps,
                                 hp.peak_lr)
            adamw_update(grads, state.opt, params, lr=lr,
                         weight_decay=hp.weight_decay, count=ctr[1] + 1)
            ctr.add_(1)
            del grads
        return dict(metrics, grad_norm=gnorm, lr=lr, loss_total=l)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        device = next(state.params.parameters()).device
        ctr = counters.at(device, state)
        how = "eager"
        if not _graphable(device, hp):
            metrics = run(state, batch, ctr)
        elif tracing.enabled():
            graphs.release()
            graphs.note(batch)
            metrics = run(state, batch, ctr)
        else:
            out, how = graphs(lambda b: run(state, b, ctr), batch,
                              warm=lambda b: warm(state, b),
                              bound=_state_tensors(state))
            metrics = out if how == "eager" else {
                k: v.clone() for k, v in out.items()}
        if how == "capture":
            tracing.tally("train.graph.capture")
        tracing.tally("train.graph." + ("eager" if how == "eager"
                                        else "replay"))
        counters.advanced(device)
        opt = AdamWState(mu=state.opt.mu, nu=state.opt.nu,
                         count=state.opt.count + 1)
        return TrainState(params=state.params, opt=opt,
                          step=state.step + 1), metrics

    return train_step


def _graphable(device: torch.device, hp: TrainHParams) -> bool:
    """Whether the step may replay a CUDA graph: on a CUDA device, without
    a mesh, with one microbatch and without ``gather_once``."""
    return (device.type == "cuda" and shd.current_mesh() is None
            and hp.grad_accum <= 1 and not hp.gather_once)


class _Counters:
    """The step's counters on each device, ``[step, count]`` as int64,
    which the step advances in place, and the host's pair that each
    holds; a state whose host ints differ (a fresh or restored one) is
    written in before its step."""

    def __init__(self):
        self.on: Dict[torch.device, list] = {}

    def at(self, device: torch.device, state: TrainState) -> torch.Tensor:
        want = (state.step, state.opt.count)
        hit = self.on.get(device)
        if hit is None:
            hit = self.on[device] = [
                torch.tensor(want, dtype=torch.int64, device=device), want]
        elif hit[1] != want:
            hit[0][0].fill_(want[0])
            hit[0][1].fill_(want[1])
            hit[1] = want
        return hit[0]

    def advanced(self, device: torch.device) -> None:
        hit = self.on[device]
        hit[1] = (hit[1][0] + 1, hit[1][1] + 1)


def _state_tensors(state: TrainState) -> tuple:
    """The tensors a step reads and writes in place: the parameters and
    both moments."""
    return (*state.params.parameters(), *state.opt.mu.values(),
            *state.opt.nu.values())


def _microbatches(batch: Dict[str, torch.Tensor], n: int):
    """``n`` microbatches along the batch dim: consecutive rows of a plain
    tensor; of a DTensor, consecutive rows of each rank's shard, so that
    every microbatch stays sharded as the batch is (a split of the
    global rows would put each microbatch on one rank and replicate its
    work)."""
    from torch.distributed.tensor import DTensor

    def part(v, i):
        if isinstance(v, DTensor):
            loc = v.to_local()
            per = loc.shape[0] // n
            return DTensor.from_local(loc[i * per:(i + 1) * per],
                                      v.device_mesh, v.placements,
                                      run_check=False)
        return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
    return [{k: part(v, i) for k, v in batch.items()} for i in range(n)]


@contextlib.contextmanager
def _swapped(model: M.LM, tensors: Dict[str, torch.Tensor]):
    """``model``'s parameters replaced by ``tensors`` (same names) inside,
    restored after; the backward runs inside too, so that a
    rematerialized layer recomputes with the same tensors."""
    saved = []
    for name, t in tensors.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        saved.append((mod, leaf, mod._parameters[leaf]))
        mod._parameters[leaf] = t
    try:
        yield
    finally:
        for mod, leaf, p in saved:
            mod._parameters[leaf] = p


def _gathered_step(cfg: ArchConfig, hp: TrainHParams, model: M.LM,
                   params: Dict[str, torch.Tensor], batch, mesh):
    """``gather_once``: the loss and the masters' gradients from copies
    cast to ``compute_dtype`` and redistributed to the "serve" placements
    once; the microbatches' gradients of the copies summed in float32 and
    redistributed to each master's placements."""
    pl = shd.build_param_placements(
        mesh, M.param_axes(cfg), {k: p.shape for k, p in params.items()},
        "serve")
    work = {k: p.detach().to(hp.compute_dtype).redistribute(mesh, pl[k])
            .requires_grad_(p.requires_grad) for k, p in params.items()}
    n = max(1, hp.grad_accum)
    mbs = _microbatches(batch, n) if n > 1 else [batch]
    acc, losses, ms = {}, [], []
    with _swapped(model, work):
        for mb in mbs:
            with tracing.span("train.forward"):
                total, metrics = M.loss_fn(cfg, model, mb,
                                           compute_dtype=hp.compute_dtype,
                                           remat=hp.remat)
            with tracing.span("train.backward"):
                gs = torch.autograd.grad(total, list(work.values()))
            for k, g in zip(work, gs):
                acc[k] = g.float() if k not in acc else acc[k] + g.float()
            losses.append(total.detach())
            ms.append({k: v.detach() for k, v in metrics.items()})
    grads = {k: (acc[k] / n).redistribute(mesh, params[k].placements)
             for k in params}
    l = sum(losses[1:], losses[0]) / n
    metrics = {k: sum((m[k] for m in ms[1:]), ms[0][k]) / n for k in ms[0]}
    return l, metrics, grads
