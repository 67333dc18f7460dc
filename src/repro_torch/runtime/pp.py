"""GPipe-style pipeline parallelism over the "pod" axis.

The port of the JAX package's ``runtime/pp.py``: layer groups are
pipeline stages, one per rank of the mesh's ``axis``; microbatches stream
through the ring and the bubble is the usual (S-1)/(M+S-1).

The schedule is the reference's: T = M + S - 1 ticks; at tick t stage 0
ingests microbatch clip(t), every stage applies its stage function, the
last stage emits microbatch t - (S - 1) from tick S - 1 on, and each
stage's output goes to the next stage around the ring (the last→0
message is discarded). The ring ``ppermute`` is a
``dist.batch_isend_irecv`` whose send and receive are posted together,
so that no rank waits on a neighbour that is itself waiting. The result
is an all-reduce of the last stage's outputs (zeros elsewhere).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def pipeline_forward(stage_fn: Callable, n_stages: int, n_micro: int,
                     mesh, axis: str = "pod"):
    """Build fn(stage_params, x) running ``stage_fn`` as a GPipe pipeline
    over ``mesh``'s ``axis`` (``n_stages`` ranks).

    stage_params: a tensor, or a dict, list or tuple of them, with leading
    axis n_stages: whole on every rank, or DTensors sharded over ``axis``
    (``Shard(0)``); each rank runs its own stage's slice.
    x: [n_micro, micro_batch, ...] microbatched inputs, the same on every
    rank; returns y: [n_micro, micro_batch, ...] on every rank.

    stage_fn(params, h) -> h must be shape-preserving (the
    homogeneous-transformer case).
    """
    group = mesh.get_group(axis)
    if dist.get_world_size(group) != n_stages:
        raise ValueError(f"axis {axis!r} has {dist.get_world_size(group)} "
                         f"ranks for {n_stages} stages")
    ranks = dist.get_process_group_ranks(group)

    def fn(stage_params, x):
        if x.shape[0] != n_micro:
            raise ValueError(f"{x.shape[0]} microbatches, built for "
                             f"{n_micro}")
        stage = dist.get_rank(group)
        p = _stage_slice(stage_params, stage)
        M, S = n_micro, n_stages
        nxt, prv = ranks[(stage + 1) % S], ranks[(stage - 1) % S]
        h = torch.zeros_like(x[0])
        ys = torch.zeros_like(x)
        for t in range(M + S - 1):
            # stage 0 ingests microbatch t (if any)
            h_in = x[min(max(t, 0), M - 1)] if stage == 0 else h
            h_out = stage_fn(p, h_in)
            # the last stage emits microbatch t - (S - 1)
            if stage == S - 1 and t >= S - 1:
                ys[t - (S - 1)] = h_out
            # the ring: send to the next stage, receive from the previous
            h = torch.empty_like(h_out)
            if S > 1:
                ops = [dist.P2POp(dist.isend, h_out.contiguous(), nxt,
                                  group),
                       dist.P2POp(dist.irecv, h, prv, group)]
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            else:
                h = h_out
            # stage 0 reads x, so the last→0 message is discarded
        if stage != S - 1:
            ys = torch.zeros_like(ys)
        dist.all_reduce(ys, op=dist.ReduceOp.SUM, group=group)
        return ys

    return fn


def _stage_slice(tree, stage: int):
    """Stage ``stage``'s slice of every leaf: row 0 of a DTensor's local
    shard (Shard(0) over the stage axis), row ``stage`` of a tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: _stage_slice(v, stage) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage_slice(v, stage) for v in tree)
    if isinstance(tree, DTensor):
        return tree.to_local()[0]
    return tree[stage]
