"""Serving steps: prefill (context ingest → caches) and decode (one
token), and the greedy loop over them, as a Python loop over tokens.

A decode step runs from one CUDA graph of the whole step, keyed by the
batch and the cache length (every input's shape) and held by a
``repro_torch.graphs.Graphs``: a key's first call captures the graph and
replays it, later calls replay it. ``graphs.py``'s own rule runs a key's
first sighting op by op, so that a one-off call pays no capture; a
decode step's key comes back at every token of a request, so the step
notes its key before the call and its first call, the benchmark's
warm-up in its set-up, captures. The caches live in the graph's own
tensors: the step updates every cache tensor in place and returns those
same tensors, so the caller passes them back and their copy in is a
copy of a tensor onto itself, which costs nothing; a request's first
step copies its prefill's caches in once. Unlike the train step, the
decode step replays whether or not tracing is on: the decode metrics
read the card's timeline, which sees a graph's kernels, and a traced
decode run op by op would measure the host's dispatch that the untraced
steps no longer pay. A replay records no spans of the program. The
tallies ``serve.graph.replay``, ``serve.graph.eager`` and
``serve.graph.capture`` of ``repro_torch.tracing`` count how each call
ran, as ``train.graph.*`` do for the train step (on the CPU every call
runs op by op).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch import graphs as G
from repro_torch import tracing
from repro_torch.configs import ArchConfig
from repro_torch.device import sync_clock
from repro_torch.models import model as M


def make_prefill_step(cfg: ArchConfig, cache_len: int,
                      compute_dtype=torch.bfloat16):
    def prefill_step(model: M.LM, batch: M.Batch):
        return M.prefill(cfg, model, batch, cache_len,
                         compute_dtype=compute_dtype)
    return prefill_step


def _flat(cache: M.Cache) -> Dict[str, torch.Tensor]:
    """The caches as one dict, ``"<layer>.<name>"``."""
    return {f"{i}.{k}": v for i, c in enumerate(cache) for k, v in c.items()}


def _nested(flat: Dict[str, torch.Tensor]) -> M.Cache:
    layers: Dict[int, Dict[str, torch.Tensor]] = {}
    for name, v in flat.items():
        i, k = name.split(".", 1)
        layers.setdefault(int(i), {})[k] = v
    return [layers[i] for i in sorted(layers)]


def make_decode_step(cfg: ArchConfig, compute_dtype=torch.bfloat16):
    """Returns decode_step(model, cache, token, pos: int) -> (logits,
    cache), ``M.decode_step`` on the card from a CUDA graph of the
    (batch, cache length), as the module's docstring says. The step holds
    one graph: each of its callers keeps to one key (the benchmark builds
    a step per prompt length, ``greedy_generate`` one per call), and a
    call of another key or another model captures again. The logits and
    the caches returned are valid until the step's next call."""
    graphs = G.Graphs(capacity=1)

    def decode_step(model: M.LM, cache: M.Cache, token: torch.Tensor,
                    pos: int):
        def run(tok, at, caches):
            return M.decode_step(cfg, model, _nested(caches), tok["token"],
                                 at["pos"], compute_dtype=compute_dtype)
        at = torch.full((), pos, dtype=torch.int64, device=token.device)
        inputs = ({"token": token}, {"pos": at}, _flat(cache))
        graphs.note(*inputs)
        out, how = graphs(run, *inputs, bound=tuple(model.parameters()))
        if how == "capture":
            tracing.tally("serve.graph.capture")
        tracing.tally("serve.graph." + ("eager" if how == "eager"
                                        else "replay"))
        return out
    return decode_step


def greedy_generate(cfg: ArchConfig, model: M.LM, batch: M.Batch, *,
                    steps: int, cache_len: int, compute_dtype=torch.bfloat16,
                    timings: Optional[Dict[str, float]] = None):
    """Prefill, then ``steps`` greedy decode steps → (tokens [B, steps]
    int32: the prefill's pick and the first steps - 1 decode picks, as the
    JAX package returns them; the caches). With ``timings`` it also records
    ``prefill_s`` and ``decode_s`` (all steps), host clock after a device
    sync."""
    prefill_step = make_prefill_step(cfg, cache_len, compute_dtype)
    decode_step = make_decode_step(cfg, compute_dtype)
    device = batch["tokens"].device
    t0 = sync_clock(device) if timings is not None else 0.0
    logits, cache = prefill_step(model, batch)
    t1 = sync_clock(device) if timings is not None else 0.0
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    toks = [tok]
    start = batch["tokens"].shape[1]
    for i in range(steps):
        logits, cache = decode_step(model, cache, tok, start + i)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        toks.append(tok)
    if timings is not None:
        timings["prefill_s"] = t1 - t0
        timings["decode_s"] = sync_clock(device) - t1
    return torch.cat(toks[:steps], dim=1), cache
