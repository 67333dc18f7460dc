"""Serving steps: prefill (context ingest → caches) and decode (one
token), and the greedy loop over them, as a Python loop over tokens."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.device import sync_clock
from repro_torch.models import model as M


def make_prefill_step(cfg: ArchConfig, cache_len: int,
                      compute_dtype=torch.bfloat16):
    def prefill_step(model: M.LM, batch: M.Batch):
        return M.prefill(cfg, model, batch, cache_len,
                         compute_dtype=compute_dtype)
    return prefill_step


def make_decode_step(cfg: ArchConfig, compute_dtype=torch.bfloat16):
    def decode_step(model: M.LM, cache: M.Cache, token: torch.Tensor,
                    pos: int):
        return M.decode_step(cfg, model, cache, token, pos,
                             compute_dtype=compute_dtype)
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
