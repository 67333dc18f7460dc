"""The one generator of the benchmark's traffic. A traffic file
(``portbench/traffic/<name>.json``) gives its parameters; everything a
run sends is drawn here from the run's seed on the run's device.

``"kind": "train"``: one batch of ``batch`` rows of ``seq`` tokens a
step, drawn uniformly over the real vocabulary, step after step (a
closed loop); every step's rows differ.

``"kind": "serve"``: requests, each a batch of ``batch`` prompts of one
length that ``prompt_len`` ({length: weight}) gives, answered by
``output_tokens`` greedy tokens, sent open-loop at ``rate_per_s``, evenly
spaced from the window's start. The lengths come in blocks of ``block``
requests holding each length ``weight · block`` times, in an order drawn
from the seed, and a window sends whole blocks: every seed sends the
same mix of sizes at the same times, in another order.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List

import torch

from portbench.harness.weights import generator, sub_seed


def train_batch(traffic: dict, cfg: dict, seed: int, step: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch: tokens and next-token labels [batch, seq]."""
    B, S = traffic["batch"], traffic["seq"]
    rows = torch.randint(0, cfg["vocab_size"], (B, S + 1),
                         generator=generator(device, seed, "train", step),
                         device=device)
    return {"tokens": rows[:, :-1].contiguous(),
            "labels": rows[:, 1:].contiguous()}


@dataclasses.dataclass
class Request:
    index: int
    arrival_s: float       # from the window's start
    prompt_len: int


def lengths(traffic: dict) -> List[int]:
    return sorted(int(k) for k in traffic["prompt_len"])


def requests(traffic: dict, seed: int, seconds: float) -> List[Request]:
    """Every request whose arrival falls inside a window of ``seconds``;
    raises where they are not whole blocks."""
    block = traffic["block"]
    pool = []
    for length, weight in traffic["prompt_len"].items():
        pool += [int(length)] * round(weight * block)
    if len(pool) != block:
        raise ValueError(f"prompt_len weights {traffic['prompt_len']} do "
                         f"not fill a block of {block}")
    n = int(seconds * traffic["rate_per_s"] - 1e-9) + 1
    if n % block:
        raise ValueError(f"{seconds} s at {traffic['rate_per_s']} requests/s "
                         f"sends {n} requests, not whole blocks of {block}")
    out: List[Request] = []
    for b in range(0, n, block):
        order = list(pool)
        random.Random(sub_seed(seed, "block", b)).shuffle(order)
        for j, length in enumerate(order):
            i = b + j
            if i < n:
                out.append(Request(i, i / traffic["rate_per_s"], length))
    return out


def prompt(traffic: dict, cfg: dict, seed: int, req: Request,
           device: torch.device) -> torch.Tensor:
    """The prompts of request ``req``: [batch, prompt_len] token ids."""
    return torch.randint(0, cfg["vocab_size"],
                         (traffic["batch"], req.prompt_len),
                         generator=generator(device, seed, "prompt",
                                             req.index), device=device)
