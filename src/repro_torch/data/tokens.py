"""Deterministic synthetic LM data: a mixture of Markov chains over the
vocabulary so the loss has learnable structure (tests assert it drops).
Fully seeded — restart from a checkpoint reproduces the exact stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs import ArchConfig


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    n_states: int = 8
    order_bias: float = 0.85   # prob of following the chain vs uniform
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # each "state" is a cyclic walk over a random permutation slice
        self.next_tok = rng.integers(0, self.vocab_size,
                                     (self.n_states, self.vocab_size),
                                     dtype=np.int64)

    def batch(self, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        state = rng.integers(0, self.n_states, (batch_size,))
        toks = np.empty((batch_size, self.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.vocab_size, (batch_size,))
        follow = rng.random((batch_size, self.seq_len)) < self.order_bias
        rand = rng.integers(0, self.vocab_size, (batch_size, self.seq_len))
        for t in range(self.seq_len):
            chain = self.next_tok[state, toks[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], chain, rand[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def make_batch(cfg: ArchConfig, seq_len: int, batch_size: int, step: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """Full model batch incl. stub-frontend inputs."""
    data = SyntheticLM(cfg.vocab_size, seq_len, seed=seed)
    batch = data.batch(step, batch_size)
    rng = np.random.default_rng((seed, step, 1))
    if cfg.frontend == "patch_stub":
        batch["patches"] = rng.standard_normal(
            (batch_size, cfg.n_prefix_tokens, cfg.d_model),
            dtype=np.float32) * 0.1
        batch["labels"][:, :cfg.n_prefix_tokens] = -100  # mask prefix
    if cfg.enc_dec is not None:
        batch["frames"] = rng.standard_normal(
            (batch_size, cfg.enc_dec.enc_seq, cfg.d_model),
            dtype=np.float32) * 0.1
    return batch
