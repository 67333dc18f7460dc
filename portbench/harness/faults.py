"""Faults planted under the timed path, for the tests that see
``correct`` come out false and for ``control.py``'s readings: each wraps
the program's train step or its (prefill, decode) pair. No benchmark
run plants one."""
from __future__ import annotations

import torch

from portbench.harness import program


def train_state_unchanged(step):
    """The step runs and reports its loss, and the state comes back as it
    was: parameters and moments restored."""
    def broken(state, batch):
        keep = {k: t.detach().clone() for k, t in
                program.parameters(state).items()}
        mu = {k: t.clone() for k, t in program.first_moments(state).items()}
        state, m = step(state, batch)
        with torch.no_grad():
            for k, t in program.parameters(state).items():
                t.copy_(keep[k])
            for k, t in program.first_moments(state).items():
                t.copy_(mu[k])
        return state, m
    return broken


def train_half_batch(step):
    """The step sees the first half of the batch's rows: the mean is
    taken over the rest."""
    def broken(state, batch):
        return step(state, {k: v[: v.shape[0] // 2] for k, v in
                            batch.items()})
    return broken


def serve_token_altered(prefill, decode):
    """Each decode step's logits shifted by one token: the token served
    is another than the program computed."""
    def broken(model, cache, token, pos):
        logits, cache = decode(model, cache, token, pos)
        return logits.roll(1, dims=-1), cache
    return prefill, broken


def serve_state_unchanged(prefill, decode):
    """Each decode step reads the caches and leaves them as they were."""
    def broken(model, cache, token, pos):
        logits, _ = decode(model, [{k: v.clone() for k, v in c.items()}
                                   for c in cache], token, pos)
        return logits, cache
    return prefill, broken


TRAIN = {"state_unchanged": train_state_unchanged,
         "half_batch": train_half_batch}
SERVE = {"state_unchanged": serve_state_unchanged,
         "token_altered": serve_token_altered}
