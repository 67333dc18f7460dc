"""Fault tolerance: failure injection + restart-from-checkpoint policy.

`run_with_restarts` drives a training loop through injected failures the
way a real cluster controller would: on failure, state is discarded, the
newest complete checkpoint is restored (possibly onto a DIFFERENT mesh —
elastic restart after losing a slice), and the loop resumes. The data
stream is step-keyed, so replayed steps see identical batches.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, List, Optional, Tuple


@dataclasses.dataclass
class FailureInjector:
    """Bernoulli per-step failure (node crash / preemption)."""
    p_fail: float = 0.0
    seed: int = 0
    fail_steps: Optional[List[int]] = None   # deterministic alternative

    def __post_init__(self):
        self._fired = set()

    def should_fail(self, step: int) -> bool:
        if self.fail_steps is not None:
            # each listed step fails once (a replayed step after restart
            # succeeds — the node was replaced)
            if step in self.fail_steps and step not in self._fired:
                self._fired.add(step)
                return True
            return False
        if self.p_fail <= 0.0:
            return False
        # Step-keyed draw: replaying a step after a restart probes the
        # SAME coin the uninterrupted run would, so chaos schedules are
        # deterministic under replay. Fire-once per step (like
        # fail_steps) — the replacement node survives the replay.
        if step in self._fired:
            return False
        if random.Random(self._key(step)).random() < self.p_fail:
            self._fired.add(step)
            return True
        return False

    def _key(self, step: int) -> int:
        # int key (tuple seeding is hash-based and deprecated)
        return (self.seed << 32) ^ step

    def fail_times(self, n_steps: int):
        """The deterministic set of steps that would fire over `n_steps`
        probes, independent of any consumed state (step-keyed draws)."""
        if self.fail_steps is not None:
            return sorted(s for s in set(self.fail_steps)
                          if 0 <= s < n_steps)
        if self.p_fail <= 0.0:
            return []
        return [s for s in range(n_steps)
                if random.Random(self._key(s)).random() < self.p_fail]


class NodeFailure(RuntimeError):
    pass


def run_with_restarts(*, init_state, train_one_step: Callable,
                      ckpt_manager, n_steps: int,
                      injector: Optional[FailureInjector] = None,
                      restore_template=None, shardings=None,
                      max_restarts: int = 10):
    """Run `n_steps`, checkpointing via `ckpt_manager`, surviving injected
    failures. Returns (state, history, n_restarts)."""
    injector = injector or FailureInjector()
    state = init_state
    history = []
    restarts = 0
    step = 0
    # always have a restore point BEFORE the first step: with buffer
    # donation, init_state's buffers die inside step 0 — a failure before
    # the first periodic checkpoint must restore from step 0, not from the
    # (donated) python object.
    ckpt_manager.maybe_save(0, state)
    while step < n_steps:
        try:
            if injector.should_fail(step):
                raise NodeFailure(f"injected failure at step {step}")
            state, metrics = train_one_step(state, step)
            history.append((step, metrics))
            step += 1
            ckpt_manager.maybe_save(step, state)
        except NodeFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            template = restore_template if restore_template is not None \
                else state
            try:
                state, ck_step = ckpt_manager.restore_latest(
                    template, shardings=shardings)
            except FileNotFoundError:
                state, ck_step = init_state, 0
            step = ck_step
            # drop history for steps the restore rewound past — the
            # replay will re-append them (history stays strictly
            # increasing in step)
            while history and history[-1][0] >= ck_step:
                history.pop()
    ckpt_manager.finalize()
    return state, history, restarts
