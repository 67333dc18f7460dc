"""Process-parallel exact-DES plan evaluation.

The exact tier of every search (``screened_search`` / ``robust_search``
/ ``region_search``) scores a shortlist of finalist plans with the full
DES replay — each an independent, CPU-bound ``engine.run_plan`` call on
one shared, already-driven fire trace. :class:`ParallelEvaluator` fans
those calls across a persistent worker pool:

* **fork start method** (Linux default): workers inherit the parent's
  *driven* engine by address-space copy — no pickling, no re-drive; the
  pool amortizes across every batch of the evaluator's lifetime. A fork
  after the parent has made a CUDA context is safe because workers make
  no CUDA call.
* **no fork** (spawn-only platforms): workers rebuild the engine from
  the scenario's JSON ``ScenarioSpec`` (``spec=``) and pay one
  functional drive each, once per pool lifetime.
* **workers <= 1, no usable start method, or no spec to rebuild from**:
  clean in-process fallback — the batch runs the base class's serial
  loop in the caller's process.

Determinism: ``run_plan`` is a pure function of (driven engine, plan),
so per-plan results do not depend on which worker computes them. The
merge replays the submission order exactly as the serial evaluator
would — cache inserts, history entries and hit/miss counters are
bit-identical for any worker count, including the in-process fallback.

The memo cache is the inherited :class:`~repro_torch.placement.search.
Evaluator` cache, shared across calls (and across searches when the
caller passes ``cache=``), so an online controller's epoch loop reuses
exact results instead of re-fanning them out.
"""
from __future__ import annotations

import multiprocessing as mp
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.placement.cosim import CoSimResult, CoSimulator
from repro_torch.placement.plan import PlacementPlan
from repro_torch.placement.search import Evaluator

# Worker-process state: the engine every task of this pool evaluates
# against. Set once by the pool initializer.
_WORKER_ENGINE = None


def _init_worker(engine, spec_dict) -> None:
    global _WORKER_ENGINE
    # A worker runs host code only (``run_plan`` is the DES), and no CUDA
    # call: a forked child cannot use the parent's CUDA context. One
    # torch thread keeps it clear of the parent's OpenMP pool, which a
    # fork leaves in an unusable state.
    torch.set_num_threads(1)
    if engine is None:
        from repro_torch.scenario.spec import ScenarioSpec
        engine = ScenarioSpec.from_dict(spec_dict).compile()
        engine._ensure_driven()
    _WORKER_ENGINE = engine


def _eval_plan(plan_dict: Dict) -> CoSimResult:
    return _WORKER_ENGINE.run_plan(PlacementPlan.from_dict(plan_dict))


def default_workers() -> int:
    """Pool width when the caller does not pin one: the machine's cores
    (a 1-core box degrades to the in-process serial path)."""
    return os.cpu_count() or 1


class ParallelEvaluator(Evaluator):
    """Drop-in :class:`Evaluator` whose :meth:`evaluate_batch` fans the
    *uncached* plans of a batch across a persistent process pool.

    Single-plan ``__call__`` stays in-process (one DES run gains
    nothing from a pool round-trip); searches batch their exact tiers,
    so the pool sees the finalist fan-outs. Close with :meth:`close`
    or use as a context manager; an unclosed pool is reaped with the
    evaluator.

    Parameters
    ----------
    cosim:
        The driven scorer (a ``ScenarioEngine``) — also the engine
        forked into workers.
    workers:
        Pool width; ``None`` means :func:`default_workers`. ``<= 1``
        disables the pool entirely (serial in-process evaluation).
    spec:
        Optional ``ScenarioSpec`` (or its ``to_dict()`` form) for
        spawn-only platforms where workers cannot inherit the engine;
        without it, no-fork platforms fall back to in-process serial.
    """

    def __init__(self, cosim: CoSimulator, workers: Optional[int] = None,
                 spec=None, screener=None,
                 cache: Optional[Dict[Tuple, CoSimResult]] = None,
                 key_prefix: Optional[Tuple] = None):
        super().__init__(cosim, screener=screener, cache=cache,
                         key_prefix=key_prefix)
        self.workers = default_workers() if workers is None else int(workers)
        self._spec_dict = (spec.to_dict() if hasattr(spec, "to_dict")
                          else spec)
        self._pool = None
        self._pool_broken = False
        self.parallel_batches = 0   # batches that actually used the pool
        self.parallel_jobs = 0      # plans evaluated by pool workers
        self.serial_jobs = 0        # uncached plans evaluated in-process

    # ------------------------------------------------------------- pool
    def _start_method(self) -> Optional[str]:
        methods = mp.get_all_start_methods()
        if "fork" in methods:
            return "fork"
        if self._spec_dict is not None and methods:
            return methods[0]
        return None

    def _ensure_pool(self):
        if self.workers <= 1 or self._pool_broken:
            return None
        if self._pool is not None:
            return self._pool
        method = self._start_method()
        if method is None:
            self._pool_broken = True
            return None
        try:
            ctx = mp.get_context(method)
            if method == "fork":
                # fork inherits the driven engine through the address
                # space — make sure the trace exists before forking so
                # workers never each re-drive it
                ensure = getattr(self.cosim, "_ensure_driven", None)
                if ensure is not None:
                    ensure()
                initargs = (self.cosim, None)
            else:
                initargs = (None, self._spec_dict)
            self._pool = ctx.Pool(processes=self.workers,
                                  initializer=_init_worker,
                                  initargs=initargs)
        except Exception:
            self._pool_broken = True
            self._pool = None
        return self._pool

    def close(self) -> None:
        """Shut the worker pool down (idempotent)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __enter__(self) -> "ParallelEvaluator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------ batch
    def evaluate_batch(self, plans: Sequence[PlacementPlan]
                       ) -> List[CoSimResult]:
        """Fan the batch's uncached unique plans across the pool, then
        replay the submission order against the cache — the resulting
        cache contents, history order, and hit/miss counters are
        bit-identical to the serial base class for any worker count."""
        todo: List[PlacementPlan] = []
        seen = set()
        for plan in plans:
            key = self._key(plan)
            if key not in self.cache and key not in seen:
                seen.add(key)
                todo.append(plan)
        pool = self._ensure_pool() if len(todo) > 1 else None
        fresh: Dict[Tuple, CoSimResult] = {}
        if pool is not None:
            try:
                results = pool.map(_eval_plan,
                                   [p.to_dict() for p in todo])
            except Exception:
                # a dead pool must not kill the search — evaluate the
                # batch in-process and stop using the pool
                self._pool_broken = True
                self.close()
                results = None
            if results is not None:
                self.parallel_batches += 1
                self.parallel_jobs += len(todo)
                fresh = {self._key(p): r for p, r in zip(todo, results)}
        out: List[CoSimResult] = []
        for plan in plans:
            key = self._key(plan)
            if key in self.cache:
                self.hits += 1
            else:
                self.misses += 1
                res = fresh.get(key)
                if res is None:
                    res = self._run(plan)
                    self.serial_jobs += 1
                self.cache[key] = res
                self.history.append((plan.label, res.vos))
            out.append(self.cache[key])
        return out

    def stats(self) -> Dict:
        out = super().stats()
        out.update({"workers": self.workers,
                    "parallel_batches": self.parallel_batches,
                    "parallel_jobs": self.parallel_jobs,
                    "serial_jobs": self.serial_jobs})
        return out
