"""SLO-optimal placement search.

Maximizes the Eq. 2 VoS reported by the co-simulator over per-service
edge|dc assignments (plus the DC chips/DVFS hints), subject to the
constraints the co-simulator enforces (edge RAM, DC power cap —
infeasible plans score −inf).

Two evaluation tiers:

  * **Screened** (the fast path, used whenever the scorer exposes a
    ``screening_model`` — i.e. the unified ``ScenarioEngine``): the
    whole candidate space (or a seeded sample + vectorized hill climb
    for fleet-scale spaces) is scored in batched numpy passes by
    :class:`repro_torch.scenario.screen.ScreeningModel`; the exact DES replay
    runs only on the top-K screened survivors plus the anchor plans, so
    a search pays a handful of co-simulations instead of hundreds.
  * **Exact** (the legacy path, and the only one for analytic scorers
    like the online controller's ``ForecastModel``): small plan spaces
    exhaustively, larger ones greedy descent from the all-edge / all-DC
    anchors polished with seeded random-restart hill climbing.

All exact evaluations are memoized on the plan's canonical key, and
every step — screening included — is deterministic for a fixed seed.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.placement.cosim import CoSimResult, CoSimulator
from repro_torch.placement.plan import (PlacementPlan, ServicePlacement, SITE_EDGE,
                                        enumerate_plans, service_options)


@dataclasses.dataclass
class SearchResult:
    plan: PlacementPlan
    result: CoSimResult
    method: str
    evaluations: int                   # fresh exact co-sims THIS search ran
    history: List[Tuple[str, float]]   # (plan label, vos) in eval order
    screen: Optional[Dict] = None      # tier-1 screening stats (if used)
    cache_hits: int = 0                # evaluator cache hits during search
    cache_misses: int = 0              # fresh exact runs during search

    def stats(self) -> Dict:
        """JSON-safe digest for benchmark reports."""
        out = {"method": self.method, "evaluations": self.evaluations,
               "cache_hits": self.cache_hits,
               "cache_misses": self.cache_misses}
        if self.screen is not None:
            out["screen"] = dict(self.screen)
        return out


class Evaluator:
    """Memoized plan evaluation; share one instance between baseline
    runs and a search to avoid re-co-simulating identical plans.

    Accepts anything that quacks like a plan scorer: the unified
    :class:`~repro_torch.scenario.engine.ScenarioEngine` (via ``run_plan``),
    the deprecated ``CoSimulator`` shim, or an analytic stand-in like
    the online controller's ``ForecastModel`` (via ``run``).

    Counters: ``hits`` / ``misses`` split cached from fresh exact runs
    (``evaluations`` alone used to conflate them); ``screened`` counts
    plans scored by the tier-1 vectorized screen (never co-simulated
    unless they survive into the top-K).

    ``cache`` lets callers share one memo dict across evaluators (the
    online controller keeps a single cross-epoch cache); ``key_prefix``
    namespaces its entries by scorer identity — a ``ForecastModel``
    changes with every epoch's rate estimate, so a shared cache keyed
    on the plan alone would serve stale scores from a different
    model."""

    def __init__(self, cosim: CoSimulator, screener=None,
                 cache: Optional[Dict[Tuple, CoSimResult]] = None,
                 key_prefix: Optional[Tuple] = None):
        self.cosim = cosim
        self._run = getattr(cosim, "run_plan", None) or cosim.run
        self.cache: Dict[Tuple, CoSimResult] = (cache if cache is not None
                                                else {})
        self._prefix = key_prefix
        self.history: List[Tuple[str, float]] = []
        self.hits = 0
        self.misses = 0
        self.screened = 0
        self._screener = screener

    def _key(self, plan: PlacementPlan) -> Tuple:
        k = plan.key()
        return (self._prefix, k) if self._prefix is not None else k

    def __call__(self, plan: PlacementPlan) -> CoSimResult:
        key = self._key(plan)
        if key not in self.cache:
            self.misses += 1
            res = self._run(plan)
            self.cache[key] = res
            self.history.append((plan.label, res.vos))
        else:
            self.hits += 1
        return self.cache[key]

    def evaluate_batch(self, plans: Sequence[PlacementPlan]
                       ) -> List[CoSimResult]:
        """Evaluate many plans; results in submission order. The base
        evaluator runs them serially — :class:`~repro_torch.placement.
        parallel.ParallelEvaluator` overrides this to fan uncached
        plans across a process pool while keeping cache, history and
        counters bit-identical to this loop."""
        return [self(p) for p in plans]

    @property
    def screener(self):
        """Tier-1 batch screener, if the scorer can build one."""
        if self._screener is None:
            make = getattr(self.cosim, "screening_model", None)
            if make is not None:
                self._screener = make()
        return self._screener

    def screen_batch(self, plans: Sequence[PlacementPlan]) -> np.ndarray:
        s = self.screener
        if s is None:
            raise ValueError(f"{type(self.cosim).__name__} has no "
                             "screening model")
        self.screened += len(plans)
        return s.score_batch(plans)

    def screen_matrix(self, P: np.ndarray, options) -> np.ndarray:
        """Index-matrix twin of :meth:`screen_batch` (what the sampled
        hill-climbing search uses); same counter, same screener."""
        s = self.screener
        if s is None:
            raise ValueError(f"{type(self.cosim).__name__} has no "
                             "screening model")
        self.screened += len(P)
        return s.score_matrix(P, options)

    def screen_block(self, P: np.ndarray, cols: Sequence[int],
                     options) -> np.ndarray:
        """Delta-aware twin of :meth:`screen_matrix` for block-
        coordinate batches where only ``cols`` vary across rows (the
        decomposed region search). Bit-identical scores; falls back to
        the dense pass on screeners without ``score_block`` or when the
        block does not decompose cleanly."""
        s = self.screener
        if s is None:
            raise ValueError(f"{type(self.cosim).__name__} has no "
                             "screening model")
        self.screened += len(P)
        block = getattr(s, "score_block", None)
        if block is None:
            return s.score_matrix(P, options)
        return block(P, cols, options)

    def stats(self) -> Dict:
        return {"evaluations": self.evaluations, "cache_hits": self.hits,
                "cache_misses": self.misses, "screened": self.screened}

    @property
    def evaluations(self) -> int:
        return len(self.cache)


def _score(res: CoSimResult) -> float:
    return res.vos if res.feasible else float("-inf")


def exhaustive_search(cosim: CoSimulator,
                      chips_options: Sequence[int] = (4, 8, 16),
                      dvfs_options: Sequence[float] = (1.0,),
                      evaluator: Optional[Evaluator] = None,
                      edge_sites: Sequence[str] = (SITE_EDGE,),
                      ) -> SearchResult:
    ev = evaluator or Evaluator(cosim)
    hits0, misses0 = ev.hits, ev.misses
    names = list(cosim.topology)
    best_plan: Optional[PlacementPlan] = None
    best: Optional[CoSimResult] = None
    for plan in enumerate_plans(names, chips_options, dvfs_options,
                                edge_sites):
        res = ev(plan)
        if best is None or _score(res) > _score(best):
            best_plan, best = plan, res
    assert best_plan is not None and best is not None
    return SearchResult(best_plan, best, "exhaustive", ev.misses - misses0,
                        ev.history, cache_hits=ev.hits - hits0,
                        cache_misses=ev.misses - misses0)


def _greedy(ev: Evaluator, start: PlacementPlan,
            options: List[ServicePlacement]) -> PlacementPlan:
    """First-improvement single-service descent: sweep the services,
    accept any improving move immediately, repeat until a full sweep
    finds none (a local optimum of the single-flip neighborhood)."""
    current, score = start, _score(ev(start))
    improved = True
    while improved:
        improved = False
        for name in sorted(current.assignments):
            for opt in options:
                if opt == current.assignments[name]:
                    continue
                cand = current.with_placement(name, opt)
                s = _score(ev(cand))
                if s > score:
                    current, score = cand, s
                    improved = True
    return current


def _hill_climb(ev: Evaluator, start: PlacementPlan,
                options: List[ServicePlacement], rng: random.Random,
                iters: int) -> PlacementPlan:
    """Seeded stochastic single-flip climb (escapes plateau ties)."""
    names = sorted(start.assignments)
    current, score = start, _score(ev(start))
    for _ in range(iters):
        name = rng.choice(names)
        opt = rng.choice(options)
        if opt == current.assignments[name]:
            continue
        cand = current.with_placement(name, opt)
        s = _score(ev(cand))
        # accept improvements and sideways moves (plateau escape); cand
        # always differs from current (identity options are skipped above)
        if s >= score:
            current, score = cand, s
    return current


def greedy_search(cosim: CoSimulator,
                  chips_options: Sequence[int] = (4, 8, 16),
                  dvfs_options: Sequence[float] = (1.0,),
                  seed: int = 0, restarts: int = 2,
                  climb_iters: int = 64,
                  evaluator: Optional[Evaluator] = None,
                  edge_sites: Sequence[str] = (SITE_EDGE,)) -> SearchResult:
    ev = evaluator or Evaluator(cosim)
    hits0, misses0 = ev.hits, ev.misses
    names = list(cosim.topology)
    options = service_options(chips_options, dvfs_options, edge_sites)
    rng = random.Random(seed)

    anchors = [PlacementPlan.all_edge(names, site=s) for s in edge_sites]
    for c in chips_options:
        anchors.append(PlacementPlan.all_dc(names, chips=c,
                                            dvfs_f=dvfs_options[0]))
    for _ in range(restarts):
        anchors.append(PlacementPlan(
            {n: rng.choice(options) for n in names}))

    best_plan: Optional[PlacementPlan] = None
    for anchor in anchors:
        local = _greedy(ev, anchor, options)
        local = _hill_climb(ev, local, options, rng, climb_iters)
        if best_plan is None or _score(ev(local)) > _score(ev(best_plan)):
            best_plan = local
    assert best_plan is not None
    best = ev(best_plan)
    return SearchResult(best_plan, best, "greedy+hillclimb",
                        ev.misses - misses0, ev.history,
                        cache_hits=ev.hits - hits0,
                        cache_misses=ev.misses - misses0)


def _anchor_plans(names: Sequence[str], chips_options: Sequence[int],
                  dvfs_options: Sequence[float],
                  edge_sites: Sequence[str]) -> List[PlacementPlan]:
    """The baseline plans every screened search re-scores exactly (so
    ``searched >= baselines`` holds even under a screening mis-rank)."""
    plans = [PlacementPlan.all_edge(names, site=s) for s in edge_sites]
    plans.append(PlacementPlan.all_dc(names, chips=chips_options[0],
                                      dvfs_f=dvfs_options[0]))
    return plans


def _plan_of_row(row, names: Sequence[str],
                 options: Sequence[ServicePlacement]) -> PlacementPlan:
    return PlacementPlan({n: options[int(o)] for n, o in zip(names, row)})


def screened_search(cosim: CoSimulator,
                    chips_options: Sequence[int] = (4, 8, 16),
                    dvfs_options: Sequence[float] = (1.0,),
                    seed: int = 0,
                    top_k: Optional[int] = None,
                    evaluator: Optional[Evaluator] = None,
                    edge_sites: Sequence[str] = (SITE_EDGE,),
                    enumerate_limit: int = 65536,
                    sample_budget: int = 2048,
                    climbers: int = 8,
                    climb_rounds: int = 32,
                    corrections=None) -> SearchResult:
    """Two-tier search: tier 1 scores candidates in vectorized batches
    on the screening model (the whole plan space when it enumerates
    under ``enumerate_limit``, else anchors + a seeded random sample
    refined by batched single-flip hill climbing on the screening
    surface); tier 2 runs the exact DES co-simulation only on the
    top-K screened survivors plus the anchor plans, which bounds the
    damage of a screening mis-rank. Deterministic for a fixed seed.

    ``corrections`` (per-service forecast-calibration terms, see
    :mod:`repro_torch.scenario.feedback`) are installed on the screener for
    the duration of this search — tier 1 then *ranks* with calibrated
    latency/value terms — and the screener's previous state is restored
    before returning. Tier 2 is the exact DES either way."""
    ev = evaluator or Evaluator(cosim)
    screener = ev.screener
    if screener is None:
        raise ValueError(f"{type(cosim).__name__} exposes no "
                         "screening_model; use exhaustive/greedy search")
    prev_corr = (screener.set_corrections(corrections)
                 if corrections is not None else None)
    try:
        return _screened_search(cosim, ev, screener, chips_options,
                                dvfs_options, seed, top_k, edge_sites,
                                enumerate_limit, sample_budget, climbers,
                                climb_rounds,
                                calibrated=corrections is not None)
    finally:
        if corrections is not None:
            screener.set_corrections(prev_corr)


def _screen_shortlist(ev: Evaluator, screener,
                      options: Sequence[ServicePlacement],
                      anchors: Sequence[PlacementPlan], seed: int,
                      top_k: int, enumerate_limit: int, sample_budget: int,
                      climbers: int, climb_rounds: int):
    """Tier-1 candidate generation shared by ``screened_search`` and
    ``robust_search``: score the whole space (small) or anchors + a
    seeded sample refined by batched single-flip hill climbing (large),
    then return the deduped top-K survivors best-first, the method
    label, and screening stats. Deterministic for a fixed seed."""
    names = list(screener.order)
    S, n_opts = len(names), len(options)
    space = n_opts ** S

    t0 = time.perf_counter()
    if space <= enumerate_limit:
        grids = np.meshgrid(*([np.arange(n_opts)] * S), indexing="ij")
        P = np.stack(grids, axis=-1).reshape(-1, S)
        scores = ev.screen_matrix(P, options)
        method = "screened-exhaustive"
    else:
        rng = np.random.default_rng(seed)
        A = screener.matrix_of(anchors, options)
        P = np.vstack([A, rng.integers(0, n_opts, size=(sample_budget, S))])
        scores = ev.screen_matrix(P, options)
        # batched first-improvement hill climb from the best seeds: each
        # round scores every single-flip neighbor of every live climber
        # in ONE vectorized pass
        order = np.argsort(-scores, kind="stable")
        cur = P[order[:climbers]].copy()
        cur_sc = scores[order[:climbers]].copy()
        for _ in range(climb_rounds):
            neigh, owner = [], []
            for ci, row in enumerate(cur):
                for si in range(S):
                    for o in range(n_opts):
                        if o != row[si]:
                            r = row.copy()
                            r[si] = o
                            neigh.append(r)
                            owner.append(ci)
            Nb = np.asarray(neigh)
            sc = ev.screen_matrix(Nb, options)
            owner = np.asarray(owner)
            improved = False
            for ci in range(len(cur)):
                mine = np.where(owner == ci)[0]
                bi = mine[np.argmax(sc[mine])]
                if sc[bi] > cur_sc[ci]:
                    cur[ci], cur_sc[ci] = Nb[bi], sc[bi]
                    improved = True
            P = np.vstack([P, Nb])
            scores = np.concatenate([scores, sc])
            if not improved:
                break
        method = "screened-sampled"
    screen_wall = time.perf_counter() - t0

    # deterministic top-K: stable sort on score, dedup on canonical key
    order = np.argsort(-scores, kind="stable")
    survivors: List[PlacementPlan] = []
    seen = set()
    for i in order:
        plan = _plan_of_row(P[i], names, options)
        key = plan.key()
        if key in seen:
            continue
        seen.add(key)
        survivors.append(plan)
        if len(survivors) >= top_k:
            break
    stats = {"screened": int(len(P)), "space": int(space),
             "screen_wall_s": round(screen_wall, 4)}
    return survivors, method, stats


def _default_top_k(space: int, enumerate_limit: int) -> int:
    return (max(2, min(16, space // 10)) if space <= enumerate_limit
            else 16)


def _screened_search(cosim, ev: Evaluator, screener,
                     chips_options: Sequence[int],
                     dvfs_options: Sequence[float], seed: int,
                     top_k: Optional[int], edge_sites: Sequence[str],
                     enumerate_limit: int, sample_budget: int,
                     climbers: int, climb_rounds: int,
                     calibrated: bool = False) -> SearchResult:
    hits0, misses0 = ev.hits, ev.misses
    names = list(screener.order)
    options = service_options(chips_options, dvfs_options, edge_sites)
    space = len(options) ** len(names)
    anchors = _anchor_plans(names, chips_options, dvfs_options, edge_sites)
    if top_k is None:
        top_k = _default_top_k(space, enumerate_limit)
    survivors, method, shortlist_stats = _screen_shortlist(
        ev, screener, options, anchors, seed, top_k, enumerate_limit,
        sample_budget, climbers, climb_rounds)
    screen_best_key = survivors[0].key() if survivors else None

    # tier 2: exact DES on survivors + anchors (memoized; a parallel
    # evaluator fans the uncached ones out, merge order is fixed)
    best_plan: Optional[PlacementPlan] = None
    best: Optional[CoSimResult] = None
    for plan, res in zip(survivors + anchors,
                         ev.evaluate_batch(survivors + anchors)):
        if best is None or _score(res) > _score(best):
            best_plan, best = plan, res
    assert best_plan is not None and best is not None
    screen_stats = dict(shortlist_stats)
    screen_stats.update({
        "top_k": int(top_k),
        "survivors": len(survivors), "anchors": len(anchors),
        "agreement": bool(screen_best_key == best_plan.key()),
        "calibrated": bool(calibrated),
    })
    return SearchResult(best_plan, best, method, ev.misses - misses0,
                        ev.history, screen=screen_stats,
                        cache_hits=ev.hits - hits0,
                        cache_misses=ev.misses - misses0)


def robust_search(cosim: CoSimulator, ensemble, risk="cvar",
                  chips_options: Sequence[int] = (4, 8, 16),
                  dvfs_options: Sequence[float] = (1.0,),
                  seed: int = 0,
                  shortlist: int = 24,
                  final_k: int = 6,
                  evaluator: Optional[Evaluator] = None,
                  edge_sites: Sequence[str] = (SITE_EDGE,),
                  enumerate_limit: int = 65536,
                  sample_budget: int = 2048,
                  climbers: int = 8,
                  climb_rounds: int = 32,
                  corrections=None,
                  prev_plan: Optional[PlacementPlan] = None) -> SearchResult:
    """Three-tier distributionally robust search.

    Tier 1 is the shared vectorized screen (``_screen_shortlist``) over
    the single nominal trace, kept only to cut the space down to
    ``shortlist`` candidates. Tier 2 evaluates every candidate against
    *all* drift realizations of ``ensemble`` (a
    :class:`repro_torch.fluid.ensemble.ScenarioEnsemble`) in one jitted fluid
    call and ranks plans by ``risk`` (a
    :class:`repro_torch.fluid.robust.RiskSpec`, a metric name, or ``None`` for
    risk-neutral mean). Tier 3 re-scores the top ``final_k`` finalists
    plus the anchor plans with the exact DES; the winner is the
    best-risk finalist the DES confirms feasible (falling back to the
    best exact score if none is).

    ``prev_plan`` charges per-candidate migration stalls inside the
    fluid tier, so risk ranking sees switching costs. Deterministic for
    a fixed seed."""
    from repro_torch.fluid.robust import RiskSpec, risk_score

    risk = RiskSpec.of(risk if risk is not None else "mean")
    ev = evaluator or Evaluator(cosim)
    screener = ev.screener
    if screener is None:
        raise ValueError(f"{type(cosim).__name__} exposes no "
                         "screening_model; robust_search needs tier 1")
    hits0, misses0 = ev.hits, ev.misses
    names = list(screener.order)
    options = service_options(chips_options, dvfs_options, edge_sites)
    anchors = _anchor_plans(names, chips_options, dvfs_options, edge_sites)

    prev_corr = (screener.set_corrections(corrections)
                 if corrections is not None else None)
    try:
        survivors, method, shortlist_stats = _screen_shortlist(
            ev, screener, options, anchors, seed, shortlist,
            enumerate_limit, sample_budget, climbers, climb_rounds)
    finally:
        if corrections is not None:
            screener.set_corrections(prev_corr)

    # candidate set for the fluid tier: screened survivors first, then
    # any anchor the screen did not already surface
    candidates: List[PlacementPlan] = []
    seen = set()
    for plan in list(survivors) + list(anchors):
        key = plan.key()
        if key not in seen:
            seen.add(key)
            candidates.append(plan)

    # tier 2: N realizations x M candidates in one jitted fluid call
    t0 = time.perf_counter()
    stalls = (ensemble.fluid.migration_stalls(prev_plan, candidates)
              if prev_plan is not None else None)
    fr = ensemble.evaluate(candidates, corrections=corrections,
                           stalls=stalls)
    fluid_wall = time.perf_counter() - t0
    scores = risk_score(fr.vos, risk)
    mean_scores = fr.vos.mean(axis=0)
    risk_order = np.argsort(-scores, kind="stable")
    finalists = [candidates[i] for i in risk_order[:max(1, final_k)]]
    fluid_best_key = finalists[0].key()

    # tier 3: exact DES on finalists + anchors; winner = best-risk
    # finalist the DES confirms feasible
    pool_plans = finalists + list(anchors)
    exact: Dict[Tuple, CoSimResult] = {
        plan.key(): res
        for plan, res in zip(pool_plans, ev.evaluate_batch(pool_plans))}
    best_plan: Optional[PlacementPlan] = None
    for plan in finalists:
        if exact[plan.key()].feasible:
            best_plan = plan
            break
    if best_plan is None:    # every finalist infeasible under the DES
        pool = finalists + list(anchors)
        best_plan = max(pool, key=lambda p: _score(exact[p.key()]))
    best = exact[best_plan.key()]

    idx_of = {p.key(): i for i, p in enumerate(candidates)}
    screen_stats = dict(shortlist_stats)
    screen_stats.update({
        "top_k": int(shortlist), "survivors": len(survivors),
        "anchors": len(anchors), "calibrated": corrections is not None,
        "agreement": bool(fluid_best_key == best_plan.key()),
        "robust": {
            "risk": risk.label,
            "ensemble": int(ensemble.n_realizations),
            "candidates": len(candidates),
            "fluid_wall_s": round(fluid_wall, 4),
            "finalists": [
                {"plan": p.label,
                 "risk_score": float(scores[idx_of[p.key()]]),
                 "mean_score": float(mean_scores[idx_of[p.key()]]),
                 "des_vos": float(exact[p.key()].vos),
                 "des_feasible": bool(exact[p.key()].feasible)}
                for p in finalists],
        },
    })
    return SearchResult(best_plan, best, f"robust[{risk.label}]+{method}",
                        ev.misses - misses0, ev.history,
                        screen=screen_stats,
                        cache_hits=ev.hits - hits0,
                        cache_misses=ev.misses - misses0)


def search_placement(cosim: CoSimulator,
                     chips_options: Sequence[int] = (4, 8, 16),
                     dvfs_options: Sequence[float] = (1.0,),
                     exhaustive_limit: int = 1024,
                     seed: int = 0,
                     evaluator: Optional[Evaluator] = None,
                     edge_sites: Sequence[str] = (SITE_EDGE,),
                     screen: Optional[bool] = None,
                     top_k: Optional[int] = None,
                     corrections=None,
                     partition: Optional[bool] = None,
                     warm_start: Optional[PlacementPlan] = None
                     ) -> SearchResult:
    """Front door. When the scorer can build a tier-1 screening model
    (the unified ``ScenarioEngine`` can; analytic scorers like the
    online ``ForecastModel`` cannot) the two-tier screened search is
    the default fast path — pass ``screen=False`` to force the legacy
    exact-only search. Without a screener: exhaustive when the plan
    space fits under ``exhaustive_limit`` evaluations, greedy +
    hill-climb otherwise. ``edge_sites`` widens the per-service choice
    set to a multi-gateway fleet; the evaluator must understand those
    site names. ``corrections`` threads forecast-calibration state into
    the tier-1 screen (ignored on the exact-only path, whose scorer —
    e.g. a calibrated ``ForecastModel`` — carries its own).

    ``partition`` routes hierarchical fleets to the decomposed
    per-region search (:func:`repro_torch.region.search.region_search` /
    ``region_search_exact``): ``None`` auto-detects declared regions on
    the scorer's fleet, ``True`` forces it, ``False`` keeps the joint
    search. ``warm_start`` seeds the decomposed path with an incumbent
    plan (the online controller's epoch loop)."""
    ev = evaluator or Evaluator(cosim)
    if screen is None:
        screen = ev.screener is not None
    if partition is None:
        fleet = getattr(getattr(cosim, "cfg", None), "fleet", None) \
            or getattr(getattr(cosim, "info", None), "fleet", None) \
            or getattr(cosim, "fleet", None)
        partition = bool(getattr(fleet, "regions", ()))
    if partition:
        from repro_torch.region.search import region_search, region_search_exact
        if screen:
            return region_search(cosim, chips_options, dvfs_options,
                                 seed=seed, evaluator=ev,
                                 warm_start=warm_start,
                                 corrections=corrections)
        return region_search_exact(cosim, chips_options, dvfs_options,
                                   seed=seed, evaluator=ev,
                                   warm_start=warm_start)
    if screen:
        return screened_search(cosim, chips_options, dvfs_options,
                               seed=seed, top_k=top_k, evaluator=ev,
                               edge_sites=edge_sites,
                               corrections=corrections)
    n_opts = len(edge_sites) + len(chips_options) * len(dvfs_options)
    space = n_opts ** len(cosim.topology)
    if space <= exhaustive_limit:
        return exhaustive_search(cosim, chips_options, dvfs_options,
                                 evaluator=ev, edge_sites=edge_sites)
    return greedy_search(cosim, chips_options, dvfs_options, seed=seed,
                         evaluator=ev, edge_sites=edge_sites)
