"""Decomposed placement search for hierarchical fleets.

A 500-site fleet makes the joint per-service site choice set explode:
``(sites + dc_options)^services`` is astronomically larger than any
screening budget. But a hierarchical fleet is *loosely coupled*: a
service chain rooted in one region almost always wants to execute
inside that region (its raw records live there) or in the DC — placing
it on an arbitrary third region's gateway pays two RAP trunks for
nothing. ``region_search`` exploits that structure:

  1. ``partition_services`` groups the services by the region of their
     root farm queue and caps each region's candidate-site list
     (farm sites first, then the beefiest boxes) so every per-region
     block space is enumerable;
  2. a block-coordinate pass sweeps the regions: each region's block of
     services is screened over its own candidate space — budgets scale
     with *that region's* space via ``_default_top_k`` — while every
     other region stays pinned at the current plan, so the global
     screening model prices cross-region edge-tier and RAP-trunk
     contention on full fleet-wide plans, never on an isolated slice;
  3. finalists (the composed winner plus single-region runner-up swaps,
     optionally re-ranked by a fluid drift ensemble) are re-scored with
     the exact DES alongside the anchor plans, bounding any screening
     mis-rank exactly like the flat ``screened_search``.

``region_search_exact`` is the analytic twin for scorers without a
screening model (the online controller's ``ForecastModel``): a
block-coordinate greedy descent over the same partition, warm-started
from the incumbent plan so successive epochs cost a handful of model
evaluations instead of a cold search.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.placement.plan import (PlacementPlan, ServicePlacement, SITE_DC,
                                        service_options)
from repro_torch.placement.search import (Evaluator, SearchResult, _default_top_k,
                                          _score)
from repro_torch.region.hier import regions_view


@dataclasses.dataclass(frozen=True)
class RegionPartition:
    """One region's slice of the search problem: the services whose
    chains are rooted there and the candidate edge sites the search may
    place them on (every service can additionally go to the DC)."""
    region: str
    services: Tuple[str, ...]
    sites: Tuple[str, ...]


def _root_of(svc: str, topology: Mapping[str, Sequence[str]]) -> str:
    """Walk a service's upstream chain to its root (first upstream at
    every hop — the dominant record source, as in ``ForecastModel``)."""
    seen = set()
    cur = svc
    while True:
        ups = topology.get(cur) or ()
        if not ups or cur in seen:
            return cur
        seen.add(cur)
        cur = ups[0]


def partition_services(fleet, topology: Mapping[str, Sequence[str]],
                       farm_site_of: Mapping[str, str],
                       max_sites_per_region: int = 12
                       ) -> List[RegionPartition]:
    """Group services by the region of their root farm queue.

    ``farm_site_of`` maps each *root* service to the site its input
    queue's farm is pinned to; chained services inherit their root's
    region. Regions with no services are dropped. Each partition's
    candidate-site list is capped at ``max_sites_per_region``: the
    member services' farm sites always make the cut, the rest of the
    region is ranked by device capability (FLOP/s, then name for
    determinism)."""
    regions = regions_view(fleet)
    region_of = {s: i for i, r in enumerate(regions) for s in r.sites}
    by_region: Dict[int, List[str]] = {}
    needed: Dict[int, List[str]] = {}
    for svc in topology:
        root = _root_of(svc, topology)
        site = farm_site_of.get(root) or farm_site_of.get(svc)
        if site is None:
            raise KeyError(f"no farm site known for root {root!r} "
                           f"(service {svc!r})")
        ri = region_of[site]
        by_region.setdefault(ri, []).append(svc)
        needed.setdefault(ri, []).append(site)
    out: List[RegionPartition] = []
    for ri, r in enumerate(regions):
        svcs = by_region.get(ri)
        if not svcs:
            continue
        sites = list(r.sites)
        if len(sites) > max_sites_per_region:
            must = [s for s in dict.fromkeys(needed[ri]) if s in set(sites)]
            rest = sorted((s for s in sites if s not in set(must)),
                          key=lambda n: (-fleet.site(n).edge.flops_per_s, n))
            sites = (must + rest)[:max(max_sites_per_region, len(must))]
        out.append(RegionPartition(region=r.name, services=tuple(svcs),
                                   sites=tuple(sites)))
    return out


def _partition_from_screener(screener, fleet,
                             max_sites_per_region: int
                             ) -> List[RegionPartition]:
    farm_site_of = {s: screener.site_names[sv["farm_site"]]
                    for s, sv in screener._svc.items()}
    return partition_services(fleet, screener.topology, farm_site_of,
                              max_sites_per_region)


def _block_rows(n_opts: int, width: int, enumerate_limit: int,
                sample_budget: int, seed: int) -> np.ndarray:
    """All option-index rows of one region's block when the space
    enumerates under the limit, else a seeded sample."""
    space = n_opts ** width
    if space <= enumerate_limit:
        grids = np.meshgrid(*([np.arange(n_opts)] * width), indexing="ij")
        return np.stack(grids, axis=-1).reshape(-1, width)
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_opts, size=(sample_budget, width))


def _home_edge_plan(partitions: Sequence[RegionPartition],
                    topology: Mapping[str, Sequence[str]],
                    farm_site_of: Mapping[str, str]) -> PlacementPlan:
    """Every chain on its root's farm site — the natural all-edge anchor
    at fleet scale (one all-edge plan per site would be 500 anchors)."""
    out = {}
    for part in partitions:
        for svc in part.services:
            root = _root_of(svc, topology)
            out[svc] = ServicePlacement(farm_site_of[root])
    return PlacementPlan(out)


def region_search(cosim,
                  chips_options: Sequence[int] = (4, 8),
                  dvfs_options: Sequence[float] = (1.0,),
                  seed: int = 0,
                  partitions: Optional[Sequence[RegionPartition]] = None,
                  max_sites_per_region: int = 12,
                  sweeps: int = 2,
                  final_k: int = 6,
                  enumerate_limit: int = 65536,
                  sample_budget: int = 2048,
                  evaluator: Optional[Evaluator] = None,
                  warm_start: Optional[PlacementPlan] = None,
                  ensemble=None, risk="cvar",
                  corrections=None) -> SearchResult:
    """Decomposed screened search over a hierarchical fleet (see the
    module docstring for the three-stage structure). ``warm_start``
    seeds the block-coordinate pass (the online controller passes its
    incumbent); ``ensemble`` + ``risk`` optionally rank the finalists
    by a fluid drift ensemble before the exact tier, exactly like
    ``robust_search``. Deterministic for a fixed seed."""
    ev = evaluator or Evaluator(cosim)
    screener = ev.screener
    if screener is None:
        raise ValueError(f"{type(cosim).__name__} exposes no "
                         "screening_model; use region_search_exact")
    hits0, misses0 = ev.hits, ev.misses
    fleet = cosim.cfg.fleet if hasattr(cosim, "cfg") else cosim.fleet
    if partitions is None:
        partitions = _partition_from_screener(screener, fleet,
                                              max_sites_per_region)
    order = list(screener.order)
    rank = {s: i for i, s in enumerate(order)}
    farm_site_of = {s: screener.site_names[sv["farm_site"]]
                    for s, sv in screener._svc.items()}

    # global option table: every region's candidate sites + the DC grid.
    # Option indices are shared across regions so one full-width matrix
    # can hold any composition of per-region blocks.
    all_sites: List[str] = []
    for part in partitions:
        for s in part.sites:
            if s not in all_sites:
                all_sites.append(s)
    # warm-start / anchor placements may sit on sites outside the capped
    # candidate lists — keep them representable
    for plan in ([warm_start] if warm_start is not None else []):
        for p in plan.assignments.values():
            if p.is_edge and p.site not in all_sites:
                all_sites.append(p.site)
    options = service_options(chips_options, dvfs_options, all_sites)
    if warm_start is not None:
        # warm-start DC placements may use chips/DVFS outside the grid
        known = {(o.site, o.chips if not o.is_edge else 0,
                  o.dvfs_f if not o.is_edge else 0.0) for o in options}
        for p in warm_start.assignments.values():
            k = (p.site, p.chips if not p.is_edge else 0,
                 p.dvfs_f if not p.is_edge else 0.0)
            if k not in known:
                known.add(k)
                options.append(p)
    opt_idx = {(o.site, o.chips if not o.is_edge else 0,
                o.dvfs_f if not o.is_edge else 0.0): i
               for i, o in enumerate(options)}
    dc_opts = [i for i, o in enumerate(options) if not o.is_edge]
    site_opt = {o.site: i for i, o in enumerate(options) if o.is_edge}

    def row_of(plan: PlacementPlan) -> np.ndarray:
        row = np.empty(len(order), dtype=int)
        for si, s in enumerate(order):
            p = plan.placement(s)
            row[si] = opt_idx[(p.site, p.chips if not p.is_edge else 0,
                               p.dvfs_f if not p.is_edge else 0.0)]
        return row

    prev_corr = (screener.set_corrections(corrections)
                 if corrections is not None else None)
    t0 = time.perf_counter()
    region_stats: Dict[str, Dict] = {}
    runner_up: Dict[str, List[np.ndarray]] = {}
    try:
        # start: warm incumbent or the first-DC-option anchor
        cur = row_of(warm_start) if warm_start is not None else row_of(
            PlacementPlan.all_dc(order, chips=chips_options[0],
                                 dvfs_f=dvfs_options[0]))
        screened = 0
        for sweep in range(max(1, sweeps)):
            for ri, part in enumerate(partitions):
                cols = [rank[s] for s in part.services]
                # this region's choice set: its own edge sites + the DC
                sub = [site_opt[s] for s in part.sites] + dc_opts
                space_r = len(sub) ** len(cols)
                top_k_r = _default_top_k(space_r, enumerate_limit)
                B = _block_rows(len(sub), len(cols), enumerate_limit,
                                sample_budget,
                                seed * 7919 + sweep * 131 + ri)
                sub_arr = np.asarray(sub)
                P = np.tile(cur, (len(B), 1))
                P[:, cols] = sub_arr[B]
                # delta-aware: only this region's columns vary, so the
                # pinned complement is scored once (bit-identical to the
                # dense screen_matrix; see ScreeningModel.score_block)
                scores = ev.screen_block(P, cols, options)
                screened += len(P)
                best_rows = np.argsort(-scores, kind="stable")
                cur = P[best_rows[0]].copy()
                # the region's screening shortlist beyond the winner
                # feeds the finalist swaps; its depth scales with the
                # region's own block space
                runner_up[part.region] = [P[i].copy()
                                          for i in best_rows[1:top_k_r]]
                region_stats[part.region] = {
                    "services": len(cols),
                    "candidate_sites": len(part.sites),
                    "space": int(space_r),
                    "top_k": int(top_k_r),
                    "screened": int(len(P)),
                    "best_screen_vos": float(scores[best_rows[0]]),
                }
    finally:
        if corrections is not None:
            screener.set_corrections(prev_corr)
    screen_wall = time.perf_counter() - t0

    def plan_of(row: np.ndarray) -> PlacementPlan:
        return PlacementPlan({s: options[int(row[si])]
                              for si, s in enumerate(order)})

    # finalists: composed winner + single-region runner-up swaps, round-
    # robin over regions so every region's shortlist is represented
    finalists: List[PlacementPlan] = [plan_of(cur)]
    for depth in range(max(len(v) for v in runner_up.values())
                       if runner_up else 0):
        for part in partitions:
            alts = runner_up.get(part.region, [])
            if depth >= len(alts):
                continue
            row = cur.copy()
            cols = [rank[s] for s in part.services]
            row[cols] = alts[depth][cols]
            finalists.append(plan_of(row))
    seen = set()
    finalists = [p for p in finalists
                 if not (p.key() in seen or seen.add(p.key()))]
    finalists = finalists[:max(1, final_k)]

    anchors = [PlacementPlan.all_dc(order, chips=c, dvfs_f=dvfs_options[0])
               for c in chips_options]
    anchors.append(_home_edge_plan(partitions, screener.topology,
                                   farm_site_of))
    if warm_start is not None:
        anchors.append(warm_start)

    robust_stats = None
    if ensemble is not None:
        from repro_torch.fluid.robust import RiskSpec, risk_score
        rs = RiskSpec.of(risk if risk is not None else "mean")
        fin_keys = {p.key() for p in finalists}
        cands = finalists + [a for a in anchors if a.key() not in fin_keys]
        t1 = time.perf_counter()
        fr = ensemble.evaluate(cands, corrections=corrections)
        fluid_wall = time.perf_counter() - t1
        scores = risk_score(fr.vos, rs)
        ordr = np.argsort(-scores, kind="stable")
        finalists = [cands[i] for i in ordr[:max(1, final_k)]]
        robust_stats = {"risk": rs.label,
                        "ensemble": int(ensemble.n_realizations),
                        "candidates": len(cands),
                        "fluid_wall_s": round(fluid_wall, 4)}

    # exact tier: DES on finalists + anchors (memoized; a parallel
    # evaluator fans the uncached ones out, merge order is fixed)
    best_plan: Optional[PlacementPlan] = None
    best = None
    for plan, res in zip(finalists + anchors,
                         ev.evaluate_batch(finalists + anchors)):
        if best is None or _score(res) > _score(best):
            best_plan, best = plan, res
    assert best_plan is not None and best is not None

    screen_stats = {
        "space": int(sum(r["space"] for r in region_stats.values())),
        "screened": int(screened),
        "screen_wall_s": round(screen_wall, 4),
        "regions": region_stats,
        "sweeps": int(max(1, sweeps)),
        "finalists": len(finalists),
        "anchors": len(anchors),
        "warm_started": warm_start is not None,
        "calibrated": corrections is not None,
        "agreement": bool(finalists
                          and finalists[0].key() == best_plan.key()),
    }
    delta = getattr(screener, "delta_stats", None)
    if delta is not None:
        screen_stats["delta"] = delta()
    if robust_stats is not None:
        screen_stats["robust"] = robust_stats
    method = ("region-screened" if ensemble is None
              else "region-screened+fluid")
    return SearchResult(best_plan, best, method, ev.misses - misses0,
                        ev.history, screen=screen_stats,
                        cache_hits=ev.hits - hits0,
                        cache_misses=ev.misses - misses0)


def region_search_exact(model,
                        chips_options: Sequence[int] = (4, 8),
                        dvfs_options: Sequence[float] = (1.0,),
                        seed: int = 0,
                        partitions: Optional[Sequence[RegionPartition]]
                        = None,
                        max_sites_per_region: int = 12,
                        sweeps: int = 2,
                        evaluator: Optional[Evaluator] = None,
                        warm_start: Optional[PlacementPlan] = None
                        ) -> SearchResult:
    """Analytic block-coordinate twin of :func:`region_search` for
    scorers without a screening model (the online ``ForecastModel``):
    per-service greedy descent restricted to each service's own region
    sites + the DC grid, swept region by region, warm-started from the
    incumbent. Every evaluation is an O(services) model call, so an
    epoch's re-plan costs ``sweeps × Σ_r services_r × options_r`` calls
    instead of a cold joint search."""
    ev = evaluator or Evaluator(model)
    hits0, misses0 = ev.hits, ev.misses
    info = model.info
    fleet = info.fleet
    if partitions is None:
        farm_site_of = {s: fleet.farm_site(i.queue)
                        for s, i in info.services.items()}
        partitions = partition_services(fleet, model.topology, farm_site_of,
                                        max_sites_per_region)
    names = [s for part in partitions for s in part.services]

    farm_site_of = {s: fleet.farm_site(i.queue)
                    for s, i in info.services.items()}
    if warm_start is not None:
        current = warm_start
    else:
        current = PlacementPlan.all_dc(names, chips=chips_options[0],
                                       dvfs_f=dvfs_options[0])
    score = _score(ev(current))

    for _ in range(max(1, sweeps)):
        improved = False
        for part in partitions:
            opts = service_options(chips_options, dvfs_options, part.sites)
            for svc in part.services:
                for opt in opts:
                    if opt == current.assignments[svc]:
                        continue
                    cand = current.with_placement(svc, opt)
                    s = _score(ev(cand))
                    if s > score:
                        current, score = cand, s
                        improved = True
        if not improved:
            break

    # anchors keep the exact guarantee: searched >= home-edge / all-DC
    anchors = [PlacementPlan.all_dc(names, chips=c, dvfs_f=dvfs_options[0])
               for c in chips_options]
    anchors.append(_home_edge_plan(partitions, model.topology,
                                   farm_site_of))
    best_plan, best = current, ev(current)
    for plan, res in zip(anchors, ev.evaluate_batch(anchors)):
        if _score(res) > _score(best):
            best_plan, best = plan, res
    region_stats = {part.region: {"services": len(part.services),
                                  "candidate_sites": len(part.sites)}
                    for part in partitions}
    return SearchResult(best_plan, best, "region-exact",
                        ev.misses - misses0, ev.history,
                        screen={"regions": region_stats,
                                "warm_started": warm_start is not None},
                        cache_hits=ev.hits - hits0,
                        cache_misses=ev.misses - misses0)
