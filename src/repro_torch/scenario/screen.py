"""Tier-1 plan screening: score whole batches of placement plans in
vectorized numpy passes over the placement-independent fire trace.

The unified engine drives the functional dataflow exactly once per
scenario (the fire trace — timestamps, window sizes, newly-covered
record counts and their origins — does not depend on placement). A
:class:`ScreeningModel` precomputes per-service, per-placement-option
arrays from that trace (fire durations, energies, energy-curve values)
and evaluates the latency / energy / VoS of N candidate plans as array
ops, folding in the same analytic queueing terms the online
controller's ``ForecastModel`` uses (device saturation, shared-uplink
serialization load, DC composition pressure, serial-device rank
blocking) — but trace-driven rather than rate-driven, so actual window
sizes and fire counts are respected.

The screen is a *ranking* model: the exact DES engine re-scores only
the top-K screened survivors (plus the anchors / incumbent), which
bounds the damage of any screening mis-rank — see
``repro_torch.placement.search.screened_search``. Screening is deterministic
(pure array math, no RNG).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.placement.plan import SITE_DC, PlacementPlan, ServicePlacement
from repro_torch.region.hier import regions_view

# Deterministic-arrival queueing inflation lives in
# repro_torch.scenario.queueing (one knee shared by ForecastModel, this
# screen, and the fluid engine); re-exported here for callers that
# historically imported it from the screen.
from repro_torch.scenario.queueing import (  # noqa: F401  (re-export)
    NEVER_S, Q_CLIFF, Q_KNEE, q_factor, q_factor_np as _q_factor,
)


@dataclasses.dataclass
class ScreenResult:
    """Duck-typed stand-in for CoSimResult (what the search scorer
    reads); ``vos`` here is the *screened* estimate, not DES truth."""
    vos: float
    feasible: bool
    plan_label: str = ""
    infeasible_reason: str = ""


@dataclasses.dataclass
class _OptionData:
    """Per-(service, option) trace arrays."""
    dur: np.ndarray       # per-fire service time on this option
    v_e: np.ndarray       # per-fire energy-curve value (plan-independent)
    busy: float           # dur.sum() — device / VDC occupancy seconds
    mean_dur: float


class ScreeningModel:
    """Vectorized batch scorer over one compiled scenario's fire trace.

    Built via :meth:`ScenarioEngine.screening_model` (cached on the
    engine, sharing its one functional drive). ``score_batch`` maps a
    sequence of plans to screened VoS estimates; ``score_matrix`` is
    the allocation-free core for index-matrix candidates (what the
    sampled / hill-climbing search uses on large fleets).

    ``set_corrections`` installs per-service forecast-calibration terms
    (:class:`~repro_torch.scenario.feedback.ServiceCorrection`, duck-typed:
    ``q_mult`` / ``lat_bias_s`` / ``drop_offset``): each service's
    per-fire latency matrix is mapped through ``q_mult·lat + bias`` and
    its value scaled by ``1 − drop_offset`` before summation, so tier-1
    ranking uses the same calibrated terms as the online controller's
    ``ForecastModel`` — ``screened_search`` threads them through per
    search and restores the previous state afterwards. With no
    corrections installed the scores are bit-identical to the
    uncalibrated model.
    """

    def __init__(self, engine, corrections=None):
        engine._ensure_driven()
        _, staps, _ = engine._driven
        cfg = engine.cfg
        self.engine = engine
        self.order: List[str] = list(engine.order)
        self.rank = {s: i for i, s in enumerate(self.order)}
        self.topology = engine.topology
        self.horizon_s = float(cfg.horizon_s)
        self.grid_chips = cfg.grid_shape[0] * cfg.grid_shape[1]
        self.records_per_step = cfg.records_per_step
        self.cost = engine.cost

        fleet = cfg.fleet
        self.site_names: List[str] = list(fleet.site_names)
        self._site_idx = {n: j for j, n in enumerate(self.site_names)}
        self._edge = [fleet.site(n).edge for n in self.site_names]
        self._link = [fleet.site(n).link for n in self.site_names]
        self._ram = np.array([e.ram_bytes for e in self._edge])
        user = self._site_idx[fleet.result_site]
        self.dl_user_s = (self._link[user].rtt_s / 2
                          + self._link[user].result_bytes
                          / self._link[user].downlink_bps)

        # hierarchy: per-region edge tiers + RAP trunks. A flat fleet is
        # the degenerate single transparent region — every added term is
        # zero there and the screened scores stay bit-identical.
        regions = regions_view(fleet)
        self.n_regions = len(regions)
        self.region_names: List[str] = [r.name for r in regions]
        rmap = {s: i for i, r in enumerate(regions) for s in r.sites}
        self._region_of = np.array([rmap[n] for n in self.site_names],
                                   dtype=int)
        self._rap = [None if r.transparent else r.rap for r in regions]
        self._hier = any(r is not None for r in self._rap)
        nsites = len(self.site_names)
        # one-result trunk legs per *site* (src-up / dst-down), so the
        # hop term can index them vectorized
        self._rap_res_up = np.zeros(nsites)
        self._rap_res_dn = np.zeros(nsites)
        for j in range(nsites):
            rap = self._rap[self._region_of[j]]
            if rap is not None:
                self._rap_res_up[j] = (rap.rtt_s / 2
                                       + self._link[j].result_bytes
                                       / rap.uplink_bps)
                self._rap_res_dn[j] = (rap.rtt_s / 2
                                       + self._link[j].result_bytes
                                       / rap.downlink_bps)
        rap_u = self._rap[self._region_of[user]]
        if rap_u is not None:
            # DC results ride the user's region trunk down before the
            # last-mile downlink (mirrors Fleet.downlink_time)
            self.dl_user_s += (rap_u.rtt_s / 2
                               + self._link[user].result_bytes
                               / rap_u.downlink_bps)

        self._svc: Dict[str, Dict] = {}
        for s in self.order:
            prof = engine.profiles[s]
            info = engine.services_info[s]
            fires = staps[s].fires
            nw = np.array([f.n_window for f in fires], dtype=float)
            origin_keys = [None] + list(self.topology[s])
            origins = {k: np.array([f.origins.get(k, 0) for f in fires],
                                   dtype=float) for k in origin_keys}
            spec = prof.slo.value_spec()
            self._svc[s] = {
                "profile": prof, "info": info, "nw": nw,
                "origins": origins, "spec": spec,
                "farm_site": self._site_idx[fleet.farm_site(info.queue)],
                "budget": float(info.buffer_budget),
                "slide": float(info.slide_s),
            }
        self._opt_cache: Dict[Tuple, _OptionData] = {}
        self._corr: Dict[str, object] = dict(corrections or {})
        self._corr_gen = 0          # bumped per set_corrections (memo key)
        self._pin_cache: Dict[Tuple, Dict] = {}
        # delta-screening telemetry (see score_block)
        self.delta_calls = 0
        self.dense_fallbacks = 0
        self.delta_pin_hits = 0
        self.delta_pin_misses = 0
        self.delta_cells_saved = 0

    def set_corrections(self, corrections) -> Dict[str, object]:
        """Install (or with ``None`` clear) per-service calibration
        corrections; returns the previously installed mapping so a
        caller can restore it."""
        prev = self._corr
        self._corr = dict(corrections or {})
        self._corr_gen += 1
        return prev

    def delta_stats(self) -> Dict[str, int]:
        """Cumulative delta-screening counters (honest accounting: a
        dense fallback is counted, never hidden)."""
        return {"delta_calls": self.delta_calls,
                "dense_fallbacks": self.dense_fallbacks,
                "pin_hits": self.delta_pin_hits,
                "pin_misses": self.delta_pin_misses,
                "cells_saved": self.delta_cells_saved}

    # ------------------------------------------------------ option tables
    def _opt(self, svc: str, p: ServicePlacement) -> _OptionData:
        key = (svc, p.site, p.chips if not p.is_edge else 0,
               p.dvfs_f if not p.is_edge else 0.0)
        d = self._opt_cache.get(key)
        if d is not None:
            return d
        sv = self._svc[svc]
        nw, prof, spec = sv["nw"], sv["profile"], sv["spec"]
        if p.is_edge:
            e = self._edge[self._site_idx[p.site]]
            dur = (np.maximum(nw / e.throughput_rps,
                              nw * prof.flops_per_record / e.flops_per_s)
                   + e.fire_overhead_s)
            energy = nw * e.energy_per_record_j + dur * e.active_power_w
        else:
            steps = np.maximum(1.0, np.ceil(nw / self.records_per_step))
            t_step = self.cost.time_per_step(f"svc:{svc}", "window",
                                             p.chips, p.dvfs_f)
            dur = steps * t_step
            energy = steps * self.cost.energy_per_step(
                f"svc:{svc}", "window", p.chips, p.dvfs_f)
        d = _OptionData(dur=dur, v_e=spec.energy_curve.value_array(energy),
                        busy=float(dur.sum()),
                        mean_dur=float(dur.mean()) if len(dur) else 0.0)
        self._opt_cache[key] = d
        return d

    # --------------------------------------------------------------- core
    def score_matrix(self, P: np.ndarray,
                     options: Sequence[ServicePlacement]) -> np.ndarray:
        """Screened VoS for ``P[n, s]`` = option index of service
        ``order[s]`` in plan ``n``. Infeasible plans (site RAM) score
        ``-inf``. Deterministic. Every term is per-plan, so the batch
        is chunked along the plan axis to bound the O(plans × fires)
        temporaries (a 65k-plan enumeration over a small-slide trace
        would otherwise allocate multi-GB latency matrices)."""
        max_fires = max((len(sv["nw"]) for sv in self._svc.values()),
                        default=1)
        chunk = max(256, 2_000_000 // max(1, max_fires))
        if len(P) > chunk:
            return np.concatenate(
                [self._score_chunk(P[i:i + chunk], options)
                 for i in range(0, len(P), chunk)])
        return self._score_chunk(P, options)

    def _score_chunk(self, P: np.ndarray,
                     options: Sequence[ServicePlacement]) -> np.ndarray:
        N, S = P.shape
        assert S == len(self.order)
        nsites = len(self.site_names)
        site_for = np.array([self._site_idx.get(o.site, -1)
                             for o in options])        # -1 = DC
        chips_for = np.array([o.chips if not o.is_edge else 0
                              for o in options])

        # plan-level context terms -------------------------------------
        util = np.zeros((N, nsites))
        dc_demand = np.zeros(N)
        ram_need = np.zeros((N, nsites))
        up_load = np.zeros((N, self.n_regions))   # per-region edge tier
        rap_load = np.zeros((N, self.n_regions))  # per-region RAP trunk
        exec_site = np.empty((N, S), dtype=int)   # -1 = DC
        for si, s in enumerate(self.order):
            col = P[:, si]
            exec_site[:, si] = site_for[col]
            sv = self._svc[s]
            for o in np.unique(col):
                mask = col == o
                d = self._opt(s, options[o])
                j = site_for[o]
                if j >= 0:
                    util[mask, j] += d.busy / self.horizon_s
                    ram_need[mask, j] += (sv["budget"]
                                          * self._edge[j].record_bytes)
                else:
                    dc_demand[mask] += chips_for[o] * d.busy / self.horizon_s

        # shared-pipe serialization load: raw records hauled off their
        # origin site load the origin *region's* edge tier (flat fleets:
        # the one region = the one shared uplink, bit-identically), and
        # region-leaving moves additionally load the origin RAP trunk
        for si, s in enumerate(self.order):
            sv = self._svc[s]
            dst = exec_site[:, si]
            for okey, counts in sv["origins"].items():
                total = float(counts.sum())
                if total == 0.0:
                    continue
                osite = (np.full(N, sv["farm_site"]) if okey is None
                         else exec_site[:, self.rank[okey]])
                for j in np.unique(osite):
                    if j < 0:
                        continue
                    m = (osite == j) & (dst != j)
                    if not m.any():
                        continue
                    ln = self._link[j]
                    rj = self._region_of[j]
                    wire = total * ln.record_bytes * ln.compression
                    up_load[m, rj] += wire / ln.uplink_bps / self.horizon_s
                    rap = self._rap[rj]
                    if rap is not None:
                        dstm = dst[m]
                        crossing = ((dstm < 0) | (self._region_of[
                            np.clip(dstm, 0, None)] != rj))
                        rows = np.where(m)[0][crossing]
                        rap_load[rows, rj] += (wire / rap.uplink_bps
                                               / self.horizon_s)

        q_site = _q_factor(util)
        q_up = _q_factor(up_load)
        q_rap = _q_factor(rap_load)
        dc_over = np.maximum(1.0, dc_demand / self.grid_chips)
        feasible = (ram_need <= self._ram[None, :]).all(axis=1)

        # serial-device rank blocking: a service queued behind an
        # earlier-rank co-located service eats its fire time
        rank_wait = np.zeros((N, S))
        for si, s in enumerate(self.order):
            slide_s = self._svc[s]["slide"]
            for oi, o in enumerate(self.order):
                if oi >= si:
                    continue
                both = ((exec_site[:, si] >= 0)
                        & (exec_site[:, oi] == exec_site[:, si]))
                if not both.any():
                    continue
                align = min(1.0, slide_s / self._svc[o]["slide"])
                col = P[:, oi]
                for opt in np.unique(col[both]):
                    m = both & (col == opt)
                    rank_wait[m, si] += align * self._opt(
                        o, options[opt]).mean_dur

        # upstream result-handoff hop (max over upstream cuts; a DC
        # destination pays nothing extra here — its downlink is folded
        # into dl_user, exactly like ForecastModel)
        hop = np.zeros((N, S))
        rtt = np.array([self._link[j].rtt_s for j in range(nsites)])
        for si, s in enumerate(self.order):
            my = exec_site[:, si]
            rtt_my = np.where(my >= 0, rtt[np.clip(my, 0, None)], 0.0)
            for u in self.topology[s]:
                us = exec_site[:, self.rank[u]]
                rtt_us = np.where(us >= 0, rtt[np.clip(us, 0, None)], 0.0)
                h = np.where((us != my) & (my >= 0),
                             rtt_my / 2 + np.where(us >= 0, rtt_us / 2, 0.0),
                             0.0)
                if self._hier:
                    # cross-region (or DC-transiting) result handoffs
                    # additionally ride the src RAP up and dst RAP down
                    r_my = self._region_of[np.clip(my, 0, None)]
                    r_us = self._region_of[np.clip(us, 0, None)]
                    crossing = (us < 0) | (my < 0) | (r_us != r_my)
                    extra = (np.where(crossing & (us >= 0),
                                      self._rap_res_up[np.clip(us, 0, None)],
                                      0.0)
                             + np.where(crossing & (my >= 0),
                                        self._rap_res_dn[np.clip(my, 0, None)],
                                        0.0))
                    h = h + np.where((us != my) & (my >= 0), extra, 0.0)
                hop[:, si] = np.maximum(hop[:, si], h)

        # per-service, per-option value accumulation -------------------
        vos = np.zeros(N)
        for si, s in enumerate(self.order):
            sv = self._svc[s]
            spec = sv["spec"]
            col = P[:, si]
            dst = exec_site[:, si]
            # cross-site raw-record haul / edge→DC transfer, per fire
            # per plan (depends on the origin sites, i.e. the plan)
            haul = np.zeros((N, len(sv["nw"])))
            for okey, counts in sv["origins"].items():
                if not counts.any():
                    continue
                osite = (np.full(N, sv["farm_site"]) if okey is None
                         else exec_site[:, self.rank[okey]])
                for j in np.unique(osite):
                    if j < 0:
                        continue
                    m = (osite == j) & (dst != j)
                    if not m.any():
                        continue
                    ln = self._link[j]
                    rj = self._region_of[j]
                    wire = counts * ln.record_bytes * ln.compression
                    leg = (ln.rtt_s / 2
                           + wire[None, :] / ln.uplink_bps
                           * q_up[m, rj][:, None])
                    rap = self._rap[rj]
                    if rap is not None:
                        # region-leaving hauls ride the origin RAP trunk
                        # (contended) on top of the edge-tier leg
                        dstm = dst[m]
                        crossing = ((dstm < 0) | (self._region_of[
                            np.clip(dstm, 0, None)] != rj))
                        if crossing.any():
                            leg[crossing] = (leg[crossing] + rap.rtt_s / 2
                                             + wire[None, :] / rap.uplink_bps
                                             * q_rap[m, rj][crossing, None])
                    # onto another edge site: relay over its downlink
                    # (cross-region: plus its region's RAP trunk down)
                    e_m = m & (dst >= 0)
                    if e_m.any():
                        dn = np.zeros((int(e_m.sum()), len(counts)))
                        sub = dst[e_m]
                        for jj in np.unique(sub):
                            lnd = self._link[jj]
                            sel = sub == jj
                            dn[sel] = (lnd.rtt_s / 2
                                       + counts[None, :]
                                       * lnd.record_bytes
                                       / lnd.downlink_bps)
                            rapd = self._rap[self._region_of[jj]]
                            if rapd is not None and self._region_of[jj] != rj:
                                dn[sel] += (rapd.rtt_s / 2
                                            + counts[None, :]
                                            * lnd.record_bytes
                                            / rapd.downlink_bps)
                        haul[e_m] += leg[dst[m] >= 0] + dn
                    d_m = m & (dst < 0)
                    if d_m.any():
                        haul[d_m] += leg[dst[m] < 0]
            cal = self._corr.get(s)
            for o in np.unique(col):
                mask = col == o
                d = self._opt(s, options[o])
                j = site_for[o]
                if j >= 0:
                    lat = ((d.dur[None, :] + rank_wait[mask, si, None])
                           * q_site[mask, j, None]
                           + hop[mask, si, None] + haul[mask])
                else:
                    lat = (haul[mask]
                           + d.dur[None, :] * dc_over[mask, None]
                           + self.dl_user_s)
                corr = cal.tier(j >= 0) if cal is not None else None
                if corr is not None:
                    # calibrated latency (same per-service, per-tier map
                    # as the online ForecastModel; never negative)
                    lat = np.maximum(
                        corr.q_mult * lat + corr.lat_bias_s, 0.0)
                v_p = spec.perf_curve.value_array(lat)
                v = np.where((v_p > 0.0) & (d.v_e[None, :] > 0.0),
                             spec.gamma * (spec.w_p * v_p
                                           + spec.w_e * d.v_e[None, :]),
                             0.0)
                if corr is not None and corr.drop_offset > 0.0:
                    v = v * max(0.0, 1.0 - corr.drop_offset)
                vos[mask] += v.sum(axis=1)
        vos[~feasible] = float("-inf")
        return vos

    # ------------------------------------------------- delta screening
    def _delta_guard(self, P: np.ndarray, cols: Sequence[int],
                     pinned: Sequence[int], site_for: np.ndarray
                     ) -> bool:
        """True when the block/pinned split decomposes exactly:

        * every pinned column really is constant across the batch;
        * the service DAG never crosses the split (a block service's
          upstreams are all in the block, a pinned service's are all
          pinned), so hop / haul / shared-pipe terms never mix;
        * the *regions* touched by the block (candidate edge sites +
          record-producing farm sites) are disjoint from the regions
          the pinned services occupy or haul from, so every util /
          RAM / edge-tier / RAP-trunk column is fed by only one side
          and the float accumulation order matches the dense pass.

        When any condition fails ``score_block`` falls back to the
        dense ``score_matrix`` — correctness never depends on the
        caller picking a clean block.
        """
        base = P[0]
        if not (P[:, list(pinned)] == base[list(pinned)]).all():
            return False
        colset = set(cols)
        for si, s in enumerate(self.order):
            ups = [self.rank[u] for u in self.topology[s]]
            if si in colset:
                if not all(u in colset for u in ups):
                    return False
            elif any(u in colset for u in ups):
                return False
        block_sites = {int(j) for j in site_for[np.unique(P[:, list(cols)])]
                       if j >= 0}
        for si in cols:
            sv = self._svc[self.order[si]]
            farm_counts = sv["origins"].get(None)
            if farm_counts is not None and farm_counts.any():
                block_sites.add(sv["farm_site"])
        pinned_sites = set()
        for si in pinned:
            j = int(site_for[int(base[si])])
            if j >= 0:
                pinned_sites.add(j)
            sv = self._svc[self.order[si]]
            farm_counts = sv["origins"].get(None)
            if farm_counts is not None and farm_counts.any():
                pinned_sites.add(sv["farm_site"])
        block_regions = {int(self._region_of[j]) for j in block_sites}
        pinned_regions = {int(self._region_of[j]) for j in pinned_sites}
        return not (block_regions & pinned_regions)

    def _hop_scalar(self, s: str, exec_base: np.ndarray) -> float:
        """Upstream handoff hop for one service of a single constant
        row — mirrors the dense hop block term by term."""
        si = self.rank[s]
        my = int(exec_base[si])
        rtt_my = self._link[my].rtt_s if my >= 0 else 0.0
        hop = 0.0
        for u in self.topology[s]:
            us = int(exec_base[self.rank[u]])
            if us == my or my < 0:
                continue
            rtt_us = self._link[us].rtt_s if us >= 0 else 0.0
            h = rtt_my / 2 + (rtt_us / 2 if us >= 0 else 0.0)
            if self._hier:
                r_my = int(self._region_of[max(my, 0)])
                r_us = int(self._region_of[max(us, 0)])
                crossing = (us < 0) or (my < 0) or (r_us != r_my)
                extra = ((self._rap_res_up[max(us, 0)]
                          if crossing and us >= 0 else 0.0)
                         + (self._rap_res_dn[max(my, 0)]
                            if crossing and my >= 0 else 0.0))
                h = h + extra
            hop = max(hop, h)
        return hop

    def _haul_row(self, s: str, exec_base: np.ndarray,
                  q_up_pin: np.ndarray, q_rap_pin: np.ndarray
                  ) -> np.ndarray:
        """Per-fire cross-site haul latency of one pinned service
        (constant across the batch) — mirrors the dense haul block."""
        sv = self._svc[s]
        dst = int(exec_base[self.rank[s]])
        haul = np.zeros(len(sv["nw"]))
        for okey, counts in sv["origins"].items():
            if not counts.any():
                continue
            oj = (sv["farm_site"] if okey is None
                  else int(exec_base[self.rank[okey]]))
            if oj < 0 or dst == oj:
                continue
            ln = self._link[oj]
            rj = int(self._region_of[oj])
            wire = counts * ln.record_bytes * ln.compression
            leg = ln.rtt_s / 2 + wire / ln.uplink_bps * q_up_pin[rj]
            rap = self._rap[rj]
            if rap is not None:
                crossing = (dst < 0
                            or int(self._region_of[dst]) != rj)
                if crossing:
                    leg = (leg + rap.rtt_s / 2
                           + wire / rap.uplink_bps * q_rap_pin[rj])
            if dst >= 0:
                lnd = self._link[dst]
                dn = (lnd.rtt_s / 2
                      + counts * lnd.record_bytes / lnd.downlink_bps)
                rapd = self._rap[self._region_of[dst]]
                if rapd is not None and int(self._region_of[dst]) != rj:
                    dn = dn + (rapd.rtt_s / 2
                               + counts * lnd.record_bytes
                               / rapd.downlink_bps)
                haul += leg + dn
            else:
                haul += leg
        return haul

    def _pinned_bundle(self, cols_key: Tuple[int, ...], base: np.ndarray,
                       options: Sequence[ServicePlacement],
                       site_for: np.ndarray) -> Dict:
        """Everything about the pinned services that depends only on
        the constant part of the batch row: single-row context terms,
        queueing factors, rank waits, hops, and — for edge-resident
        pinned services — the finished per-service VoS scalar. Memoized
        on (block columns, pinned row, calibration generation), so
        successive block-coordinate sweeps that revisit a region with
        an unchanged complement reuse it outright."""
        pinned = [si for si in range(len(self.order)) if si not in cols_key]
        # keyed on the pinned *placements*, not option indices — the
        # same model can be called with differently ordered option
        # tables and a stale index-keyed hit would score the wrong plan
        key = (cols_key, self._corr_gen, tuple(
            (o.site, o.chips if not o.is_edge else 0,
             o.dvfs_f if not o.is_edge else 0.0)
            for o in (options[int(base[si])] for si in pinned)))
        hit = self._pin_cache.get(key)
        if hit is not None:
            self.delta_pin_hits += 1
            return hit
        self.delta_pin_misses += 1
        h = self.horizon_s
        nsites = len(self.site_names)
        exec_base = np.array([int(site_for[int(base[si])])
                              for si in range(len(self.order))])
        util_pin = np.zeros(nsites)
        ram_pin = np.zeros(nsites)
        upl_pin = np.zeros(self.n_regions)
        rapl_pin = np.zeros(self.n_regions)
        for si in pinned:
            s = self.order[si]
            sv = self._svc[s]
            o = int(base[si])
            d = self._opt(s, options[o])
            j = int(site_for[o])
            if j >= 0:
                util_pin[j] += d.busy / h
                ram_pin[j] += sv["budget"] * self._edge[j].record_bytes
        for si in pinned:
            s = self.order[si]
            sv = self._svc[s]
            dst = int(exec_base[si])
            for okey, counts in sv["origins"].items():
                total = float(counts.sum())
                if total == 0.0:
                    continue
                oj = (sv["farm_site"] if okey is None
                      else int(exec_base[self.rank[okey]]))
                if oj < 0 or dst == oj:
                    continue
                ln = self._link[oj]
                rj = int(self._region_of[oj])
                wire = total * ln.record_bytes * ln.compression
                upl_pin[rj] += wire / ln.uplink_bps / h
                rap = self._rap[rj]
                if rap is not None:
                    if dst < 0 or int(self._region_of[dst]) != rj:
                        rapl_pin[rj] += wire / rap.uplink_bps / h
        q_site_pin = _q_factor(util_pin)
        q_up_pin = _q_factor(upl_pin)
        q_rap_pin = _q_factor(rapl_pin)
        ram_ok = bool((ram_pin <= self._ram).all())
        # pinned×pinned rank blocking (block services can never share a
        # site with a pinned service under the delta guard)
        rw_pin = {si: 0.0 for si in pinned}
        for si in pinned:
            s = self.order[si]
            slide_s = self._svc[s]["slide"]
            my = int(exec_base[si])
            if my < 0:
                continue
            for oi in pinned:
                if oi >= si or int(exec_base[oi]) != my:
                    continue
                o = self.order[oi]
                align = min(1.0, slide_s / self._svc[o]["slide"])
                rw_pin[si] += align * self._opt(
                    o, options[int(base[oi])]).mean_dur
        hop_pin = {si: self._hop_scalar(self.order[si], exec_base)
                   for si in pinned}
        edge_vos: Dict[int, float] = {}
        dc_pieces: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        for si in pinned:
            s = self.order[si]
            sv = self._svc[s]
            o = int(base[si])
            d = self._opt(s, options[o])
            j = int(exec_base[si])
            haul = self._haul_row(s, exec_base, q_up_pin, q_rap_pin)
            cal = self._corr.get(s)
            corr = cal.tier(j >= 0) if cal is not None else None
            if j >= 0:
                lat = ((d.dur + rw_pin[si]) * q_site_pin[j]
                       + hop_pin[si] + haul)
                if corr is not None:
                    lat = np.maximum(
                        corr.q_mult * lat + corr.lat_bias_s, 0.0)
                spec = sv["spec"]
                v_p = spec.perf_curve.value_array(lat)
                v = np.where((v_p > 0.0) & (d.v_e > 0.0),
                             spec.gamma * (spec.w_p * v_p
                                           + spec.w_e * d.v_e),
                             0.0)
                if corr is not None and corr.drop_offset > 0.0:
                    v = v * max(0.0, 1.0 - corr.drop_offset)
                edge_vos[si] = float(v.sum())
            else:
                dc_pieces[si] = (haul, d.dur)
        bundle = {"exec_base": exec_base, "util_pin": util_pin,
                  "q_site_pin": q_site_pin, "q_up_pin": q_up_pin,
                  "q_rap_pin": q_rap_pin, "ram_ok": ram_ok,
                  "rw_pin": rw_pin, "hop_pin": hop_pin,
                  "edge_vos": edge_vos, "dc_pieces": dc_pieces}
        if len(self._pin_cache) > 64:
            self._pin_cache.clear()
        self._pin_cache[key] = bundle
        return bundle

    def score_block(self, P: np.ndarray, cols: Sequence[int],
                    options: Sequence[ServicePlacement]) -> np.ndarray:
        """Delta-aware twin of :meth:`score_matrix` for block-coordinate
        batches: every row of ``P`` differs only in ``cols`` (one
        region's services). The pinned complement is scored once per
        distinct pinned row (memoized across sweeps); only the changed
        block is rescored per row. **Bit-identical** to
        ``score_matrix(P, options)``: every accumulation runs in the
        same service order with the same float operations, and the
        delta guard (see :meth:`_delta_guard`) falls back to the dense
        pass whenever the split would mix a util / load column or cross
        the DAG."""
        cols = sorted(int(c) for c in cols)
        colset = set(cols)
        S = len(self.order)
        pinned = [si for si in range(S) if si not in colset]
        site_for = np.array([self._site_idx.get(o.site, -1)
                             for o in options])
        chips_for = np.array([o.chips if not o.is_edge else 0
                              for o in options])
        if (len(P) == 0 or not cols or not pinned
                or not self._delta_guard(P, cols, pinned, site_for)):
            self.dense_fallbacks += 1
            return self.score_matrix(P, options)
        self.delta_calls += 1
        N = len(P)
        base = P[0]
        h = self.horizon_s
        pin = self._pinned_bundle(tuple(cols), base, options, site_for)
        exec_base = pin["exec_base"]
        max_fires = max(len(self._svc[s]["nw"]) for s in self.order)
        self.delta_cells_saved += N * len(pinned) * max_fires

        # block context terms, per row ---------------------------------
        bsites = sorted({int(j) for j in site_for[np.unique(P[:, cols])]
                         if j >= 0})
        bcol = {j: k for k, j in enumerate(bsites)}
        util_blk = np.zeros((N, len(bsites)))
        ram_blk = np.zeros((N, len(bsites)))
        upl_blk = np.zeros((N, self.n_regions))
        rapl_blk = np.zeros((N, self.n_regions))
        exec_blk = np.empty((N, S), dtype=int)   # block cols per row,
        exec_blk[:] = exec_base[None, :]         # pinned cols constant
        dc_demand = np.zeros(N)
        # dc_demand folds pinned scalars and block columns interleaved
        # in service order — the sum is order-sensitive in float
        for si, s in enumerate(self.order):
            sv = self._svc[s]
            if si not in colset:
                o = int(base[si])
                if site_for[o] < 0:
                    dc_demand += (chips_for[o]
                                  * self._opt(s, options[o]).busy / h)
                continue
            col = P[:, si]
            exec_blk[:, si] = site_for[col]
            for o in np.unique(col):
                mask = col == o
                d = self._opt(s, options[int(o)])
                j = int(site_for[o])
                if j >= 0:
                    util_blk[mask, bcol[j]] += d.busy / h
                    ram_blk[mask, bcol[j]] += (sv["budget"]
                                               * self._edge[j].record_bytes)
                else:
                    dc_demand[mask] += chips_for[o] * d.busy / h

        # block shared-pipe loads (block origins only touch block
        # regions under the guard, so these columns are exact)
        for si in cols:
            s = self.order[si]
            sv = self._svc[s]
            dst = exec_blk[:, si]
            for okey, counts in sv["origins"].items():
                total = float(counts.sum())
                if total == 0.0:
                    continue
                osite = (np.full(N, sv["farm_site"]) if okey is None
                         else exec_blk[:, self.rank[okey]])
                for j in np.unique(osite):
                    if j < 0:
                        continue
                    m = (osite == j) & (dst != j)
                    if not m.any():
                        continue
                    ln = self._link[j]
                    rj = self._region_of[j]
                    wire = total * ln.record_bytes * ln.compression
                    upl_blk[m, rj] += wire / ln.uplink_bps / h
                    rap = self._rap[rj]
                    if rap is not None:
                        dstm = dst[m]
                        crossing = ((dstm < 0) | (self._region_of[
                            np.clip(dstm, 0, None)] != rj))
                        rows = np.where(m)[0][crossing]
                        rapl_blk[rows, rj] += (wire / rap.uplink_bps / h)

        q_site_blk = _q_factor(util_blk)
        q_up_blk = _q_factor(upl_blk)
        q_rap_blk = _q_factor(rapl_blk)
        dc_over = np.maximum(1.0, dc_demand / self.grid_chips)
        feasible = pin["ram_ok"] & (ram_blk
                                    <= self._ram[bsites][None, :]).all(axis=1)

        # block×block rank blocking (earlier block services only; the
        # guard rules out pinned co-location)
        rank_wait = {si: np.zeros(N) for si in cols}
        for si in cols:
            slide_s = self._svc[self.order[si]]["slide"]
            for oi in cols:
                if oi >= si:
                    continue
                both = ((exec_blk[:, si] >= 0)
                        & (exec_blk[:, oi] == exec_blk[:, si]))
                if not both.any():
                    continue
                o = self.order[oi]
                align = min(1.0, slide_s / self._svc[o]["slide"])
                col = P[:, oi]
                for opt in np.unique(col[both]):
                    m = both & (col == opt)
                    rank_wait[si][m] += align * self._opt(
                        o, options[int(opt)]).mean_dur

        # block hops (upstreams are in the block under the guard)
        nsites = len(self.site_names)
        rtt = np.array([self._link[j].rtt_s for j in range(nsites)])
        hop = {si: np.zeros(N) for si in cols}
        for si in cols:
            s = self.order[si]
            my = exec_blk[:, si]
            rtt_my = np.where(my >= 0, rtt[np.clip(my, 0, None)], 0.0)
            for u in self.topology[s]:
                us = exec_blk[:, self.rank[u]]
                rtt_us = np.where(us >= 0, rtt[np.clip(us, 0, None)], 0.0)
                hh = np.where((us != my) & (my >= 0),
                              rtt_my / 2 + np.where(us >= 0, rtt_us / 2, 0.0),
                              0.0)
                if self._hier:
                    r_my = self._region_of[np.clip(my, 0, None)]
                    r_us = self._region_of[np.clip(us, 0, None)]
                    crossing = (us < 0) | (my < 0) | (r_us != r_my)
                    extra = (np.where(crossing & (us >= 0),
                                      self._rap_res_up[np.clip(us, 0, None)],
                                      0.0)
                             + np.where(crossing & (my >= 0),
                                        self._rap_res_dn[np.clip(my, 0, None)],
                                        0.0))
                    hh = hh + np.where((us != my) & (my >= 0), extra, 0.0)
                hop[si] = np.maximum(hop[si], hh)

        # per-service value accumulation, in global service order ------
        vos = np.zeros(N)
        for si, s in enumerate(self.order):
            sv = self._svc[s]
            if si not in colset:
                ev = pin["edge_vos"].get(si)
                if ev is not None:
                    vos += ev
                    continue
                haul, dur = pin["dc_pieces"][si]
                cal = self._corr.get(s)
                corr = cal.tier(False) if cal is not None else None
                spec = sv["spec"]
                d = self._opt(s, options[int(base[si])])
                uvals, inv = np.unique(dc_over, return_inverse=True)
                per = np.empty(len(uvals))
                for ui, u in enumerate(uvals):
                    lat = haul + dur * u + self.dl_user_s
                    if corr is not None:
                        lat = np.maximum(
                            corr.q_mult * lat + corr.lat_bias_s, 0.0)
                    v_p = spec.perf_curve.value_array(lat)
                    v = np.where((v_p > 0.0) & (d.v_e > 0.0),
                                 spec.gamma * (spec.w_p * v_p
                                               + spec.w_e * d.v_e),
                                 0.0)
                    if corr is not None and corr.drop_offset > 0.0:
                        v = v * max(0.0, 1.0 - corr.drop_offset)
                    per[ui] = v.sum()
                vos += per[inv]
                continue
            spec = sv["spec"]
            col = P[:, si]
            dst = exec_blk[:, si]
            haul = np.zeros((N, len(sv["nw"])))
            for okey, counts in sv["origins"].items():
                if not counts.any():
                    continue
                osite = (np.full(N, sv["farm_site"]) if okey is None
                         else exec_blk[:, self.rank[okey]])
                for j in np.unique(osite):
                    if j < 0:
                        continue
                    m = (osite == j) & (dst != j)
                    if not m.any():
                        continue
                    ln = self._link[j]
                    rj = self._region_of[j]
                    wire = counts * ln.record_bytes * ln.compression
                    leg = (ln.rtt_s / 2
                           + wire[None, :] / ln.uplink_bps
                           * q_up_blk[m, rj][:, None])
                    rap = self._rap[rj]
                    if rap is not None:
                        dstm = dst[m]
                        crossing = ((dstm < 0) | (self._region_of[
                            np.clip(dstm, 0, None)] != rj))
                        if crossing.any():
                            leg[crossing] = (leg[crossing] + rap.rtt_s / 2
                                             + wire[None, :] / rap.uplink_bps
                                             * q_rap_blk[m, rj][crossing,
                                                                None])
                    e_m = m & (dst >= 0)
                    if e_m.any():
                        dn = np.zeros((int(e_m.sum()), len(counts)))
                        sub = dst[e_m]
                        for jj in np.unique(sub):
                            lnd = self._link[jj]
                            sel = sub == jj
                            dn[sel] = (lnd.rtt_s / 2
                                       + counts[None, :]
                                       * lnd.record_bytes
                                       / lnd.downlink_bps)
                            rapd = self._rap[self._region_of[jj]]
                            if rapd is not None and self._region_of[jj] != rj:
                                dn[sel] += (rapd.rtt_s / 2
                                            + counts[None, :]
                                            * lnd.record_bytes
                                            / rapd.downlink_bps)
                        haul[e_m] += leg[dst[m] >= 0] + dn
                    d_m = m & (dst < 0)
                    if d_m.any():
                        haul[d_m] += leg[dst[m] < 0]
            cal = self._corr.get(s)
            for o in np.unique(col):
                mask = col == o
                d = self._opt(s, options[int(o)])
                j = int(site_for[o])
                if j >= 0:
                    lat = ((d.dur[None, :] + rank_wait[si][mask, None])
                           * q_site_blk[mask, bcol[j], None]
                           + hop[si][mask, None] + haul[mask])
                else:
                    lat = (haul[mask]
                           + d.dur[None, :] * dc_over[mask, None]
                           + self.dl_user_s)
                corr = cal.tier(j >= 0) if cal is not None else None
                if corr is not None:
                    lat = np.maximum(
                        corr.q_mult * lat + corr.lat_bias_s, 0.0)
                v_p = spec.perf_curve.value_array(lat)
                v = np.where((v_p > 0.0) & (d.v_e[None, :] > 0.0),
                             spec.gamma * (spec.w_p * v_p
                                           + spec.w_e * d.v_e[None, :]),
                             0.0)
                if corr is not None and corr.drop_offset > 0.0:
                    v = v * max(0.0, 1.0 - corr.drop_offset)
                vos[mask] += v.sum(axis=1)
        vos[~feasible] = float("-inf")
        return vos

    # ------------------------------------------------------------ fronts
    def matrix_of(self, plans: Sequence[PlacementPlan],
                  options: Sequence[ServicePlacement]) -> np.ndarray:
        idx = {(o.site, o.chips if not o.is_edge else 0,
                o.dvfs_f if not o.is_edge else 0.0): i
               for i, o in enumerate(options)}
        P = np.empty((len(plans), len(self.order)), dtype=int)
        for n, plan in enumerate(plans):
            for si, s in enumerate(self.order):
                p = plan.placement(s)
                P[n, si] = idx[(p.site, p.chips if not p.is_edge else 0,
                                p.dvfs_f if not p.is_edge else 0.0)]
        return P

    def score_batch(self, plans: Sequence[PlacementPlan]) -> np.ndarray:
        """Screened VoS for arbitrary plans (options inferred)."""
        seen: Dict[Tuple, ServicePlacement] = {}
        for plan in plans:
            for p in plan.assignments.values():
                seen.setdefault((p.site, p.chips if not p.is_edge else 0,
                                 p.dvfs_f if not p.is_edge else 0.0), p)
        options = list(seen.values())
        return self.score_matrix(self.matrix_of(plans, options), options)

    def run(self, plan: PlacementPlan) -> ScreenResult:
        """Single-plan front (duck-compatible with the search scorer)."""
        vos = float(self.score_batch([plan])[0])
        if math.isinf(vos) and vos < 0:
            return ScreenResult(vos, False, plan.label, "site RAM")
        return ScreenResult(vos, True, plan.label)
