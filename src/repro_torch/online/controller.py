"""Epoch-based re-placement controllers.

At every epoch boundary the bridge asks a controller for the coming
epoch's placement plan. The online controller re-runs the *same*
``placement.search`` machinery the static engine uses — over a cheap
deterministic forecast model parameterized by a sliding estimate of the
observed record rates — then applies a switch margin so marginal wins
don't churn migrations. The oracle variant plans from ground-truth
next-epoch rates with free migrations: the per-epoch upper bound the
acceptance criteria compare against.

The forecast model is intentionally analytic (M/M/1-style queueing
inflation on saturated devices and the shared uplink, roofline DC
latency via the same cost cells the DES uses): it only needs to *rank*
plans; fidelity comes from the fleet co-simulation that replays the
chosen schedule.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.value import task_value
from repro_torch.placement.edge import EdgeNode
from repro_torch.placement.plan import SITE_DC, PlacementPlan
from repro_torch.placement.search import Evaluator, search_placement
from repro_torch.region.hier import regions_view
from repro_torch.scenario.observe import BridgeInfo, EpochObservation
from repro_torch.scenario.feedback import CalibrationLoop, ServiceCorrection
from repro_torch.scenario.queueing import q_factor

# latency penalty standing in for "this transfer cannot complete": a
# partitioned link makes any plan that needs it rank to ~zero value
# while staying feasible (local-only work on the partitioned site is
# still worth doing — partition is not outage)
_LINK_DEAD_S = 1e7


@dataclasses.dataclass
class ForecastResult:
    """Duck-typed stand-in for CoSimResult: exactly what the search
    scorer reads."""
    vos: float
    feasible: bool
    plan_label: str = ""
    infeasible_reason: str = ""


class ForecastModel:
    """Analytic plan scorer over a rate estimate; plugs into
    ``placement.search`` (it quacks like a CoSimulator: ``.topology`` +
    ``.run(plan)``).

    ``corrections`` installs per-service calibration terms
    (:class:`~repro_torch.scenario.feedback.ServiceCorrection`): the raw
    analytic latency is mapped through ``q_mult·lat + lat_bias_s`` and
    the resulting value scaled by ``1 − drop_offset`` before ranking —
    the closed half of the forecast-calibration loop. With no
    corrections the model is bit-identical to the uncalibrated one."""

    def __init__(self, info: BridgeInfo, rates: Mapping[str, float],
                 down: Optional[Mapping[str, bool]] = None,
                 corrections: Optional[Mapping[str, ServiceCorrection]]
                 = None,
                 link_slowdown: Optional[Mapping[str, float]] = None,
                 link_dead: Optional[Mapping[str, bool]] = None):
        self.info = info
        self.topology = info.topology
        self.rates = dict(rates)
        self.down = dict(down or {})
        self.corrections = dict(corrections or {})
        # chaos-telemetry steering (ChaosController): per-site uplink
        # serialization inflation and realized link partitions. Empty
        # maps are bit-identical to the un-steered model (×1.0, no
        # penalties).
        self.link_slowdown = dict(link_slowdown or {})
        self.link_dead = dict(link_dead or {})
        self._nodes = {s.name: EdgeNode(s.edge) for s in info.fleet.sites}
        # hierarchy: per-region edge tiers + RAP trunks (flat fleets are
        # one transparent region — every trunk term is zero and the
        # forecast stays bit-identical to the single-uplink model)
        regs = regions_view(info.fleet)
        self._region_of = {s: i for i, r in enumerate(regs)
                           for s in r.sites}
        self._rap = [None if r.transparent else r.rap for r in regs]
        self._hier = any(r is not None for r in self._rap)

    def _crosses(self, src: str, dst: str) -> bool:
        """True when a src→dst transfer transits the DC core (mirrors
        ``Fleet._crosses_core``)."""
        if src == SITE_DC or dst == SITE_DC:
            return True
        return self._region_of[src] != self._region_of[dst]

    def _slow(self, site: str) -> float:
        return self.link_slowdown.get(site, 1.0)

    def _dead(self, site: str) -> bool:
        return site != SITE_DC and bool(self.link_dead.get(site))

    # ------------------------------------------------------------- helpers
    def _n_window(self, svc: str) -> float:
        i = self.info.services[svc]
        return min(self.rates.get(svc, 0.0) * i.width_s,
                   float(i.buffer_budget))

    def _n_new(self, svc: str) -> float:
        i = self.info.services[svc]
        return self.rates.get(svc, 0.0) * i.slide_s

    def _dc_steps(self, svc: str) -> int:
        return max(1, int(self._n_window(svc)
                          // self.info.records_per_step) + 1)

    # ----------------------------------------------------------------- run
    def run(self, plan: PlacementPlan) -> ForecastResult:
        return self._eval(plan)[0]

    def predict(self, plan: PlacementPlan
                ) -> Tuple[ForecastResult, Dict[str, Dict]]:
        """Score plus per-service detail: the *raw* analytic latency
        (``lat_s`` — what a calibration loop regresses realized
        latencies against), the calibrated latency actually ranked with
        (``lat_cal_s``), and the per-epoch VoS contribution under both
        (``vos`` / ``vos_raw``)."""
        return self._eval(plan, want_detail=True)

    def _eval(self, plan: PlacementPlan, want_detail: bool = False
              ) -> Tuple[ForecastResult, Dict[str, Dict]]:
        info = self.info
        order = list(self.topology)
        sites = info.fleet.site_names
        try:
            plan.validate(self.topology, grid_chips=info.grid_chips,
                          sites=tuple(sites) + (SITE_DC,))
        except ValueError as e:
            return ForecastResult(float("-inf"), False, plan.label,
                                  str(e)), {}

        # group placements by site once — per-site passes below stay
        # O(services), not O(sites × services) (a 500-site fleet used to
        # pay the product on every plan evaluation)
        placed_by_site: Dict[str, List[str]] = {}
        for s in order:
            placed_by_site.setdefault(plan.site(s), []).append(s)

        # hard feasibility: down sites host nothing; RAM fits
        for name in sites:
            placed = placed_by_site.get(name)
            if not placed:
                continue
            if self.down.get(name):
                return ForecastResult(float("-inf"), False, plan.label,
                                      f"site {name} is down"), {}
            spec = info.fleet.site(name).edge
            budget = sum(info.services[s].buffer_budget for s in placed)
            if spec.ram_required(budget) > spec.ram_bytes:
                return ForecastResult(float("-inf"), False, plan.label,
                                      f"site {name}: RAM"), {}

        # device utilization per hosting site; per-region edge-tier and
        # RAP-trunk serialization load
        util: Dict[str, float] = {}
        for name, placed in placed_by_site.items():
            if name == SITE_DC:
                continue
            node = self._nodes[name]
            u = 0.0
            for s in placed:
                i = info.services[s]
                u += node.fire_time(int(self._n_window(s)),
                                    info.profiles[s].flops_per_record) \
                    / i.slide_s
            util[name] = u
        up_load = [0.0] * len(self._rap)
        rap_load = [0.0] * len(self._rap)
        for s in order:
            i = info.services[s]
            src = self._origin_site(s, plan)
            dst = plan.site(s)
            if src == dst or src == SITE_DC:
                continue
            net = info.fleet.site(src).link
            wire = self._n_new(s) * net.record_bytes * net.compression
            rj = self._region_of[src]
            up_load[rj] += wire / net.uplink_bps / i.slide_s \
                * self._slow(src)
            rap = self._rap[rj]
            if rap is not None and self._crosses(src, dst):
                rap_load[rj] += wire / rap.uplink_bps / i.slide_s
        q_up = [q_factor(x) for x in up_load]
        q_rap = [q_factor(x) for x in rap_load]

        # q_factor (repro_torch.scenario.screen, shared with the vectorized
        # plan screen): deterministic slide-aligned arrivals — a work-
        # conserving server is stable below saturation, then the
        # backlog diverges; mild inflation approaching the cliff.

        # DC composition pressure: duty-cycle chip demand vs the grid
        demand = 0.0
        for s in order:
            p = plan.placement(s)
            if p.is_edge:
                continue
            t_step = info.cost.time_per_step(f"svc:{s}", "window",
                                             p.chips, p.dvfs_f)
            demand += p.chips * (self._dc_steps(s) * t_step
                                 / info.services[s].slide_s)
        dc_over = max(1.0, demand / info.grid_chips)

        # Serial-device rank blocking: services co-located on one site
        # fire at aligned slide boundaries and execute in topo-rank
        # order, so a light service queued behind a long fire eats the
        # long fire's latency — deterministically, not stochastically.
        rank = {s: i for i, s in enumerate(order)}
        fire_s: Dict[str, float] = {}
        for s in order:
            p = plan.placement(s)
            if p.is_edge:
                fire_s[s] = self._nodes[p.site].fire_time(
                    int(self._n_window(s)),
                    self.info.profiles[s].flops_per_record)

        def rank_wait(s: str) -> float:
            p = plan.placement(s)
            slide = info.services[s].slide_s
            w = 0.0
            for o in order:
                if o == s or plan.site(o) != p.site or rank[o] > rank[s]:
                    continue
                # collision probability of o's fires with s's boundaries
                align = min(1.0, slide / info.services[o].slide_s)
                w += align * fire_s[o]
            return w

        vos = 0.0
        user = info.fleet.result_site
        detail: Dict[str, Dict] = {}
        for s in order:
            i = info.services[s]
            prof = info.profiles[s]
            p = plan.placement(s)
            n_win, n_new = self._n_window(s), self._n_new(s)
            hop = self._upstream_hop_s(s, plan)
            if p.is_edge:
                node = self._nodes[p.site]
                base = fire_s[s]
                lat = (base + rank_wait(s)) * q_factor(util[p.site]) + hop
                lat += self._haul_s(s, plan, n_new, q_up, q_rap)
                # mirror EdgeNode.execute_fire: the ingest term covers
                # the whole window, not just the newly covered records
                energy = (n_win * node.spec.energy_per_record_j
                          + base * node.spec.active_power_w)
            else:
                src = self._origin_site(s, plan)
                xfer = 0.0
                if src != SITE_DC:
                    net = info.fleet.site(src).link
                    rj = self._region_of[src]
                    wire = n_new * net.record_bytes * net.compression
                    xfer = (net.rtt_s / 2
                            + wire / net.uplink_bps * q_up[rj]
                            * self._slow(src))
                    rap = self._rap[rj]
                    if rap is not None:   # edge→DC always transits the core
                        xfer += (rap.rtt_s / 2
                                 + wire / rap.uplink_bps * q_rap[rj])
                    if self._dead(src):   # records cannot leave the site
                        xfer += _LINK_DEAD_S
                t_step = info.cost.time_per_step(f"svc:{s}", "window",
                                                 p.chips, p.dvfs_f)
                dl = info.fleet.site(user).link.rtt_s / 2
                rap_u = self._rap[self._region_of[user]]
                if rap_u is not None:   # DC results ride the user trunk down
                    dl += (rap_u.rtt_s / 2
                           + info.fleet.site(user).link.result_bytes
                           / rap_u.downlink_bps)
                if self._dead(user):    # results cannot reach the user
                    dl += _LINK_DEAD_S
                lat = (hop + xfer + self._dc_steps(s) * t_step * dc_over
                       + dl)
                energy = self._dc_steps(s) * info.cost.energy_per_step(
                    f"svc:{s}", "window", p.chips, p.dvfs_f)
            corr = self.corrections.get(s)
            if corr is not None:
                corr = corr.tier(p.is_edge)
            lat_cal = corr.latency(lat) if corr is not None else lat
            vspec = prof.slo.value_spec()
            v = task_value(vspec, lat_cal, energy)
            if corr is not None:
                v *= corr.keep_prob
            fires = info.epoch_s / i.slide_s
            vos += v * fires
            if want_detail:
                v_raw = (v if corr is None
                         else task_value(vspec, lat, energy))
                detail[s] = {"lat_s": lat, "lat_cal_s": lat_cal,
                             "tier": "edge" if p.is_edge else "dc",
                             "vos": v * fires, "vos_raw": v_raw * fires}
        return ForecastResult(vos, True, plan.label), detail

    def _origin_site(self, svc: str, plan: PlacementPlan) -> str:
        """Dominant input-record origin: upstream's site if any upstream
        exists, else the farm site of the input queue."""
        ups = self.topology[svc]
        if ups:
            return plan.site(ups[0])
        return self.info.fleet.farm_site(self.info.services[svc].queue)

    def _upstream_hop_s(self, svc: str, plan: PlacementPlan) -> float:
        """Result-handoff latency from upstream cuts (cross-region cuts
        additionally ride the src RAP up and the dst RAP down)."""
        t = 0.0
        my = plan.site(svc)
        for u in self.topology[svc]:
            us = plan.site(u)
            if us == my or my == SITE_DC:
                continue
            if us == SITE_DC:
                h = self.info.fleet.site(my).link.rtt_s / 2
            else:
                h = (self.info.fleet.site(us).link.rtt_s / 2
                     + self.info.fleet.site(my).link.rtt_s / 2)
            if self._hier and self._crosses(us, my):
                if us != SITE_DC:
                    rap = self._rap[self._region_of[us]]
                    if rap is not None:
                        h += (rap.rtt_s / 2
                              + self.info.fleet.site(us).link.result_bytes
                              / rap.uplink_bps)
                rapd = self._rap[self._region_of[my]]
                if rapd is not None:
                    h += (rapd.rtt_s / 2
                          + self.info.fleet.site(my).link.result_bytes
                          / rapd.downlink_bps)
            if self._dead(us) or self._dead(my):
                h += _LINK_DEAD_S
            t = max(t, h)
        return t

    def _haul_s(self, svc: str, plan: PlacementPlan, n_new: float,
                q_up: Sequence[float], q_rap: Sequence[float]) -> float:
        """Cross-site raw-record haul onto an edge placement
        (cross-region: plus the src RAP trunk up, contended, and the dst
        RAP trunk down)."""
        src, dst = self._origin_site(svc, plan), plan.site(svc)
        if src == dst or src == SITE_DC:
            return 0.0
        if self._dead(src) or self._dead(dst):
            return _LINK_DEAD_S
        snet = self.info.fleet.site(src).link
        dnet = self.info.fleet.site(dst).link
        rj = self._region_of[src]
        wire = n_new * snet.record_bytes * snet.compression
        base = (snet.rtt_s / 2
                + wire / snet.uplink_bps * q_up[rj] * self._slow(src)
                + dnet.rtt_s / 2
                + n_new * dnet.record_bytes / dnet.downlink_bps)
        if not self._hier or not self._crosses(src, dst):
            return base
        extra = 0.0
        rap = self._rap[rj]
        if rap is not None:
            extra += rap.rtt_s / 2 + wire / rap.uplink_bps * q_rap[rj]
        rapd = self._rap[self._region_of[dst]]
        if rapd is not None:
            extra += (rapd.rtt_s / 2
                      + n_new * dnet.record_bytes / rapd.downlink_bps)
        return base + extra


# ---------------------------------------------------------------------------
# Controllers
# ---------------------------------------------------------------------------
class StaticController:
    """Plays one fixed plan for the whole horizon (the PR-1 world)."""
    charge_migrations = True

    def __init__(self, plan: PlacementPlan, label: str = "static"):
        self.plan = plan
        self.label = label

    def bind(self, info: BridgeInfo) -> None:
        self.info = info

    def decide(self, obs: EpochObservation) -> PlacementPlan:
        return self.plan


class OnlineController:
    """Sliding-estimate re-placement: search the plan space against the
    forecast model each epoch; switch (and pay migrations) only when the
    forecast win clears ``switch_margin``, or the live plan went
    infeasible (site failure / RAM).

    Every ``decide`` appends one regret-telemetry entry: the forecast
    VoS of the search's best plan, of the plan actually played
    (hysteresis may keep the incumbent), and their *signed* gap
    (``search_regret`` — negative when tie-breaking kept an incumbent
    the fresh search scored below). The engine merges the realized
    per-epoch co-sim VoS into the same record (``cosim_vos`` /
    ``calibration_gap``).

    ``calibrate=True`` closes the forecast-calibration loop: a
    :class:`~repro_torch.scenario.feedback.CalibrationLoop` fits per-service
    correction terms (queueing-inflation multiplier, network-latency
    bias, drop-probability offset) by recursive least squares over the
    engine's realized residuals (``EpochObservation.realized_window``)
    paired with the raw forecasts this controller stored for the plans
    it played, and every subsequent epoch's plan search ranks with the
    corrected model. Telemetry then additionally records the raw
    (uncorrected) forecast of the played plan (``chosen_vos_raw`` — the
    engine derives ``calibration_gap_raw`` from it) and the corrections
    in force.

    ``risk`` switches plan *selection* from the single sliding-estimate
    forecast to a distributionally robust pick: each epoch the rate
    estimate is perturbed into a small lognormal ensemble of forecast
    models (deterministic per ``(seed, epoch)``), a candidate shortlist
    (the nominal search winner, the incumbent, and the anchor plans) is
    scored under every realization, and the plan with the best risk
    score (:class:`repro_torch.fluid.robust.RiskSpec` — e.g. ``"cvar"``) is
    handed to the usual hysteresis gate. ``risk=None`` (default) is
    bit-identical to the single-trace controller. When calibration is
    also on, the ensemble's per-service VoS spread for the chosen plan
    is fed to ``CalibrationLoop.set_variance_prior`` so volatile
    services keep larger RLS gains."""
    charge_migrations = True
    label = "online"

    def __init__(self, chips_options: Sequence[int] = (4, 8),
                 dvfs_options: Sequence[float] = (1.0,),
                 window: int = 3, switch_margin: float = 0.05,
                 seed: int = 0,
                 prior_rates: Optional[Mapping[str, float]] = None,
                 calibrate: bool = False,
                 calibration: Optional[CalibrationLoop] = None,
                 risk=None, risk_ensemble: int = 16,
                 risk_rate_scale: float = 0.25):
        self.chips_options = tuple(chips_options)
        self.dvfs_options = tuple(dvfs_options)
        self.window = window
        self.switch_margin = switch_margin
        self.seed = seed
        self.prior_rates = dict(prior_rates) if prior_rates else None
        self.calibrate = calibrate or calibration is not None
        self.calibration = calibration
        self.risk = risk
        self.risk_ensemble = int(risk_ensemble)
        self.risk_rate_scale = float(risk_rate_scale)
        if self.calibrate:
            self.label = "online-cal"
        if self.risk is not None:
            self.label = self.label + "-risk"
        self.current: Optional[PlacementPlan] = None
        self.telemetry: List[Dict] = []

    def bind(self, info: BridgeInfo) -> None:
        self.info = info
        self.telemetry = []   # bind() marks a run start: drop stale entries
        self.current = None
        self._pred: Dict[int, Dict[str, Dict]] = {}
        self._observed_upto = 0
        # cross-epoch exact-score memo: one dict for the whole run,
        # namespaced per epoch by the forecast model's fingerprint (the
        # model changes whenever the rate estimate / outage set /
        # corrections move — a plan-only key would serve stale scores).
        # Steady epochs re-derive the same fingerprint and the search's
        # warm-start / anchor / finalist evaluations hit instead of
        # re-scoring.
        self._xcache: Dict = {}
        self._cum_hits = 0
        self._cum_misses = 0
        self._fp_seen: set = set()
        if self.calibrate:
            if self.calibration is None:
                self.calibration = CalibrationLoop(list(info.topology))
            else:
                self.calibration.reset()

    # ------------------------------------------------------------ estimate
    def _estimate(self, obs: EpochObservation) -> Dict[str, float]:
        win = obs.rates_window[-self.window:]
        if not win:
            if self.prior_rates is not None:
                return dict(self.prior_rates)
            return {s: 1.0 for s in self.info.topology}
        out: Dict[str, float] = {}
        for s in self.info.topology:
            out[s] = sum(w.get(s, 0.0) for w in win) / len(win)
        return out

    def _rates(self, obs: EpochObservation) -> Dict[str, float]:
        return self._estimate(obs)

    def _down(self, obs: EpochObservation) -> Dict[str, bool]:
        return obs.down_now

    def _make_model(self, rates: Mapping[str, float],
                    down: Mapping[str, bool], corr) -> ForecastModel:
        """Model-construction hook: chaos-aware subclasses inject
        telemetry-derived link state here. Subclasses that do MUST also
        extend ``_model_fingerprint`` with the same state, or the
        cross-epoch score memo serves stale scores."""
        return ForecastModel(self.info, rates, down, corrections=corr)

    def _model_fingerprint(self, rates: Mapping[str, float],
                           down: Mapping[str, bool],
                           corr) -> Tuple:
        """Hashable identity of this epoch's forecast model — the cache
        namespace for cross-epoch score reuse. Built from the *exact*
        parameter values (not the telemetry's rounded ``to_dict`` forms,
        which could alias two different models onto one namespace and
        serve a stale score)."""
        corr_fp: Tuple = ()
        if corr:
            corr_fp = tuple(sorted(
                (s, dataclasses.astuple(c) if dataclasses.is_dataclass(c)
                 else tuple(sorted(c.to_dict().items())))
                for s, c in corr.items()))
        return (tuple(sorted(rates.items())),
                # ForecastModel only reads truthiness of down entries
                tuple(sorted(k for k, v in down.items() if v)),
                corr_fp)

    # ---------------------------------------------------------- calibration
    def _absorb_residuals(self, obs: EpochObservation) -> None:
        """Feed each newly completed epoch's realized residuals (paired
        with the raw forecast stored when that epoch's plan was chosen)
        into the calibration loop — each epoch is observed exactly once,
        at the first boundary after it completes."""
        for e in range(self._observed_upto, len(obs.realized_window)):
            pred = self._pred.pop(e, None)
            if pred is not None:
                self.calibration.observe(e, pred, obs.realized_window[e])
        self._observed_upto = max(self._observed_upto,
                                  len(obs.realized_window))

    # -------------------------------------------------------------- robust
    def _risk_candidates(self, sr, edge_sites) -> List[PlacementPlan]:
        """Shortlist the ensemble re-scores: the nominal search winner
        first (stable-tie favorite), then the incumbent and the anchor
        plans."""
        names = list(self.info.topology)
        cands = [sr.plan]
        if self.current is not None:
            cands.append(self.current)
        for site in edge_sites:
            cands.append(PlacementPlan.all_edge(names, site=site))
        for c in self.chips_options:
            cands.append(PlacementPlan.all_dc(names, chips=c,
                                              dvfs_f=self.dvfs_options[0]))
        out: List[PlacementPlan] = []
        seen = set()
        for p in cands:
            k = p.key()
            if k not in seen:
                seen.add(k)
                out.append(p)
        return out

    def _robust_pick(self, rates, down, corr, sr, edge_sites,
                     epoch: int) -> Tuple[PlacementPlan, Dict]:
        """Risk-ranked plan selection over a lognormal rate-forecast
        ensemble (realization 0 is the nominal estimate); deterministic
        per ``(seed, epoch)``."""
        from repro_torch.fluid.robust import RiskSpec, risk_score

        risk = RiskSpec.of(self.risk)
        rng = random.Random((self.seed + 1) * 1_000_003 + epoch * 7919)
        models = [ForecastModel(self.info, rates, down, corrections=corr)]
        for _ in range(self.risk_ensemble):
            pr = {s: r * math.exp(rng.gauss(0.0, self.risk_rate_scale))
                  for s, r in sorted(rates.items())}
            models.append(ForecastModel(self.info, pr, down,
                                        corrections=corr))
        cands = self._risk_candidates(sr, edge_sites)
        vos = [[m.run(p).vos for p in cands] for m in models]
        scores = risk_score(vos, risk)
        best_i = int(scores.argmax())   # first max: sr.plan wins ties
        best = cands[best_i]

        if self.calibration is not None:
            # ensemble spread of the chosen plan's per-service forecast
            # VoS -> RLS variance prior (volatile services keep learning)
            per: Dict[str, List[float]] = {}
            for m in models:
                _, det = m.predict(best)
                for s, d in det.items():
                    per.setdefault(s, []).append(d["vos"])
            prior: Dict[str, Dict[str, float]] = {}
            for s, vals in per.items():
                scale = max(1e-9, max(abs(v) for v in vals))
                mean = sum(vals) / len(vals)
                rel = (sum((v - mean) ** 2 for v in vals)
                       / len(vals)) ** 0.5 / scale
                is_edge = best.placement(s).is_edge
                prior[s] = {"edge": rel if is_edge else 0.0,
                            "dc": 0.0 if is_edge else rel}
            self.calibration.set_variance_prior(prior)

        info = {
            "metric": risk.label,
            "ensemble": len(models),
            "candidates": len(cands),
            "chosen": best.label,
            "nominal_best": sr.plan.label,
            "diverged": best.key() != sr.plan.key(),
            "scores": {p.label: (round(float(scores[i]), 4)
                                 if math.isfinite(float(scores[i]))
                                 else None)
                       for i, p in enumerate(cands)},
        }
        return best, info

    # -------------------------------------------------------------- decide
    def decide(self, obs: EpochObservation) -> PlacementPlan:
        rates, down = self._rates(obs), self._down(obs)
        corr = None
        if self.calibration is not None:
            self._absorb_residuals(obs)
            corr = self.calibration.corrections()
        model = self._make_model(rates, down, corr)
        up_sites = tuple(s for s in self.info.fleet.site_names
                         if not down.get(s))
        edge_sites = up_sites or self.info.fleet.site_names
        # on hierarchical fleets the front door routes to the decomposed
        # per-region search; the incumbent plan warm-starts it so steady
        # epochs cost a handful of model calls (ignored on flat fleets —
        # the joint search stays bit-identical)
        fp = self._model_fingerprint(rates, down, corr)
        model_reused = fp in self._fp_seen
        self._fp_seen.add(fp)
        if len(self._xcache) > 200_000:   # bound the run-long memo
            self._xcache.clear()
            self._fp_seen = {fp}
        ev = Evaluator(model, cache=self._xcache, key_prefix=fp)
        sr = search_placement(model, self.chips_options, self.dvfs_options,
                              seed=self.seed, edge_sites=edge_sites,
                              warm_start=self.current, evaluator=ev)
        self._cum_hits += sr.cache_hits
        self._cum_misses += sr.cache_misses
        best = sr.plan
        risk_entry = None
        if self.risk is not None:
            best, risk_entry = self._robust_pick(rates, down, corr, sr,
                                                 edge_sites, obs.epoch)
        new, new_detail = model.predict(best)
        switched = True
        if self.current is None:
            self.current, chosen, detail = best, new, new_detail
        else:
            cur, cur_detail = model.predict(self.current)
            must_switch = not cur.feasible
            margin_ok = (new.feasible and cur.feasible
                         and new.vos > cur.vos * (1.0 + self.switch_margin)
                         + 1e-9)
            if must_switch or margin_ok:
                self.current, chosen, detail = best, new, new_detail
            else:
                chosen, detail, switched = cur, cur_detail, False
        entry = {
            "epoch": obs.epoch,
            "best_vos": round(new.vos, 4) if new.feasible else None,
            "chosen_vos": round(chosen.vos, 4) if chosen.feasible else None,
            # signed: hysteresis/tie-break can keep an incumbent the
            # fresh search scores *below* (negative regret), which a
            # max(0, .) here used to silently discard
            "search_regret": round(new.vos - chosen.vos, 4)
            if new.feasible and chosen.feasible else None,
            "switched": switched,
            "search": {"method": sr.method, "evaluations": sr.evaluations,
                       "cache_hits": sr.cache_hits,
                       "cache_misses": sr.cache_misses,
                       # cross-epoch reuse: cumulative over the run's
                       # shared memo plus whether this epoch's model
                       # fingerprint repeated an earlier epoch's
                       "cum_cache_hits": self._cum_hits,
                       "cum_cache_misses": self._cum_misses,
                       "cache_plans": len(self._xcache),
                       "model_reused": model_reused},
        }
        if risk_entry is not None:
            entry["risk"] = risk_entry
        if self.calibration is not None:
            if chosen.feasible:
                # raw forecast detail of the played plan (reused from
                # the hysteresis evaluation): the pairing target for
                # this epoch's realized residuals, and the raw-arm
                # prediction the engine turns into calibration_gap_raw
                self._pred[obs.epoch] = detail
                entry["chosen_vos_raw"] = round(
                    sum(d["vos_raw"] for d in detail.values()), 4)
            entry["corrections"] = {
                s: c.to_dict() for s, c in corr.items()}
        self.telemetry.append(entry)
        return self.current


class OracleController(OnlineController):
    """Clairvoyant per-epoch baseline: plans from ground-truth coming-
    epoch rates and outage windows, switches freely, pays no migration —
    the upper bound the online controller is measured against."""
    charge_migrations = False
    label = "oracle"

    def __init__(self, chips_options: Sequence[int] = (4, 8),
                 dvfs_options: Sequence[float] = (1.0,), seed: int = 0):
        super().__init__(chips_options=chips_options,
                         dvfs_options=dvfs_options, window=1,
                         switch_margin=0.0, seed=seed)

    def _rates(self, obs: EpochObservation) -> Dict[str, float]:
        return dict(obs.rates_oracle)

    def _down(self, obs: EpochObservation) -> Dict[str, bool]:
        return dict(obs.down_oracle)


def plan_on_average_rates(info: BridgeInfo,
                          avg_rates: Mapping[str, float],
                          chips_options: Sequence[int] = (4, 8),
                          dvfs_options: Sequence[float] = (1.0,),
                          seed: int = 0) -> PlacementPlan:
    """The best *static* plan the forecast model can find for the
    whole-horizon average rates — the strongest honest static baseline."""
    model = ForecastModel(info, avg_rates, down=None)
    sr = search_placement(model, chips_options, dvfs_options, seed=seed,
                          edge_sites=info.fleet.site_names)
    return sr.plan
