"""Fixed-step fluid approximation of the scenario DES, batched in torch;
carried from the JAX package's ``fluid/engine.py``.

``FluidEngine.compile(spec_or_engine)`` lowers one compiled scenario —
the placement-independent fire trace (timestamps, window sizes, origin
record counts), the per-site device/link specs, the per-service SLO
value curves, and the DC roofline cells — into padded dense arrays.
``evaluate`` then runs a time-stepper over BOTH batch axes (drift
realizations × plan candidates) at once: plan tensors are ``[M, ...]``,
realization tensors ``[N, T, ...]``, the backlog carries ``[N, M, ...]``,
and every op of a step broadcasts over the leading ``[N, M]``. It runs on
the CUDA card unless the engine was built with ``device="cpu"``; on the
card a time loop whose input shape an earlier call already had is replayed
from a CUDA graph, captured on that second sighting; a shape seen once runs
op by op, so a one-off call pays no capture (``repro_torch.graphs``).

The fluid model mirrors ``ScreeningModel``'s per-fire cost terms
(duration, energy, uplink serialization, rank blocking, DC composition
pressure, migration stalls from ``core/elastic.py``'s charge model) but
replaces the screen's *stateless* queueing knee on edge devices with an
explicit per-site backlog recursion over time bins of width ``dt``
(default: the minimum service slide, so at most one fire per service
per bin):

    lat(fire of s in bin k) = B[site, k] + rank_wait + dur + hop + haul
    B[site, k+1] = max(0, B[site, k] + Σ dur·fires − dt·(1 − down_frac))

which reproduces the DES's transient saturation behaviour (growing,
draining and oscillating backlogs) that a horizon-averaged utilization
knee cannot. The shared-uplink FIFO gets the same treatment (a scalar
backlog plus the classic knee below saturation). Site outages reduce
bin service capacity and defer fires to recovery.

The lowering (``__init__``, ``lower_plans``, ``migration_stalls``) is the
reference's numpy, carried as it is; the stepper is float32 with the
reference's operations in their order, and its outputs are summed in
float64 on the host. Everything here is deterministic array math —
randomness lives in the *inputs* (the sampled realization modulations
built by ``repro_torch.fluid.ensemble``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from types import SimpleNamespace
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import graphs as G
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.placement.plan import PlacementPlan
from repro_torch.region.hier import regions_view
from repro_torch.scenario.queueing import q_factor_torch

# Uplink utilization is clamped here before the queueing knee: overload
# beyond the clamp surfaces as *backlog* (unbounded wait growth over
# bins), not as an instantaneous NEVER_S cliff, matching the DES's FIFO
# pipe where early fires during an overload still complete.
_UPLINK_Q_CLAMP = 0.92


@dataclasses.dataclass
class FluidResult:
    """Per-(realization, plan) trajectories from one ensemble call.

    ``vos[n, m]`` is the fluid VoS estimate of plan ``m`` under drift
    realization ``n`` (``-inf`` for site-RAM-infeasible plans);
    ``vos_service``/``vos_t`` split it per service / per time bin,
    ``lat_mean`` is the fire-weighted mean latency per service, and
    ``drop_frac``/``drop_t`` count zero-value fires (the fluid analogue
    of drops)."""
    vos: np.ndarray            # [N, M]
    vos_service: np.ndarray    # [N, M, S]
    vos_t: np.ndarray          # [N, M, T]
    lat_mean: np.ndarray       # [N, M, S]
    drop_frac: np.ndarray      # [N, M]
    drop_t: np.ndarray         # [N, M, T]
    feasible: np.ndarray       # [M] bool
    order: List[str]
    t_bins: np.ndarray         # [T] bin start times (s)
    max_vos: float             # Σ gamma·fires — normalization denominator

    @property
    def n_realizations(self) -> int:
        return self.vos.shape[0]

    @property
    def n_plans(self) -> int:
        return self.vos.shape[1]


class FluidEngine:
    """Compiled fluid twin of one :class:`ScenarioEngine`.

    Shares the engine's (already driven) fire trace, so compiling is
    cheap. ``device`` is where the stepper runs: ``None`` is the CUDA card
    (an error where there is none), ``"cpu"`` the host. ``evaluations``
    counts the calls, ``repeated_shapes`` those whose shape an earlier
    call had and ``graph_captures`` the CUDA graphs they captured.
    """

    def __init__(self, engine, dt_s: Optional[float] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        engine._ensure_driven()
        _, staps, _ = engine._driven
        cfg = engine.cfg
        self.engine = engine
        self.order: List[str] = list(engine.order)
        self.rank = {s: i for i, s in enumerate(self.order)}
        self.topology = engine.topology
        S = len(self.order)
        self.horizon_s = float(cfg.horizon_s)
        self.grid_chips = float(cfg.grid_shape[0] * cfg.grid_shape[1])
        self.records_per_step = float(cfg.records_per_step)

        fleet = cfg.fleet
        self.site_names: List[str] = list(fleet.site_names)
        self._site_idx = {n: j for j, n in enumerate(self.site_names)}
        J = len(self.site_names)
        edges = [fleet.site(n).edge for n in self.site_names]
        links = [fleet.site(n).link for n in self.site_names]
        self._thr = np.array([e.throughput_rps for e in edges])
        self._fps = np.array([e.flops_per_s for e in edges])
        self._ovh = np.array([e.fire_overhead_s for e in edges])
        self._epr = np.array([e.energy_per_record_j for e in edges])
        self._apw = np.array([e.active_power_w for e in edges])
        self._ram = np.array([e.ram_bytes for e in edges])
        self._ram_rec = np.array([e.record_bytes for e in edges])
        self._rtt = np.array([ln.rtt_s for ln in links])
        self._up_bps = np.array([ln.uplink_bps for ln in links])
        self._dn_bps = np.array([ln.downlink_bps for ln in links])
        self._wire_rec = np.array([ln.record_bytes * ln.compression
                                   for ln in links])
        self._dn_rec = np.array([ln.record_bytes for ln in links])
        user = self._site_idx[fleet.result_site]
        self.dl_user_s = (links[user].rtt_s / 2
                          + links[user].result_bytes
                          / links[user].downlink_bps)

        # hierarchy: per-region edge tiers + RAP trunks. ``_hier`` picks
        # the stepper's branch: flat fleets take the scalar-backlog
        # program, hierarchical ones a per-region [R]-vector twin.
        regions = regions_view(fleet)
        self.n_regions = len(regions)
        rmap = {s: i for i, r in enumerate(regions) for s in r.sites}
        self._region_of = np.array([rmap[n] for n in self.site_names],
                                   dtype=int)
        self._rap = [None if r.transparent else r.rap for r in regions]
        self._hier = any(r is not None for r in self._rap)
        self._rap_res_up = np.zeros(J)
        self._rap_res_dn = np.zeros(J)
        for j in range(J):
            rap = self._rap[self._region_of[j]]
            if rap is not None:
                self._rap_res_up[j] = (rap.rtt_s / 2
                                       + links[j].result_bytes
                                       / rap.uplink_bps)
                self._rap_res_dn[j] = (rap.rtt_s / 2
                                       + links[j].result_bytes
                                       / rap.downlink_bps)
        rap_u = self._rap[self._region_of[user]]
        if rap_u is not None:
            self.dl_user_s += (rap_u.rtt_s / 2
                               + links[user].result_bytes
                               / rap_u.downlink_bps)

        # Per-service static facts -------------------------------------
        self.slide = np.empty(S)
        self.width = np.empty(S)
        self.budget = np.empty(S)
        self.flops = np.empty(S)
        self.farm_site = np.empty(S, dtype=int)
        self.queue_of: List[str] = []
        self.gamma = np.empty(S)
        self.wp = np.empty(S)
        self.we = np.empty(S)
        self.p_soft = np.empty(S)
        self.p_hard = np.empty(S)
        self.e_soft = np.empty(S)
        self.e_hard = np.empty(S)
        self.is_exp = np.zeros(S)
        self.is_root = np.zeros(S)
        self._ups: List[List[str]] = []
        for si, s in enumerate(self.order):
            prof = engine.profiles[s]
            info = engine.services_info[s]
            spec = prof.slo.value_spec()
            self.slide[si] = float(info.slide_s)
            self.width[si] = float(info.width_s)
            self.budget[si] = float(info.buffer_budget)
            self.flops[si] = float(prof.flops_per_record)
            self.farm_site[si] = self._site_idx[fleet.farm_site(info.queue)]
            self.queue_of.append(info.queue)
            self.gamma[si] = spec.gamma
            self.wp[si] = spec.w_p
            self.we[si] = spec.w_e
            self.p_soft[si] = spec.perf_curve.th_soft
            self.p_hard[si] = spec.perf_curve.th_hard
            self.e_soft[si] = spec.energy_curve.th_soft
            self.e_hard[si] = spec.energy_curve.th_hard
            self.is_exp[si] = 1.0 if prof.slo.shape == "exponential" else 0.0
            ups = list(self.topology[s])
            self._ups.append(ups)
            self.is_root[si] = 1.0 if not ups else 0.0

        self.dt = float(dt_s if dt_s is not None else self.slide.min())
        if self.dt <= 0:
            raise ValueError("fluid bin width must be positive")
        self.T = int(math.floor(self.horizon_s / self.dt + 1e-9)) + 1
        self.t_bins = np.arange(self.T) * self.dt

        # Bin the placement-independent fire trace ---------------------
        self.U = 1 + max((len(u) for u in self._ups), default=0)
        T, U = self.T, self.U
        self.fires = np.zeros((T, S))
        nw_sum = np.zeros((T, S))
        orig_sum = np.zeros((T, S, U))
        for si, s in enumerate(self.order):
            keys = [None] + self._ups[si]
            for f in staps[s].fires:
                k = min(int(f.ts / self.dt + 1e-9), T - 1)
                self.fires[k, si] += 1.0
                nw_sum[k, si] += f.n_window
                for ui, okey in enumerate(keys):
                    orig_sum[k, si, ui] += f.origins.get(okey, 0)
        cnt = np.maximum(self.fires, 1.0)
        self.nw = nw_sum / cnt           # per-fire mean window size
        self.orig = orig_sum / cnt[:, :, None]   # per-fire origin counts
        self.total_orig = orig_sum.sum(axis=0)   # [S, U] trace totals
        self.fires_total = self.fires.sum(axis=0)
        self.max_vos = float((self.gamma * self.fires_total).sum())

        # earlier-rank alignment factors (screen's rank-blocking term)
        self.align_rank = np.zeros((S, S))
        for si in range(S):
            for oi in range(si):
                self.align_rank[si, oi] = min(
                    1.0, self.slide[si] / self.slide[oi])

        self._sim = None
        self._graphs = G.Graphs(capacity=8)   # one per repeated shape
        self.evaluations = 0
        self.repeated_shapes = 0
        self.graph_captures = 0

    # ------------------------------------------------------------------
    @classmethod
    def compile(cls, source, dt_s: Optional[float] = None,
                device: DeviceLike = None) -> "FluidEngine":
        """Lower a ``ScenarioSpec`` (compiled on the spot) or an
        already-compiled ``ScenarioEngine`` into a fluid engine."""
        engine = source.compile() if hasattr(source, "compile") else source
        return cls(engine, dt_s=dt_s, device=device)

    # ------------------------------------------------------- realizations
    def base_realization(self) -> Dict[str, np.ndarray]:
        """The nominal (unperturbed) single realization: unit rate
        modulation, the engine's own outage windows."""
        T, S = self.T, len(self.order)
        fdown, recover = self.outage_arrays(self.engine.outages)
        return {
            "modw": np.ones((1, T, S)),
            "mods": np.ones((1, T, S)),
            "fdown": fdown[None],
            "recover": recover[None],
        }

    def outage_arrays(self, outages: Mapping[str, Sequence]):
        """Lower per-site ``(down, up)`` windows to per-bin capacity
        fractions and recovery waits (fire deferral to outage end)."""
        T, J = self.T, len(self.site_names)
        fdown = np.zeros((T, J))
        recover = np.zeros((T, J))
        for site, wins in (outages or {}).items():
            j = self._site_idx.get(site)
            if j is None:
                continue
            for d, u in wins:
                for k in range(T):
                    t0, t1 = self.t_bins[k], self.t_bins[k] + self.dt
                    ov = max(0.0, min(t1, u) - max(t0, d))
                    fdown[k, j] = min(1.0, fdown[k, j] + ov / self.dt)
                    if d <= t0 < u:
                        recover[k, j] = max(recover[k, j], u - t0)
        return fdown, recover

    # ------------------------------------------------------ plan lowering
    def lower_plans(self, plans: Sequence[PlacementPlan],
                    corrections=None,
                    stalls: Optional[Mapping[int, Mapping[str, float]]] = None
                    ) -> Dict[str, np.ndarray]:
        """Dense per-plan arrays for the batched stepper. ``corrections``
        is the per-service calibration mapping the screen/forecast tiers
        use (duck-typed ``.tier(is_edge)`` → q_mult/lat_bias_s/
        drop_offset); ``stalls`` maps plan index → per-service
        stall-until times (migration charges)."""
        M, S, J, U = len(plans), len(self.order), len(self.site_names), self.U
        Z = dict(
            isdc=np.zeros((M, S)), onehot=np.zeros((M, S, J)),
            thr=np.ones((M, S)), fps=np.ones((M, S)),
            ovh=np.zeros((M, S)), epr=np.zeros((M, S)),
            apw=np.zeros((M, S)), tstep=np.zeros((M, S)),
            estep=np.zeros((M, S)), chips=np.zeros((M, S)),
            hop=np.zeros((M, S)), stall=np.zeros((M, S)),
            alignsite=np.zeros((M, S, S)), act=np.zeros((M, S, U)),
            rtt_leg=np.zeros((M, S, U)), upsec_pr=np.zeros((M, S, U)),
            dn_pr=np.zeros((M, S, U)),
            uses_up=np.zeros((M, S)), qm=np.ones((M, S)),
            qb=np.zeros((M, S)), keep=np.ones((M, S)),
        )
        if self._hier:
            # per-move origin-region one-hot + RAP trunk leg coefficients
            Z.update(
                oreg=np.zeros((M, S, U, self.n_regions)),
                rap_upsec_pr=np.zeros((M, S, U)),
                rap_rtt=np.zeros((M, S, U)),
                rap_dn_pr=np.zeros((M, S, U)),
                rap_uses=np.zeros((M, S, U)),
            )
        feasible = np.ones(M, dtype=bool)
        corr = dict(corrections or {})
        cost = self.engine.cost
        for m, plan in enumerate(plans):
            exec_site = np.empty(S, dtype=int)
            ram_need = np.zeros(J)
            for si, s in enumerate(self.order):
                p = plan.placement(s)
                if p.is_edge:
                    j = self._site_idx[p.site]
                    exec_site[si] = j
                    Z["onehot"][m, si, j] = 1.0
                    Z["thr"][m, si] = self._thr[j]
                    Z["fps"][m, si] = self._fps[j]
                    Z["ovh"][m, si] = self._ovh[j]
                    Z["epr"][m, si] = self._epr[j]
                    Z["apw"][m, si] = self._apw[j]
                    ram_need[j] += self.budget[si] * self._ram_rec[j]
                else:
                    exec_site[si] = -1
                    Z["isdc"][m, si] = 1.0
                    Z["tstep"][m, si] = cost.time_per_step(
                        f"svc:{s}", "window", p.chips, p.dvfs_f)
                    Z["estep"][m, si] = cost.energy_per_step(
                        f"svc:{s}", "window", p.chips, p.dvfs_f)
                    Z["chips"][m, si] = float(p.chips)
                cal = corr.get(s)
                c = cal.tier(p.is_edge) if cal is not None else None
                if c is not None:
                    Z["qm"][m, si] = c.q_mult
                    Z["qb"][m, si] = c.lat_bias_s
                    Z["keep"][m, si] = max(0.0, 1.0 - c.drop_offset)
            feasible[m] = bool((ram_need <= self._ram).all())
            for si, s in enumerate(self.order):
                my = exec_site[si]
                # result-handoff hop (max over upstream cuts; DC pays
                # nothing extra — folded into dl_user, like the screen)
                h = 0.0
                for u in self._ups[si]:
                    us = exec_site[self.rank[u]]
                    if my >= 0 and us != my:
                        hh = (self._rtt[my] / 2
                              + (self._rtt[us] / 2 if us >= 0 else 0.0))
                        if self._hier and (
                                us < 0 or self._region_of[us]
                                != self._region_of[my]):
                            # cross-region handoff: src RAP up + dst down
                            if us >= 0:
                                hh += self._rap_res_up[us]
                            hh += self._rap_res_dn[my]
                        h = max(h, hh)
                Z["hop"][m, si] = h
                if my >= 0:
                    for oi in range(si):
                        if exec_site[oi] == my:
                            Z["alignsite"][m, si, oi] = \
                                self.align_rank[si, oi]
                # cross-site raw-record haul coefficients per origin
                keys = [None] + self._ups[si]
                for ui, okey in enumerate(keys):
                    if self.total_orig[si, ui] <= 0.0:
                        continue
                    osite = (self.farm_site[si] if okey is None
                             else exec_site[self.rank[okey]])
                    if osite < 0 or osite == my:
                        continue
                    Z["act"][m, si, ui] = 1.0
                    Z["rtt_leg"][m, si, ui] = self._rtt[osite] / 2
                    Z["upsec_pr"][m, si, ui] = (self._wire_rec[osite]
                                                / self._up_bps[osite])
                    if my >= 0:   # relay onto another edge: its downlink
                        Z["rtt_leg"][m, si, ui] += self._rtt[my] / 2
                        Z["dn_pr"][m, si, ui] = (self._dn_rec[my]
                                                 / self._dn_bps[my])
                    if self._hier:
                        rj = int(self._region_of[osite])
                        Z["oreg"][m, si, ui, rj] = 1.0
                        if my < 0 or self._region_of[my] != rj:
                            rap = self._rap[rj]
                            if rap is not None:
                                Z["rap_uses"][m, si, ui] = 1.0
                                Z["rap_upsec_pr"][m, si, ui] = (
                                    self._wire_rec[osite] / rap.uplink_bps)
                                Z["rap_rtt"][m, si, ui] = rap.rtt_s / 2
                            if my >= 0:
                                rapd = self._rap[self._region_of[my]]
                                if rapd is not None:
                                    Z["rap_rtt"][m, si, ui] += \
                                        rapd.rtt_s / 2
                                    Z["rap_dn_pr"][m, si, ui] = (
                                        self._dn_rec[my]
                                        / rapd.downlink_bps)
                Z["uses_up"][m, si] = float(Z["act"][m, si].any())
            if stalls and m in stalls:
                for s, until in stalls[m].items():
                    Z["stall"][m, self.rank[s]] = float(until)
        Z["feasible"] = feasible
        return Z

    def migration_stalls(self, prev_plan: Optional[PlacementPlan],
                         plans: Sequence[PlacementPlan],
                         at_s: float = 0.0) -> Dict[int, Dict[str, float]]:
        """Per-plan stall-until times for migrating off ``prev_plan`` at
        ``at_s`` — the analytic form of ``core.elastic.plan_replacement``
        charges (state bytes over the origin uplink + warm-up)."""
        if prev_plan is None:
            return {}
        from repro_torch.core.elastic import plan_replacement
        cfg = self.engine.cfg
        out: Dict[int, Dict[str, float]] = {}
        for m, plan in enumerate(plans):
            migs = plan_replacement(
                prev_plan.assignments, plan.assignments,
                state_bytes_fn=lambda s: (
                    self.budget[self.rank[s]] * cfg.state_bytes_per_record),
                transfer_time_fn=self._transfer_time,
                warmup_s=cfg.migration_warmup_s)
            if migs:
                out[m] = {mig.service: at_s + mig.stall_s for mig in migs}
        return out

    def _transfer_time(self, src: str, dst: str, nbytes: float) -> float:
        j = self._site_idx.get(src)
        if j is None:    # DC-origin state rides the destination downlink
            j = self._site_idx.get(dst)
            if j is None:
                return 0.0
            return self._rtt[j] / 2 + nbytes / self._dn_bps[j]
        return self._rtt[j] / 2 + nbytes / self._up_bps[j]


    # ----------------------------------------------------------- the core
    def _build_sim(self):
        """The trace's arrays and the stepper's constants as float32
        tensors on the engine's device, built once per engine."""
        dev = self.device
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                        device=dev)
        # A quotient by a constant is taken as the product with its float32
        # reciprocal, as the JAX package's compiled program takes it (XLA
        # folds ``x / c`` into ``x * (1 / c)``), so both round alike.
        rcp = lambda a: f32(np.float32(1.0) / np.asarray(a, np.float32))
        span = lambda soft, hard: np.maximum(
            np.asarray(hard, np.float32) - np.asarray(soft, np.float32),
            np.float32(1e-9))
        U = self.U
        self._sim = SimpleNamespace(
            fires=f32(self.fires), nw=f32(self.nw), orig=f32(self.orig),
            t_bins=f32(self.t_bins), budget=f32(self.budget),
            flops=f32(self.flops), gamma=f32(self.gamma), wp=f32(self.wp),
            we=f32(self.we), p_soft=f32(self.p_soft),
            p_hard=f32(self.p_hard), e_soft=f32(self.e_soft),
            e_hard=f32(self.e_hard), is_exp=f32(self.is_exp),
            is_root=f32(self.is_root),
            p_rspan=rcp(span(self.p_soft, self.p_hard)),
            e_rspan=rcp(span(self.e_soft, self.e_hard)),
            u0=f32(np.eye(1, U, 0)[0]),           # [U] one-hot on the farm slot
            rcp_rps=rcp(self.records_per_step), rcp_dt=rcp(self.dt),
            rcp_grid=rcp(self.grid_chips))

    def _curve(self, x, soft, hard, rspan):
        # ValueCurve with (v_max, v_min) = (1, 0.1): full value at or
        # under soft, 0 past hard, linear or 3-e-fold decay between.
        frac = torch.clamp((x - soft) * rspan, 0.0, 1.0)
        mid = torch.where(self._sim.is_exp > 0,
                          0.1 + 0.9 * torch.exp(-3.0 * frac),
                          1.0 - 0.9 * frac)
        return torch.where(x <= soft, 1.0, torch.where(x > hard, 0.0, mid))

    def _step(self, k, P, R, carry):
        """One time bin for every (realization, plan): plan tensors ``P``
        are ``[M, ...]``, realization tensors ``R`` ``[N, T, ...]`` and the
        carries ``[N, M, ...]``. The reference's vmapped scan body, term
        for term, broadcast over the leading ``[N, M]``."""
        c, hier, dt = self._sim, self._hier, self.dt
        if hier:
            B, Bup, Brap = carry
        else:
            B, Bup = carry
        fires_t, nw_t, orig_t, tb = c.fires[k], c.nw[k], c.orig[k], \
            c.t_bins[k]
        modw_t, mods_t = R["modw"][:, k, None], R["mods"][:, k, None]
        fdown_t, recov_t = R["fdown"][:, k, None], R["recover"][:, k, None]
        nwm = torch.minimum(torch.clamp_min(
            nw_t * torch.where(c.is_root > 0, modw_t, 1.0), 0.0), c.budget)
        dur_e = (torch.maximum(nwm / P["thr"], nwm * c.flops / P["fps"])
                 + P["ovh"])                                      # [N, M, S]
        steps = torch.clamp_min(torch.ceil(nwm * c.rcp_rps), 1.0)
        dur_d = steps * P["tstep"]
        isdc = P["isdc"]
        edge_work = (1.0 - isdc) * dur_e * fires_t
        work_j = (edge_work.unsqueeze(-2) @ P["onehot"]).squeeze(-2)  # [N, M, J]
        # origin record counts per fire: the farm slot scales with the
        # realization's slide-window modulation, upstream slots fire once
        # per upstream fire regardless
        farm_mod = torch.where(c.is_root > 0, mods_t, 1.0)
        modc = torch.where(c.u0 > 0, farm_mod[..., None], 1.0)
        cc = orig_t * modc                                       # [N, 1, S, U]
        if hier:
            # per-region twins of the flat edge-tier terms plus the RAP
            # trunk, every per-move quantity routed through the move's
            # origin-region one-hot ``oreg`` [M, S, U, R]
            oreg = P["oreg"]
            upsec_su = P["act"] * cc * P["upsec_pr"]
            up_work_r = torch.einsum("nmsu,msur->nmr",
                                     upsec_su * fires_t[:, None], oreg)
            q_up_su = torch.einsum("msur,nmr->nmsu", oreg, q_factor_torch(
                torch.clamp_max(up_work_r * c.rcp_dt, _UPLINK_Q_CLAMP)))
            rapsec_su = P["act"] * cc * P["rap_upsec_pr"]
            rap_work_r = torch.einsum("nmsu,msur->nmr",
                                      rapsec_su * fires_t[:, None], oreg)
            q_rap_su = torch.einsum("msur,nmr->nmsu", oreg, q_factor_torch(
                torch.clamp_max(rap_work_r * c.rcp_dt, _UPLINK_Q_CLAMP)))
            haul = ((P["act"]
                     * (P["rtt_leg"]
                        + cc * P["upsec_pr"] * q_up_su
                        + cc * P["dn_pr"]
                        + P["rap_rtt"]
                        + cc * P["rap_upsec_pr"] * q_rap_su
                        + cc * P["rap_dn_pr"])).sum(-1)
                    + (P["act"] * torch.einsum("msur,nmr->nmsu", oreg,
                                               Bup)).amax(-1)
                    + (P["rap_uses"] * torch.einsum("msur,nmr->nmsu", oreg,
                                                    Brap)).amax(-1))
        else:
            upsec = (P["act"] * cc * P["upsec_pr"]).sum(-1)
            up_work = (upsec * fires_t).sum(-1)                   # [N, M]
            q_up = q_factor_torch(torch.clamp_max(up_work * c.rcp_dt,
                                                  _UPLINK_Q_CLAMP))
            haul = ((P["act"]
                     * (P["rtt_leg"]
                        + cc * P["upsec_pr"] * q_up[..., None, None]
                        + cc * P["dn_pr"])).sum(-1)
                    + P["uses_up"] * Bup[..., None])
        demand = (isdc * P["chips"] * dur_d * fires_t).sum(-1) * c.rcp_dt
        dc_over = torch.clamp_min(demand * c.rcp_grid, 1.0)[..., None]
        rw = (edge_work.unsqueeze(-2)
              @ P["alignsite"].transpose(-1, -2)).squeeze(-2)
        onehot_t = P["onehot"].transpose(-1, -2)
        B_here = (B.unsqueeze(-2) @ onehot_t).squeeze(-2)
        recov_s = (recov_t.unsqueeze(-2) @ onehot_t).squeeze(-2)
        stall_x = torch.clamp_min(P["stall"] - tb, 0.0)
        lat_e = (B_here + rw + dur_e + P["hop"] + haul
                 + recov_s + stall_x)
        lat_d = haul + dur_d * dc_over + self.dl_user_s + stall_x
        lat = torch.where(isdc > 0, lat_d, lat_e)
        lat = torch.clamp_min(P["qm"] * lat + P["qb"], 0.0)
        en = torch.where(isdc > 0, steps * P["estep"],
                         nwm * P["epr"] + dur_e * P["apw"])
        vp = self._curve(lat, c.p_soft, c.p_hard, c.p_rspan)
        ve = self._curve(en, c.e_soft, c.e_hard, c.e_rspan)
        v = torch.where((vp > 0) & (ve > 0),
                        c.gamma * (c.wp * vp + c.we * ve), 0.0)
        v = v * P["keep"]
        B2 = torch.clamp_min(B + work_j - dt * (1.0 - fdown_t), 0.0)
        ys = (v * fires_t, lat * fires_t,
              torch.where(v <= 0.0, fires_t, 0.0))
        if hier:
            Bup2 = torch.clamp_min(Bup + up_work_r - dt, 0.0)
            Brap2 = torch.clamp_min(Brap + rap_work_r - dt, 0.0)
            return (B2, Bup2, Brap2), ys
        Bup2 = torch.clamp_min(Bup + up_work - dt, 0.0)
        return (B2, Bup2), ys

    def _run(self, P, R):
        """The whole time loop; the value, latency and dead-fire
        trajectories, each ``[N, M, T, S]``."""
        N, M = R["modw"].shape[0], P["isdc"].shape[0]
        J, Rg = len(self.site_names), self.n_regions
        z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                       device=self.device)
        carry = ((z(N, M, J), z(N, M, Rg), z(N, M, Rg)) if self._hier
                 else (z(N, M, J), z(N, M)))
        ys = []
        for k in range(self.T):
            carry, y = self._step(k, P, R, carry)
            ys.append(y)
        return tuple(torch.stack(col, dim=2) for col in zip(*ys))

    # ------------------------------------------------------------- fronts
    def evaluate(self, plans: Sequence[PlacementPlan],
                 realizations: Optional[Mapping[str, np.ndarray]] = None,
                 corrections=None,
                 stalls: Optional[Mapping[int, Mapping[str, float]]] = None,
                 jit: bool = True) -> FluidResult:
        """Score every plan under every realization in one batched call.

        ``realizations`` is the array bundle built by
        :class:`repro_torch.fluid.ensemble.ScenarioEnsemble` (default: the
        single nominal realization). ``jit=True`` runs the time loop by
        ``repro_torch.graphs``' rule (on the card, a CUDA graph from a
        shape's second call on); ``jit=False`` always op by op."""
        if self._sim is None:
            self._build_sim()
        real = dict(realizations if realizations is not None
                    else self.base_realization())
        Z = self.lower_plans(plans, corrections=corrections, stalls=stalls)
        feasible = Z.pop("feasible")
        f32 = lambda a: torch.as_tensor(np.asarray(a)).to(
            device=self.device, dtype=torch.float32)
        plan_arrs = {k: f32(v) for k, v in Z.items()}
        real_arrs = {k: f32(v) for k, v in real.items()}
        self.evaluations += 1
        self.repeated_shapes += (G.shape_key(plan_arrs, real_arrs)
                                 in self._graphs.seen)
        with _full_fp32():
            if jit:
                outs, how = self._graphs(self._run, plan_arrs, real_arrs)
                self.graph_captures += how == "capture"
            else:
                self._graphs.note(plan_arrs, real_arrs)
                outs = self._run(plan_arrs, real_arrs)
        vv, latw, dead = (np.asarray(a.cpu().numpy(), dtype=np.float64)
                          for a in outs)
        # vv/latw/dead: [N, M, T, S]
        vos_service = vv.sum(axis=2)
        vos = vos_service.sum(axis=-1)
        vos_t = vv.sum(axis=-1)
        ftot = np.maximum(self.fires_total, 1.0)
        lat_mean = latw.sum(axis=2) / ftot[None, None, :]
        fires_t = np.maximum(self.fires.sum(axis=-1), 1.0)
        drop_t = dead.sum(axis=-1) / fires_t[None, None, :]
        drop_frac = dead.sum(axis=(2, 3)) / max(self.fires_total.sum(), 1.0)
        vos[:, ~feasible] = float("-inf")
        return FluidResult(vos=vos, vos_service=vos_service, vos_t=vos_t,
                           lat_mean=lat_mean, drop_frac=drop_frac,
                           drop_t=drop_t, feasible=feasible,
                           order=list(self.order),
                           t_bins=self.t_bins.copy(),
                           max_vos=self.max_vos)


@contextlib.contextmanager
def _full_fp32():
    """Matrix products in full float32 (no TF32) for the block's launches
    and for any graph captured inside it."""
    was = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(was)
