"""Drift ensembles for the fluid engine: sampled scenario realizations.

A realization is itself a valid ``ScenarioSpec`` — the base spec with
every farm's declarative ``RateSpec`` structurally perturbed (the same
jitter family as ``repro_torch.online.drift.perturb_curve``: lognormal
base/burst rates, diurnal phase/amplitude jitter, re-seeded poisson
arrival processes) and outage onsets jittered. That keeps the exact DES
available as ground truth for *any* ensemble member: compile the
realization spec and ``run_plan`` it.

The fluid engine consumes realizations as rate-*modulation* arrays
``mod[n, t, s] = windowed_rate_realization / windowed_rate_base``
evaluated over each service's window (for window sizes) and slide (for
newly-covered record counts), so the placement-independent fire trace
is scaled, not re-driven — which is what makes N×M evaluation one
array program.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.fluid.engine import FluidEngine, FluidResult
from repro_torch.online.drift import perturb_outages
from repro_torch.scenario.spec import RateSpec, ScenarioSpec


def _lognorm(rng: random.Random, sigma: float) -> float:
    return math.exp(rng.gauss(0.0, sigma))


def perturb_rate_spec(rate: RateSpec, rng: random.Random,
                      rate_scale: float = 0.15) -> RateSpec:
    """One perturbed realization of a declarative rate curve (the
    RateSpec twin of ``drift.perturb_curve``)."""
    k = rate.kind
    if k == "constant":
        return dataclasses.replace(
            rate, base_hz=rate.base_hz * _lognorm(rng, rate_scale))
    if k == "diurnal":
        return dataclasses.replace(
            rate,
            base_hz=rate.base_hz * _lognorm(rng, rate_scale),
            amplitude=min(0.95, rate.amplitude * _lognorm(rng, rate_scale)),
            phase_s=rate.phase_s + rng.gauss(0.0, rate.period_s / 12.0))
    if k == "step_bursts":
        wins = []
        for t0, t1 in rate.windows:
            length = max(1e-9, (t1 - t0) * _lognorm(rng, rate_scale))
            start = max(0.0, t0 + rng.gauss(0.0, 0.1 * (t1 - t0)))
            wins.append((start, start + length))
        return dataclasses.replace(
            rate,
            base_hz=rate.base_hz * _lognorm(rng, rate_scale),
            burst_hz=rate.burst_hz * _lognorm(rng, rate_scale),
            windows=tuple(wins))
    if k == "piecewise_linear":
        return dataclasses.replace(
            rate, knots=tuple((t, r * _lognorm(rng, rate_scale))
                              for t, r in rate.knots))
    if k == "poisson_bursts":
        return dataclasses.replace(
            rate,
            base_hz=rate.base_hz * _lognorm(rng, rate_scale),
            burst_hz=rate.burst_hz * _lognorm(rng, rate_scale),
            seed=rng.randrange(2 ** 31))
    raise ValueError(f"unknown rate kind {k!r}")


def sample_specs(spec: ScenarioSpec, n: int, seed: int = 0,
                 rate_scale: float = 0.15,
                 onset_scale: float = 0.1) -> List[ScenarioSpec]:
    """``n`` perturbed realizations of ``spec`` (deterministic per
    seed). Farm rates are perturbed structurally, outage onsets
    jittered with durations preserved."""
    rng = random.Random(seed * 9176 + 5)
    out: List[ScenarioSpec] = []
    for k in range(n):
        farms = tuple(dataclasses.replace(
            f, rate=perturb_rate_spec(f.rate, rng, rate_scale))
            for f in spec.farms)
        outages = perturb_outages(spec.outage_map(), rng, onset_scale)
        out.append(dataclasses.replace(
            spec, name=f"{spec.name}#{k}", farms=farms,
            outages=tuple(sorted((s, tuple(w))
                                 for s, w in outages.items()))))
    return out


class _CurveTable:
    """One rate curve sampled once on a fine grid, exposing windowed
    averages at arbitrary times via the cumulative integral (so N
    realizations cost one Python sweep each, not one per bin)."""

    def __init__(self, curve, t_lo: float, t_hi: float, h: float):
        self.g = np.arange(t_lo, t_hi + h, h)
        vals = np.array([max(0.0, curve(float(t))) for t in self.g])
        self.cum = np.concatenate(
            [[0.0], np.cumsum((vals[1:] + vals[:-1]) / 2.0 * h)])

    def window_avg(self, ts: np.ndarray, w: float) -> np.ndarray:
        hi = np.interp(ts, self.g, self.cum)
        lo = np.interp(ts - w, self.g, self.cum)
        return (hi - lo) / max(w, 1e-12)


class ScenarioEnsemble:
    """A fluid engine plus N sampled drift realizations, evaluated
    against M plans in one batched call.

    ``specs[i]`` is the full ScenarioSpec of realization ``i`` — hand it
    to ``spot_check`` for exact-DES ground truth on that member. With
    ``include_nominal=True`` (default) realization 0 is the unperturbed
    base scenario."""

    def __init__(self, fluid: FluidEngine, specs: Sequence[ScenarioSpec],
                 realizations: Mapping[str, np.ndarray]):
        self.fluid = fluid
        self.specs = list(specs)
        self.realizations = dict(realizations)

    # ------------------------------------------------------------------
    @classmethod
    def from_spec(cls, spec: ScenarioSpec, n: int = 64, seed: int = 0,
                  rate_scale: float = 0.15, onset_scale: float = 0.1,
                  engine=None, dt_s: Optional[float] = None,
                  include_nominal: bool = True,
                  device: DeviceLike = None) -> "ScenarioEnsemble":
        """Build the ensemble: compile (or reuse) the base engine, lower
        it to a fluid engine, sample ``n`` perturbed realizations and
        precompute their modulation / outage arrays. When ``engine`` is
        a :class:`~repro_torch.scenario.engine.ScenarioEngine` the lowering
        goes through its cached :meth:`fluid_engine` accessor, so
        repeated ensembles on one engine (an epoch loop) share arrays
        and CUDA graphs. ``device`` is where the fluid engine runs:
        ``None`` is the CUDA card, ``"cpu"`` the host."""
        make = getattr(engine, "fluid_engine", None)
        if make is not None:
            fluid = make(dt_s=dt_s, device=device)
        else:
            fluid = FluidEngine.compile(
                engine if engine is not None else spec, dt_s=dt_s,
                device=device)
        perturbed = sample_specs(spec, n, seed=seed, rate_scale=rate_scale,
                                 onset_scale=onset_scale)
        specs = ([spec] + perturbed) if include_nominal else perturbed
        return cls(fluid, specs, cls._lower(fluid, spec, specs))

    @staticmethod
    def _lower(fluid: FluidEngine, base: ScenarioSpec,
               specs: Sequence[ScenarioSpec]) -> Dict[str, np.ndarray]:
        S = len(fluid.order)
        T, dt = fluid.T, fluid.dt
        N = len(specs)
        ts = fluid.t_bins
        w_max = float(fluid.width.max()) if S else dt
        h = min(dt, float(fluid.slide.min()) if S else dt) / 8.0
        t_lo, t_hi = -w_max - dt, fluid.horizon_s + dt

        def tables(sp: ScenarioSpec) -> Dict[str, _CurveTable]:
            return {f.queue: _CurveTable(
                f.rate.curve(sp.horizon_s), t_lo, t_hi, h)
                for f in sp.farms}

        base_tab = tables(base)
        modw = np.ones((N, T, S))
        mods = np.ones((N, T, S))
        J = len(fluid.site_names)
        fdown = np.zeros((N, T, J))
        recover = np.zeros((N, T, J))
        for ni, sp in enumerate(specs):
            tab = tables(sp)
            for si in range(S):
                if not fluid.is_root[si]:
                    continue
                q = fluid.queue_of[si]
                if q not in tab or q not in base_tab:
                    continue
                b_w = base_tab[q].window_avg(ts, fluid.width[si])
                r_w = tab[q].window_avg(ts, fluid.width[si])
                b_s = base_tab[q].window_avg(ts, fluid.slide[si])
                r_s = tab[q].window_avg(ts, fluid.slide[si])
                modw[ni, :, si] = r_w / np.maximum(b_w, 1e-9)
                mods[ni, :, si] = r_s / np.maximum(b_s, 1e-9)
            fdown[ni], recover[ni] = fluid.outage_arrays(sp.outage_map())
        return {"modw": modw, "mods": mods, "fdown": fdown,
                "recover": recover}

    # ------------------------------------------------------------------
    @property
    def n_realizations(self) -> int:
        return self.realizations["modw"].shape[0]

    def evaluate(self, plans, corrections=None, stalls=None,
                 jit: bool = True) -> FluidResult:
        """Fluid VoS of every plan under every realization — one batched
        N×M call."""
        return self.fluid.evaluate(plans, realizations=self.realizations,
                                   corrections=corrections, stalls=stalls,
                                   jit=jit)

    def spot_check(self, idx: int, plan):
        """Exact-DES ground truth for realization ``idx``: compile its
        spec and run the plan through the event-driven engine."""
        return self.specs[idx].compile().run_plan(plan)
