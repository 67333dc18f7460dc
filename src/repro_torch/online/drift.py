"""Deterministic workload-drift generators.

The online controller exists because record rates *move*: diurnal tides,
flash-crowd bursts, and sites dropping out. Everything here is a pure
function of simulated time and a seed — two runs of the same scenario
produce bit-identical record streams, which the determinism acceptance
criterion (and the oracle baseline, which replays the same drive)
depends on.

Rate curves are callables ``t -> rate_hz`` composed per farm queue; the
:class:`DriftingFarm` advances producers whose inter-record gap tracks
the instantaneous curve. Site outages are plain ``(down, up)`` windows
consumed by :class:`~repro_torch.online.fleet.EdgeSite`.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.pipeline.streams import Broker, StreamProducer

RateCurve = Callable[[float], float]

_MIN_RATE_HZ = 1e-6


def _tag(curve: RateCurve, kind: str, **params) -> RateCurve:
    """Attach the declarative recipe to a curve closure so ensemble
    sampling (:meth:`DriftScenario.sample`) can perturb it structurally
    (re-seed a poisson process, shift a diurnal phase) instead of just
    scaling the opaque callable."""
    curve.drift_kind = kind          # type: ignore[attr-defined]
    curve.drift_params = params      # type: ignore[attr-defined]
    return curve


def constant(rate_hz: float) -> RateCurve:
    return _tag(lambda t: rate_hz, "constant", rate_hz=rate_hz)


def diurnal(base_hz: float, amplitude: float = 0.5,
            period_s: float = 3600.0, phase_s: float = 0.0) -> RateCurve:
    """Sinusoidal tide around ``base_hz``: rate(t) = base·(1 + a·sin).
    ``amplitude`` in [0, 1) keeps the rate strictly positive."""
    if not 0.0 <= amplitude < 1.0:
        raise ValueError("amplitude must be in [0, 1)")

    def curve(t: float) -> float:
        return base_hz * (1.0 + amplitude
                          * math.sin(2 * math.pi * (t - phase_s) / period_s))
    return _tag(curve, "diurnal", base_hz=base_hz, amplitude=amplitude,
                period_s=period_s, phase_s=phase_s)


def step_bursts(base_hz: float, burst_hz: float,
                windows: Sequence[Tuple[float, float]]) -> RateCurve:
    """Explicit burst windows: ``burst_hz`` inside, ``base_hz`` outside."""
    wins = sorted(windows)

    def curve(t: float) -> float:
        for t0, t1 in wins:
            if t0 <= t < t1:
                return burst_hz
        return base_hz
    return _tag(curve, "step_bursts", base_hz=base_hz, burst_hz=burst_hz,
                windows=tuple(wins))


def piecewise_linear(points: Sequence[Tuple[float, float]]) -> RateCurve:
    """Linear interpolation through (t, rate) knots — ramps, trapezoid
    bursts, any hand-drawn drift shape. Clamps outside the knot range."""
    pts = sorted(points)
    if len(pts) < 2:
        raise ValueError("need at least two (t, rate) points")

    def curve(t: float) -> float:
        if t <= pts[0][0]:
            return pts[0][1]
        for (t0, r0), (t1, r1) in zip(pts, pts[1:]):
            if t <= t1:
                frac = (t - t0) / max(t1 - t0, 1e-12)
                return r0 + frac * (r1 - r0)
        return pts[-1][1]
    return _tag(curve, "piecewise_linear", points=tuple(pts))


def poisson_bursts(base_hz: float, burst_hz: float, horizon_s: float,
                   mean_gap_s: float, mean_len_s: float,
                   seed: int = 0) -> RateCurve:
    """Bursts whose starts form a (seeded, hence deterministic) Poisson
    process with mean gap ``mean_gap_s`` and exponential lengths."""
    rng = random.Random(seed * 6271 + 17)
    wins: List[Tuple[float, float]] = []
    t = rng.expovariate(1.0 / mean_gap_s)
    while t < horizon_s:
        length = rng.expovariate(1.0 / mean_len_s)
        wins.append((t, min(t + length, horizon_s)))
        t += length + rng.expovariate(1.0 / mean_gap_s)
    return _tag(step_bursts(base_hz, burst_hz, wins), "poisson_bursts",
                base_hz=base_hz, burst_hz=burst_hz, horizon_s=horizon_s,
                mean_gap_s=mean_gap_s, mean_len_s=mean_len_s, seed=seed)


def _lognorm(rng: random.Random, sigma: float) -> float:
    return math.exp(rng.gauss(0.0, sigma))


def perturb_curve(curve: RateCurve, rng: random.Random,
                  rate_scale: float = 0.15) -> RateCurve:
    """One perturbed realization of a rate curve: structural jitter for
    tagged curves (the factories above), a plain lognormal amplitude
    scale for opaque callables. Deterministic in ``rng``'s state."""
    kind = getattr(curve, "drift_kind", None)
    p = dict(getattr(curve, "drift_params", {}) or {})
    if kind == "constant":
        return constant(p["rate_hz"] * _lognorm(rng, rate_scale))
    if kind == "diurnal":
        return diurnal(
            p["base_hz"] * _lognorm(rng, rate_scale),
            amplitude=min(0.95, p["amplitude"] * _lognorm(rng, rate_scale)),
            period_s=p["period_s"],
            phase_s=p["phase_s"] + rng.gauss(0.0, p["period_s"] / 12.0))
    if kind == "step_bursts":
        wins = []
        for t0, t1 in p["windows"]:
            length = max(1e-9, (t1 - t0) * _lognorm(rng, rate_scale))
            start = max(0.0, t0 + rng.gauss(0.0, 0.1 * (t1 - t0)))
            wins.append((start, start + length))
        return step_bursts(p["base_hz"] * _lognorm(rng, rate_scale),
                           p["burst_hz"] * _lognorm(rng, rate_scale), wins)
    if kind == "piecewise_linear":
        return piecewise_linear(
            [(t, r * _lognorm(rng, rate_scale)) for t, r in p["points"]])
    if kind == "poisson_bursts":
        return poisson_bursts(
            p["base_hz"] * _lognorm(rng, rate_scale),
            p["burst_hz"] * _lognorm(rng, rate_scale),
            p["horizon_s"], p["mean_gap_s"], p["mean_len_s"],
            seed=rng.randrange(2 ** 31))   # resampled arrival process
    factor = _lognorm(rng, rate_scale)
    return _tag(lambda t: factor * curve(t), "scaled", factor=factor)


def perturb_outages(outages, rng: random.Random,
                    onset_scale: float = 0.1):
    """Jitter each outage window's onset (duration preserved, onsets
    clamped at 0) — the outage-noise half of ensemble sampling."""
    out = {}
    for site, wins in outages.items():
        jittered = []
        for d, u in wins:
            length = u - d
            start = max(0.0, d + rng.gauss(0.0, onset_scale * max(length,
                                                                  1e-9)))
            jittered.append((start, start + length))
        out[site] = tuple(sorted(jittered))
    return out


class DriftingProducer(StreamProducer):
    """One 'thing' whose inter-record gap tracks a rate curve. Record
    payloads reuse the Neubot-shaped schema of the base producer."""

    def __init__(self, broker: Broker, queue: str, thing_id: int,
                 curve: RateCurve, seed: int = 0):
        super().__init__(broker, queue, thing_id, rate_hz=1.0, seed=seed)
        self.curve = curve

    def advance_to(self, ts: float) -> int:
        n = 0
        while self._next_t <= ts:
            self.q.publish(self._record(self._next_t))
            rate = max(self.curve(self._next_t), _MIN_RATE_HZ)
            self._next_t += 1.0 / rate
            n += 1
        return n


class DriftingFarm:
    """An IoT farm of drift-modulated producers on one queue (the
    per-thing curve is the farm curve: the *aggregate* queue rate is
    ``n_things × curve(t)``)."""

    def __init__(self, broker: Broker, curve: RateCurve,
                 queue: str = "neubotspeed", n_things: int = 8,
                 seed: int = 0):
        self.producers = [DriftingProducer(broker, queue, i, curve, seed)
                          for i in range(n_things)]

    def advance_to(self, ts: float) -> int:
        return sum(p.advance_to(ts) for p in self.producers)


@dataclasses.dataclass(frozen=True)
class DriftScenario:
    """A named drift shape: per-queue rate curves plus site outage
    windows, applied on top of a fleet/pipeline scenario."""
    name: str
    curves: Dict[str, RateCurve] = dataclasses.field(default_factory=dict)
    outages: Dict[str, Tuple[Tuple[float, float], ...]] = \
        dataclasses.field(default_factory=dict)

    def curve(self, queue: str, default_hz: float = 1.0) -> RateCurve:
        return self.curves.get(queue, constant(default_hz))

    def sample(self, rng, n: int,
               rate_scale: float = 0.15,
               onset_scale: float = 0.1) -> Tuple["DriftScenario", ...]:
        """``n`` perturbed realizations of this drift shape — the
        ensemble source for the fluid engine. ``rng`` is a seed int or a
        ``random.Random``; the same seed yields bit-identical
        realizations (curves and outages alike). Jitter is structural
        where the curve recipe is known: diurnal phase/amplitude,
        burst-window onsets/lengths, re-seeded poisson arrival
        processes, per-knot piecewise rates."""
        if not isinstance(rng, random.Random):
            rng = random.Random(rng)
        reals = []
        for k in range(n):
            curves = {q: perturb_curve(c, rng, rate_scale)
                      for q, c in sorted(self.curves.items())}
            outages = perturb_outages(self.outages, rng, onset_scale)
            reals.append(dataclasses.replace(
                self, name=f"{self.name}#{k}", curves=curves,
                outages=outages))
        return tuple(reals)
