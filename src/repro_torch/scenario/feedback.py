"""Closed-loop forecast calibration: feed the measured calibration gap
back into plan ranking.

The engine's epoch telemetry is the *measurement* half of fleet-aware
forecast calibration: every online epoch records the forecast VoS of the
played plan, the realized co-sim VoS, and their gap. This module closes
the loop. A :class:`CalibrationLoop` accumulates, per service,
the pairing of

  * what the analytic forecast *predicted* for the played plan (raw
    per-fire latency, per-epoch VoS), against
  * what the DES engine *realized* for that epoch (mean fire latency,
    terminal drop fraction, per-epoch VoS — the per-service ledger
    residuals the engine now exposes through
    ``EpochObservation.realized_window``),

and fits three per-service correction terms by recursive least squares
with exponential forgetting:

  q_mult       queueing-inflation multiplier on the modeled latency —
               absorbs the systematic under/over-estimate of the
               analytic queueing terms (FIFO uplink waits, VDC
               composition backpressure, serial rank blocking)
  lat_bias_s   additive network-latency bias — absorbs fixed per-fire
               transport costs the closed forms miss (handoff hops,
               admission waits)
  drop_offset  drop-probability offset — the realized fraction of
               terminal fires the DC scheduler dropped, which the
               forecast (which never predicts drops) prices at full
               value

The corrections are *injected into both ranking tiers*: the online
controller's :class:`~repro_torch.online.controller.ForecastModel` applies
them per service when scoring candidate plans, and the vectorized
tier-1 :class:`~repro_torch.scenario.screen.ScreeningModel` applies them
inside ``score_matrix`` (threaded through
``repro_torch.placement.search.screened_search``), so the two-tier search
ranks with calibrated terms while the exact DES tier stays ground
truth.

Everything here is plain deterministic float math — same spec + seed
produces an identical correction history (pinned by a regression test).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

_LAT_CAP_S = 1e6     # ignore cliffed forecasts (q_factor NEVER_S)


@dataclasses.dataclass(frozen=True)
class ServiceCorrection:
    """One set of calibration terms applied on top of an analytic
    latency/value model. The identity correction is a no-op."""
    q_mult: float = 1.0        # queueing-inflation multiplier
    lat_bias_s: float = 0.0    # additive network-latency bias
    drop_offset: float = 0.0   # probability a fire realizes zero value

    def latency(self, lat_s: float) -> float:
        """Calibrated latency for a raw model latency (never negative)."""
        return max(0.0, self.q_mult * lat_s + self.lat_bias_s)

    @property
    def keep_prob(self) -> float:
        return max(0.0, 1.0 - self.drop_offset)

    @property
    def is_identity(self) -> bool:
        return (self.q_mult == 1.0 and self.lat_bias_s == 0.0
                and self.drop_offset == 0.0)

    def tier(self, is_edge: bool) -> "ServiceCorrection":
        """Flat corrections apply to both placement tiers (duck-shared
        with :class:`ServiceCalibration`)."""
        return self

    def to_dict(self) -> Dict[str, float]:
        return {"q_mult": round(self.q_mult, 4),
                "lat_bias_s": round(self.lat_bias_s, 4),
                "drop_offset": round(self.drop_offset, 4)}


_IDENTITY = ServiceCorrection()


@dataclasses.dataclass(frozen=True)
class ServiceCalibration:
    """A service's corrections, resolved per placement *tier*. The
    forecast's error structure is fundamentally different for an
    edge-hosted fire (serial device + rank blocking + cross-site hauls)
    and a DC-offloaded one (uplink transfer + VDC composition pressure
    + scheduler drops), so the loop learns the two tiers independently
    and a candidate plan is scored with the corrections of the tier it
    actually places the service on — DC drop fractions must not tax an
    edge placement."""
    edge: ServiceCorrection = _IDENTITY
    dc: ServiceCorrection = _IDENTITY

    def tier(self, is_edge: bool) -> ServiceCorrection:
        return self.edge if is_edge else self.dc

    def to_dict(self) -> Dict[str, Dict[str, float]]:
        return {"edge": self.edge.to_dict(), "dc": self.dc.to_dict()}


class _Rls2:
    """2-parameter recursive least squares with exponential forgetting:
    y ≈ theta0·x + theta1. The prior covariance is *diagonal and
    asymmetric* — a tight prior on the multiplier (a 2-point history
    must not extrapolate a slope-7 line through noisy epochs) and a
    looser one on the bias. Plain-float implementation (no RNG, no
    global state) so the loop is bit-deterministic."""

    def __init__(self, forgetting: float, p0_mult: float, p0_bias: float,
                 theta0: Tuple[float, float] = (1.0, 0.0)):
        self.lam = forgetting
        self.theta = [theta0[0], theta0[1]]
        # P starts as diag(p0_mult, p0_bias); stays symmetric [[a,b],[b,c]]
        self.p = [p0_mult, 0.0, p0_bias]

    def update(self, x: float, y: float) -> None:
        a, b, c = self.p
        t0, t1 = self.theta
        # P @ [x, 1]
        px0 = a * x + b
        px1 = b * x + c
        denom = self.lam + x * px0 + px1
        if denom <= 0.0 or not math.isfinite(denom):
            return
        k0, k1 = px0 / denom, px1 / denom
        err = y - (t0 * x + t1)
        self.theta = [t0 + k0 * err, t1 + k1 * err]
        # P <- (P - K (P x)^T) / lam, keeping symmetry explicitly
        self.p = [(a - k0 * px0) / self.lam,
                  (b - (k0 * px1 + k1 * px0) / 2.0) / self.lam,
                  (c - k1 * px1) / self.lam]


class _Rls1:
    """1-parameter RLS (constant regressor) — an exponentially forgotten
    running mean, used for the realized drop fraction."""

    def __init__(self, forgetting: float, p0: float, theta0: float = 0.0):
        self.lam = forgetting
        self.theta = theta0
        self.p = p0

    def update(self, y: float) -> None:
        k = self.p / (self.lam + self.p)
        self.theta += k * (y - self.theta)
        self.p = (self.p - k * self.p) / self.lam


class CalibrationLoop:
    """Online per-service correction fitting (see the module docstring).

    ``observe`` is fed once per *completed* epoch with the stored raw
    forecast detail of the plan that was played and the engine's
    realized per-service residuals; ``corrections`` returns the current
    clamped :class:`ServiceCorrection` per service. ``history`` keeps
    one entry per observation (epoch, per-service observed pairs, the
    corrections in force after the update) — the determinism regression
    compares two runs' histories for exact equality.
    """

    def __init__(self, services: Sequence[str], forgetting: float = 0.85,
                 p0_mult: float = 0.1, p0_bias: float = 0.25,
                 p0_drop: float = 25.0, stale_decay: float = 0.7,
                 q_mult_bounds: Tuple[float, float] = (0.3, 3.0),
                 lat_bias_bounds: Tuple[float, float] = (-5.0, 30.0),
                 drop_bounds: Tuple[float, float] = (0.0, 0.9),
                 q_mult_deadband: float = 0.25,
                 lat_bias_deadband_s: float = 0.5,
                 drop_deadband: float = 0.1):
        if not 0.0 < forgetting <= 1.0:
            raise ValueError("forgetting must be in (0, 1]")
        if not 0.0 <= stale_decay <= 1.0:
            raise ValueError("stale_decay must be in [0, 1]")
        self.services = list(services)
        self.forgetting = forgetting
        self.p0_mult = p0_mult
        self.p0_bias = p0_bias
        self.p0_drop = p0_drop
        self.stale_decay = stale_decay
        self.q_mult_bounds = q_mult_bounds
        self.lat_bias_bounds = lat_bias_bounds
        self.drop_bounds = drop_bounds
        # deadbands: a term stays *exactly* identity until its fitted
        # deviation is significant. A forecast that is already well
        # calibrated must be left bit-identical — near-zero corrections
        # would only perturb near-zero gaps and flip near-tie plan
        # decisions without evidence.
        self.q_mult_deadband = q_mult_deadband
        self.lat_bias_deadband_s = lat_bias_deadband_s
        self.drop_deadband = drop_deadband
        self.reset()

    def reset(self) -> None:
        """Forget everything (``controller.bind`` marks a run start)."""
        self._lat = {(s, t): _Rls2(self.forgetting, self.p0_mult,
                                   self.p0_bias)
                     for s in self.services for t in ("edge", "dc")}
        self._drop = {(s, t): _Rls1(self.forgetting, self.p0_drop)
                      for s in self.services for t in ("edge", "dc")}
        # epochs since a tier last learned anything: unobserved tiers
        # decay toward identity so the controller can re-explore a tier
        # it abandoned (a DC drop storm at the tide's peak must not
        # condemn the DC forever once the tide recedes)
        self._stale = {(s, t): 0 for s in self.services
                       for t in ("edge", "dc")}
        self.observations = 0
        self.history: List[Dict] = []

    # ----------------------------------------------------------- learning
    def observe(self, epoch: int, predicted: Mapping[str, Mapping],
                realized: Mapping[str, Mapping]) -> None:
        """One completed epoch. ``predicted[svc]`` carries the raw
        (uncorrected) forecast for the plan that was played — at least
        ``lat_s`` and the placement ``tier`` (``"edge"``/``"dc"``);
        ``vos`` if available. ``realized[svc]`` carries the engine's
        residuals: ``lat_mean_s``, ``completed``, ``dropped``,
        ``inflight``, ``vos``. Only the tier the plan actually placed
        the service on learns from the epoch."""
        seen: Dict[str, Dict] = {}
        learned = set()
        for svc in self.services:
            p, r = predicted.get(svc), realized.get(svc)
            if not p or not r:
                continue
            tier = p.get("tier", "edge")
            pred_lat = float(p.get("lat_s", float("nan")))
            done = int(r.get("completed", 0))
            dropped = int(r.get("dropped", 0))
            lat_mean = float(r.get("lat_mean_s", float("nan")))
            if (done > 0 and math.isfinite(pred_lat)
                    and math.isfinite(lat_mean)
                    and 0.0 <= pred_lat < _LAT_CAP_S
                    and 0.0 <= lat_mean < _LAT_CAP_S):
                self._lat[(svc, tier)].update(pred_lat, lat_mean)
                learned.add((svc, tier))
            terminal = done + dropped
            if terminal > 0:
                self._drop[(svc, tier)].update(dropped / terminal)
                learned.add((svc, tier))
            seen[svc] = {
                "tier": tier,
                "pred_lat_s": round(pred_lat, 4)
                if math.isfinite(pred_lat) else None,
                "lat_mean_s": round(lat_mean, 4)
                if math.isfinite(lat_mean) else None,
                "pred_vos": p.get("vos_raw", p.get("vos")),
                "vos": r.get("vos"),
                "completed": done, "dropped": dropped,
            }
        for key in self._stale:
            self._stale[key] = 0 if key in learned else self._stale[key] + 1
        self.observations += 1
        self.history.append({
            "epoch": epoch,
            "observed": seen,
            "corrections": {s: c.to_dict()
                            for s, c in self.corrections().items()},
        })

    def set_variance_prior(self, prior: Mapping[str, Mapping[str, float]],
                           scale: float = 0.5,
                           max_inflation: float = 4.0
                           ) -> Dict[Tuple[str, str], float]:
        """Inflate the RLS covariance of volatile (service, tier) pairs.

        ``prior[svc][tier]`` is a relative predictive-uncertainty signal
        in [0, 1] — e.g. the fluid-ensemble VoS spread from
        :func:`repro_torch.fluid.robust.calibration_prior`. Each named pair's
        latency *and* drop covariance is multiplied by
        ``min(1 + scale·rel, max_inflation)``, so services whose
        forecast varies a lot across drift realizations keep larger RLS
        gains and re-calibrate faster, while ``rel == 0`` pairs are left
        bit-identical. Calling this every epoch is the intended use: it
        counteracts covariance shrinkage exactly for the pairs the
        ensemble says are still uncertain. Plain float math —
        deterministic. Returns the applied inflation factors."""
        applied: Dict[Tuple[str, str], float] = {}
        for svc, tiers in sorted(prior.items()):
            for tier, rel in sorted(tiers.items()):
                key = (svc, tier)
                if key not in self._lat:
                    continue
                f = min(1.0 + scale * max(0.0, float(rel)), max_inflation)
                if f == 1.0:
                    continue
                lat = self._lat[key]
                lat.p = [lat.p[0] * f, lat.p[1] * f, lat.p[2] * f]
                self._drop[key].p *= f
                applied[key] = f
        return applied

    # ---------------------------------------------------------- injection
    def _tier_correction(self, svc: str, tier: str) -> ServiceCorrection:
        lo_q, hi_q = self.q_mult_bounds
        lo_b, hi_b = self.lat_bias_bounds
        lo_d, hi_d = self.drop_bounds
        lat = self._lat[(svc, tier)]
        drop = self._drop[(svc, tier)]
        # shrink stale tiers toward identity (re-exploration), then
        # zero out sub-deadband terms (see __init__)
        w = self.stale_decay ** self._stale[(svc, tier)]
        q = 1.0 + w * (min(max(lat.theta[0], lo_q), hi_q) - 1.0)
        b = w * min(max(lat.theta[1], lo_b), hi_b)
        d = w * min(max(drop.theta, lo_d), hi_d)
        return ServiceCorrection(
            q_mult=q if abs(q - 1.0) > self.q_mult_deadband else 1.0,
            lat_bias_s=b if abs(b) > self.lat_bias_deadband_s else 0.0,
            drop_offset=d if d > self.drop_deadband else 0.0)

    def correction(self, svc: str) -> ServiceCalibration:
        return ServiceCalibration(
            edge=self._tier_correction(svc, "edge"),
            dc=self._tier_correction(svc, "dc"))

    def corrections(self) -> Dict[str, ServiceCalibration]:
        """Current clamped per-service, per-tier corrections (identity
        until the first observation of that tier lands)."""
        return {s: self.correction(s) for s in self.services}
