"""Distributionally robust plan ranking over a fluid ensemble.

Given ``vos[n, m]`` (N drift realizations × M plans) from
:class:`repro_torch.fluid.engine.FluidEngine`, a :class:`RiskSpec` collapses
the realization axis into one score per plan:

=============  =====================================================
``mean``       risk-neutral expectation (what single-trace search
               implicitly optimizes when the trace is the mean drift)
``cvar``       mean of the worst ``alpha`` fraction of realizations
               (Conditional Value-at-Risk; the default robust metric)
``quantile``   the ``alpha``-quantile (Value-at-Risk)
``worst``      min over realizations (most conservative)
=============  =====================================================

CVaR ranking disagrees with mean ranking exactly when a plan's *tail*
collapses (burst saturation, outage exposure) while its typical case
looks fine — that disagreement is the point of evaluating ensembles.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class RiskSpec:
    """A risk metric over the realization axis. ``alpha`` is the tail
    fraction (cvar) or quantile level (quantile); ignored by mean and
    worst."""
    metric: str = "cvar"    # mean | cvar | quantile | worst
    alpha: float = 0.2

    @classmethod
    def mean(cls) -> "RiskSpec":
        return cls(metric="mean")

    @classmethod
    def cvar(cls, alpha: float = 0.2) -> "RiskSpec":
        return cls(metric="cvar", alpha=alpha)

    @classmethod
    def quantile(cls, alpha: float = 0.1) -> "RiskSpec":
        return cls(metric="quantile", alpha=alpha)

    @classmethod
    def worst(cls) -> "RiskSpec":
        return cls(metric="worst")

    @classmethod
    def of(cls, spec) -> "RiskSpec":
        """Coerce ``None`` / a metric name / a RiskSpec into a RiskSpec
        (``None`` → mean, matching single-trace behaviour)."""
        if spec is None:
            return cls.mean()
        if isinstance(spec, cls):
            return spec
        return cls(metric=str(spec))

    @property
    def label(self) -> str:
        if self.metric in ("mean", "worst"):
            return self.metric
        return f"{self.metric}[{self.alpha:g}]"

    def score(self, vos: np.ndarray, axis: int = 0) -> np.ndarray:
        """Collapse the realization axis of ``vos`` into risk scores.
        ``-inf`` (infeasible) propagates through every metric."""
        v = np.asarray(vos, dtype=float)
        if self.metric == "mean":
            return v.mean(axis=axis)
        if self.metric == "worst":
            return v.min(axis=axis)
        if self.metric == "quantile":
            return np.quantile(v, self.alpha, axis=axis)
        if self.metric == "cvar":
            n = v.shape[axis]
            k = max(1, int(math.ceil(self.alpha * n)))
            worst_k = np.sort(v, axis=axis)
            worst_k = np.take(worst_k, range(k), axis=axis)
            return worst_k.mean(axis=axis)
        raise ValueError(f"unknown risk metric {self.metric!r}")


def risk_score(vos: np.ndarray, risk=None) -> np.ndarray:
    """Per-plan risk scores for an ``[N, M]`` ensemble VoS matrix."""
    return RiskSpec.of(risk).score(vos, axis=0)


def rank_plans(vos: np.ndarray, risk=None) -> np.ndarray:
    """Plan indices sorted best-first by the risk metric (stable, so
    ties keep candidate order — deterministic)."""
    scores = risk_score(vos, risk)
    return np.argsort(-scores, kind="stable")


def ensemble_spread(result, plan_index: int) -> Dict[str, float]:
    """Per-service *relative* VoS spread (std / max attainable) across
    realizations for one plan — the predictive-uncertainty signal."""
    v = result.vos_service[:, plan_index, :]    # [N, S]
    out: Dict[str, float] = {}
    for si, s in enumerate(result.order):
        scale = max(1e-9, float(np.abs(v[:, si]).max()))
        out[s] = float(v[:, si].std() / scale)
    return out


def calibration_prior(result, plan_index: int,
                      plan=None) -> Dict[str, Dict[str, float]]:
    """Ensemble spread shaped as a per-service per-tier uncertainty
    prior for ``CalibrationLoop.set_variance_prior``: services whose
    predicted VoS varies a lot across drift realizations should be
    corrected *faster* (larger RLS prior covariance). When ``plan`` is
    given only the tier the plan actually uses carries the measured
    spread; the unused tier keeps a neutral 0."""
    spread = ensemble_spread(result, plan_index)
    out: Dict[str, Dict[str, float]] = {}
    for s, rel in spread.items():
        if plan is None:
            out[s] = {"edge": rel, "dc": rel}
        else:
            is_edge = plan.placement(s).is_edge
            out[s] = {"edge": rel if is_edge else 0.0,
                      "dc": 0.0 if is_edge else rel}
    return out
