"""Batched fluid-approximation scenario engine, carried from the JAX
package's ``fluid``; the time-stepper is torch, on the CUDA card unless
the caller passes ``device="cpu"``.

The exact DES scores one (plan, drift-trace) pair per Python event
loop; this package lowers a compiled scenario to padded dense arrays
and evaluates *ensembles* — N drift realizations × M plan candidates —
in one batched time loop, returning per-(realization, plan)
VoS / latency / drop trajectories. On top of it sit distributionally
robust risk metrics (mean / CVaR / worst-quantile VoS) used by
``repro_torch.placement.search.robust_search`` and
``OnlineController(risk=...)``.

The DES remains ground truth: the fluid tier ranks, the DES re-scores
survivors (the same two-tier contract the numpy screen established).
"""
from repro_torch.fluid.engine import FluidEngine, FluidResult
from repro_torch.fluid.ensemble import ScenarioEnsemble, sample_specs
from repro_torch.fluid.robust import (RiskSpec, calibration_prior, ensemble_spread,
                                rank_plans, risk_score)

__all__ = [
    "FluidEngine", "FluidResult", "ScenarioEnsemble", "sample_specs",
    "RiskSpec", "risk_score", "rank_plans", "ensemble_spread",
    "calibration_prior",
]
