"""Value-of-Service: the paper's Fig. 3 curves and Eq. 1-2.

A task earns maximum value v_max while the objective (completion time or
energy) is below a soft threshold, decays to v_min at the hard threshold
(linearly by default; the paper notes other shapes are admissible — an
exponential option is provided and exercised in an ablation), and earns
zero beyond it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable


@dataclasses.dataclass(frozen=True)
class ValueCurve:
    v_max: float
    v_min: float
    th_soft: float
    th_hard: float
    shape: str = "linear"  # linear | exponential

    def __post_init__(self):
        if self.th_hard < self.th_soft:
            raise ValueError("hard threshold must be >= soft threshold")
        if self.v_min > self.v_max:
            raise ValueError("v_min must be <= v_max")

    def value(self, x: float) -> float:
        if x <= self.th_soft:
            return self.v_max
        if x > self.th_hard:
            return 0.0
        if self.th_hard == self.th_soft:
            return self.v_min
        frac = (x - self.th_soft) / (self.th_hard - self.th_soft)
        if self.shape == "exponential":
            # decays by e-folds towards v_min
            return self.v_min + (self.v_max - self.v_min) * math.exp(-3 * frac)
        return self.v_max - frac * (self.v_max - self.v_min)

    def value_array(self, x):
        """Vectorized :meth:`value` over a numpy array (same piecewise
        shape, kept next to the scalar so the curves cannot drift —
        the tier-1 plan screen evaluates these over whole fire/plan
        matrices)."""
        import numpy as np
        out = np.zeros(x.shape)
        out[x <= self.th_soft] = self.v_max
        mid = (x > self.th_soft) & (x <= self.th_hard)
        if self.th_hard > self.th_soft:
            frac = (x[mid] - self.th_soft) / (self.th_hard - self.th_soft)
            if self.shape == "exponential":
                out[mid] = (self.v_min
                            + (self.v_max - self.v_min) * np.exp(-3 * frac))
            else:
                out[mid] = self.v_max - frac * (self.v_max - self.v_min)
        else:
            out[mid] = self.v_min
        return out


@dataclasses.dataclass(frozen=True)
class TaskValueSpec:
    """Eq. 1 parameters: γ importance, objective weights, per-objective curves."""
    gamma: float
    w_p: float
    w_e: float
    perf_curve: ValueCurve      # objective: completion latency (s)
    energy_curve: ValueCurve    # objective: energy consumed (J)


def task_value(spec: TaskValueSpec, completion_latency: float,
               energy_j: float) -> float:
    """V(Task_j, t) = γ_j (w_p v_p + w_e v_e); zero if either component is
    zero (paper: 'If either the performance function or energy function is
    0, then the VoS is 0')."""
    v_p = spec.perf_curve.value(completion_latency)
    v_e = spec.energy_curve.value(energy_j)
    if v_p == 0.0 or v_e == 0.0:
        return 0.0
    return spec.gamma * (spec.w_p * v_p + spec.w_e * v_e)


def vos_total(values: Iterable[float]) -> float:
    """Eq. 2: VoS(t) = Σ_j V(Task_j, t)."""
    return float(sum(values))
