"""Per-service SLO + operator-cost profiles (single source of truth).

A :class:`ServiceProfile` is what every co-simulation layer reads to
cost one fire of a service: the Fig. 3 SLO value curves, the operator
work per window value (``flops_per_record``), and the working-set bytes.
Profiles can be *declared* (scenario authors pick the numbers) or
*calibrated* from dry-runs of the port's CUDA kernels
(:mod:`repro_torch.scenario.calibrate`) — ``operator`` names which kernel
family models the service's OperatorLogic.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.value import TaskValueSpec, ValueCurve


@dataclasses.dataclass(frozen=True)
class ServiceSLO:
    """Fig. 3 value curves for one service's fires: full value while the
    end-to-end latency (energy) stays under the soft threshold, decaying
    to zero at the hard threshold."""
    soft_latency_s: float
    hard_latency_s: float
    soft_energy_j: float = 50.0
    hard_energy_j: float = 500.0
    gamma: float = 1.0
    w_p: float = 0.7
    shape: str = "linear"

    def value_spec(self, shift_s: float = 0.0) -> TaskValueSpec:
        """SLO as Eq. 1 parameters; `shift_s` moves the latency curve
        left by the delay already accumulated before DC execution starts,
        so a DC task's (finish − arrival) is scored on the *end-to-end*
        deadline. The shifted soft threshold may go negative: a task
        whose upstream+transfer delay already exceeded the soft deadline
        starts *inside* the decay ramp (clamping it to ~0 would re-spread
        the whole decay over the remaining budget and over-credit slow
        offloads)."""
        soft = self.soft_latency_s - shift_s
        hard = max(self.hard_latency_s - shift_s, soft)
        return TaskValueSpec(
            gamma=self.gamma, w_p=self.w_p, w_e=1.0 - self.w_p,
            perf_curve=ValueCurve(1.0, 0.1, soft, hard, self.shape),
            energy_curve=ValueCurve(1.0, 0.1, self.soft_energy_j,
                                    self.hard_energy_j, self.shape))

    @property
    def max_value(self) -> float:
        return self.gamma * 1.0  # w_p·v_max + w_e·v_max with v_max = 1


@dataclasses.dataclass(frozen=True)
class ServiceProfile:
    """What one fire of this service costs, plus its SLO. ``operator``
    names the kernel family whose dry-run can calibrate
    ``flops_per_record`` (see :mod:`repro_torch.scenario.calibrate`)."""
    slo: ServiceSLO
    flops_per_record: float = 1e3    # operator work per window value
    bytes_per_record: float = 8.0    # working-set bytes per window value
    operator: str = "window_agg"     # window_agg | ssd_scan | flash_attention
