"""Calibrate ``flops_per_record`` from dry-runs of the port's kernels.

Scenario profiles may *declare* per-service operator cost; this module
*measures* it: the service's operator (``window_agg``, ``ssd_scan`` or
``flash_attention``) is dry-run through its public entry point on the
calibrator's device — on the card that launches the CUDA kernel — at the
JAX package's canonical shapes, and
``torch.utils.flop_counter.FlopCounterMode`` counts its work, normalized
per ingested record. Each entry point is a custom op with its own FLOP
formula (``kernels/<name>/ops.py``), so the count is the function's work
whatever runs inside it, and it is the same on the CPU and on the card.
Each operator is dry-run in float32 and in bfloat16, the two types its
kernels take, since on the card each type has a kernel of its own: flash
attention runs wgmma in bf16 and 3xTF32 on the tensor cores in float32,
the SSD wgmma in bf16 and CUDA-core FMA in float32. The bf16 pass is kept
so that a calibration launches the kernels of both types, which
``chip_smoke.py``'s ``calibrate`` and ``scenario`` phases count on; the
language models' serving path (``repro_torch.models``) also launches the
bf16 kernels now, but a calibration does not run it. The FLOP formulas
depend only on shapes, so the bf16 pass cannot change the count, and the
float32 pass's count is the one kept.
That number feeds the roofline cost cells
(:func:`repro_torch.scenario.engine.analytics_cost_model`) the DC
simulator prices VDC steps with.

The JAX package reads XLA's cost analysis of its interpret-mode Pallas
programs instead, which costs one pass of the kernel's grid loop, so its
numbers are smaller than the port's by about the number of grid steps.

When the count is zero, a documented analytic fallback keeps calibration
deterministic; none of the three operators reaches it.

Usage::

    cal = KernelCalibrator()                   # on the card
    profiles, _ = calibrate_profiles(spec, cal)
    print(cal.report())                        # what was measured
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.window_agg.ops import window_aggregate
from repro_torch.scenario.profiles import ServiceProfile

# every dry-run runs once in each type the kernels take; the count is the
# first's
DRY_RUN_DTYPES = (torch.float32, torch.bfloat16)

_INTENSITY = {          # analytic flops/record fallbacks, by operator
    # one VPU op per element in the segment phase + m-way combine
    "window_agg": lambda m: 1.0 + 1.0 / 64.0 * m,
    # per timestep: state update (2·N·P) + readout (2·N·P) + decay
    "ssd_scan": lambda m: 4.0 * 16 * 64 + 16,
    # per query row: QK^T + PV at S=256, d=64 → 4·S·d
    "flash_attention": lambda m: 4.0 * 256 * 64,
}


@dataclasses.dataclass(frozen=True)
class Calibration:
    """One measured operator cost."""
    operator: str
    agg: str
    m: int                      # window/stride ratio the shape encoded
    n_records: int              # records the dry-run ingested
    flops_total: float
    flops_per_record: float
    source: str                 # "flop-counter" | "analytic"


def window_ratio(svc) -> int:
    """The window/stride ratio m that a service's dry-run encodes: its
    width over its slide, rounded, within [1, 8]."""
    return max(1, min(8, round(svc.width_s / max(svc.slide_s, 1e-9))))


class KernelCalibrator:
    """Measures (and caches) flops_per_record per operator family.

    Callable with a service spec (anything with ``operator``, ``agg``,
    ``width_s`` and ``slide_s``), so it can be handed to whatever compiles
    services into profiles. The dry-runs run on ``device``: the card
    unless the caller passes ``device="cpu"``, once in each of
    ``DRY_RUN_DTYPES``. A kernel that cannot run the shape raises."""

    def __init__(self, stride: int = 64, device: DeviceLike = None):
        self.stride = stride
        self.device = resolve_device(device)
        self._cache: Dict[Tuple[str, str, int], Calibration] = {}
        self.log: List[Calibration] = []

    # ------------------------------------------------------------ frontends
    def __call__(self, svc) -> float:
        return self.measure(svc.operator, agg=svc.agg,
                            m=window_ratio(svc)).flops_per_record

    def measure(self, operator: str, agg: str = "max",
                m: int = 2) -> Calibration:
        agg = {"count": "sum"}.get(agg, agg)
        if operator not in _INTENSITY:
            raise ValueError(f"unknown operator {operator!r} "
                             f"(known: {sorted(_INTENSITY)})")
        key = (operator, agg if operator == "window_agg" else "-", m)
        if key not in self._cache:
            cal = self._measure(operator, agg, m)
            self._cache[key] = cal
            self.log.append(cal)
        return self._cache[key]

    def report(self) -> List[Dict]:
        return [dataclasses.asdict(c) for c in self.log]

    # ------------------------------------------------------------ dry-runs
    def _measure(self, operator: str, agg: str, m: int) -> Calibration:
        fn = getattr(self, f"_dry_{operator}")
        counts = []
        for dtype in DRY_RUN_DTYPES:
            with FlopCounterMode(display=False) as counter:
                n_records = fn(agg, m, dtype)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)   # a fault raises here
            counts.append(counter.get_total_flops())
        flops = counts[0]
        if not flops:
            fpr = _INTENSITY[operator](m)
            return Calibration(operator, agg, m, n_records,
                               flops_total=fpr * n_records,
                               flops_per_record=fpr, source="analytic")
        return Calibration(operator, agg, m, n_records,
                           flops_total=float(flops),
                           flops_per_record=flops / n_records,
                           source="flop-counter")

    def _ones(self, *shape, dtype=torch.float32) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype, device=self.device)

    def window_shape(self, m: int) -> Tuple[int, int, int]:
        """``(T, window, stride)`` of the window_agg dry-run for ratio m:
        four windows of m strides, over [T, 1]."""
        return 4 * m * self.stride, m * self.stride, self.stride

    def _dry_window_agg(self, agg: str, m: int, dtype: torch.dtype) -> int:
        T, window, stride = self.window_shape(m)
        window_aggregate(self._ones(T, 1, dtype=dtype), agg=agg,
                         window=window, stride=stride)
        return T

    def _dry_ssd_scan(self, agg: str, m: int, dtype: torch.dtype) -> int:
        B, L, H, P, G, N = 1, 128, 2, 64, 1, 16
        ssd_scan(self._ones(B, L, H, P, dtype=dtype),     # dt and A stay f32
                 self._ones(B, L, H) * 0.1, -self._ones(H),
                 self._ones(B, L, G, N, dtype=dtype),
                 self._ones(B, L, G, N, dtype=dtype), chunk=64)
        return B * L

    def _dry_flash_attention(self, agg: str, m: int,
                             dtype: torch.dtype) -> int:
        B, S, H, d = 1, 256, 2, 64
        q = self._ones(B, S, H, d, dtype=dtype)
        k = self._ones(B, S, H, d, dtype=dtype)
        flash_attention(q, k, k)
        return B * S


def calibrate_profiles(spec, calibrator: Optional[KernelCalibrator] = None):
    """Measured :class:`ServiceProfile`s for every service of ``spec``
    (declared flops are ignored; SLO/bytes kept). Returns
    ``(profiles, calibrator)`` so callers can read the report."""
    cal = calibrator or KernelCalibrator()
    profiles = {
        s.name: ServiceProfile(slo=s.slo, flops_per_record=cal(s),
                               bytes_per_record=s.bytes_per_record,
                               operator=s.operator)
        for s in spec.services}
    return profiles, cal
