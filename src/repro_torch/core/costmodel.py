"""Per-task execution-time & energy models for the VoS scheduler.

The paper predicts task time/energy per resource configuration with offline
regression models ([10-12]); here the predictor is the three-term roofline
derived from the compiled dry-run of the very binaries being scheduled
(EXPERIMENTS.md §Roofline). DVFS scales the compute term by 1/f and dynamic
power by f³ (DESIGN §2).

Scaling model from the 256-chip reference to an n-chip VDC:
  compute, memory ∝ 256/n   (batch/model dims re-shard onto fewer chips)
  collective      ≈ const   (per-device ring traffic; slightly ↓ with n)
plus a fixed efficiency factor for small slices.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, Optional, Tuple

from repro_torch import hardware as hw
from repro_torch.configs import SHAPES, get_arch


@dataclasses.dataclass(frozen=True)
class CellCost:
    t_compute: float
    t_memory: float
    t_collective: float
    hbm_bytes: float

    def step_time(self, chips: int, dvfs_f: float = 1.0,
                  ref_chips: int = 256) -> float:
        s = ref_chips / max(1, chips)
        tc = self.t_compute * s / dvfs_f
        tm = self.t_memory * s
        tx = self.t_collective
        return max(tc, tm, tx)


class CostModel:
    """Cost cells are immutable, so the per-config queries are pure —
    they are memoized per (arch, shape, chips, f) because the DES hot
    loop (heuristic assignment + drop scans) issues the same handful of
    lookups millions of times per co-simulation."""

    def __init__(self, cells: Dict[Tuple[str, str], CellCost]):
        self.cells = cells
        self._time_cache: Dict[Tuple[str, str, int, float], float] = {}
        self._power_cache: Dict[Tuple[int, float], float] = {}

    # ------------------------------------------------------------------ build
    @classmethod
    def from_reports(cls, report_dir: str) -> "CostModel":
        cells = {}
        for fn in glob.glob(os.path.join(report_dir, "*__16x16.json")):
            with open(fn) as f:
                d = json.load(f)
            if "t_compute" not in d:
                continue
            cells[(d["arch"], d["shape"])] = CellCost(
                d["t_compute"], d["t_memory"], d["t_collective"],
                d["arg_bytes"] * 256.0)
        return cls(cells)

    @classmethod
    def analytic(cls, archs=None, shapes=None) -> "CostModel":
        """Fallback: roofline terms from parameter counts (tests / before a
        dry-run has been recorded)."""
        from repro_torch.roofline import model_flops
        cells = {}
        archs = archs or [a for a in _default_archs()]
        shapes = shapes or list(SHAPES)
        for a in archs:
            cfg = get_arch(a)
            counts = cfg.param_counts()
            for s in shapes:
                shape = SHAPES[s]
                mf = model_flops(cfg, shape)
                chips = 256
                t_c = mf / (chips * hw.PEAK_FLOPS_BF16) / 0.5  # 50% MXU eff
                wbytes = counts["total"] * (12 if shape.kind == "train" else 2)
                reads = 3 if shape.kind == "train" else 1
                t_m = reads * wbytes / (chips * hw.HBM_BW)
                t_x = 0.2 * t_c + wbytes / chips / hw.ICI_LINK_BW * 0.05
                cells[(a, s)] = CellCost(t_c, t_m, t_x, wbytes)
        return cls(cells)

    # ------------------------------------------------------------------ query
    def _cell(self, arch: str, shape: str) -> CellCost:
        key = (arch, shape)
        if key not in self.cells:
            raise KeyError(f"no cost cell for {key}")
        return self.cells[key]

    def has(self, arch: str, shape: str) -> bool:
        return (arch, shape) in self.cells

    def time_per_step(self, arch: str, shape: str, chips: int,
                      dvfs_f: float = 1.0) -> float:
        key = (arch, shape, chips, dvfs_f)
        t = self._time_cache.get(key)
        if t is None:
            t = self._cell(arch, shape).step_time(chips, dvfs_f)
            self._time_cache[key] = t
        return t

    def power_w(self, chips: int, dvfs_f: float = 1.0) -> float:
        key = (chips, dvfs_f)
        p = self._power_cache.get(key)
        if p is None:
            per_chip = (hw.CHIP_STATIC_W
                        + (hw.CHIP_TDP_W - hw.CHIP_STATIC_W) * dvfs_f ** 3)
            hosts = max(1, chips // hw.CHIPS_PER_HOST)
            p = chips * per_chip + hosts * hw.HOST_POWER_W
            self._power_cache[key] = p
        return p

    def energy_per_step(self, arch: str, shape: str, chips: int,
                        dvfs_f: float = 1.0) -> float:
        t = self.time_per_step(arch, shape, chips, dvfs_f)
        return t * self.power_w(chips, dvfs_f)

    def hbm_bytes(self, arch: str, shape: str) -> float:
        return self._cell(arch, shape).hbm_bytes

    def min_chips(self, arch: str, shape: str) -> int:
        """Smallest power-of-two slice whose HBM fits the working set."""
        need = self.hbm_bytes(arch, shape)
        chips = 4
        while chips < 256 and chips * hw.HBM_BYTES < need:
            chips *= 2
        return chips


def _default_archs():
    from repro_torch.configs import list_archs
    return list_archs()
