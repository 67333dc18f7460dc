"""TPU v5e hardware model: roofline constants, pod geometry, DVFS/power model.

These constants parameterize (a) the roofline analysis of compiled dry-run
artifacts and (b) the JITA-4DS cost model (core/costmodel.py) that the VoS
scheduler uses to predict execution time and energy per VDC configuration.

All values are per-chip unless noted. Sources: public TPU v5e specs.
They describe the simulated TPU-v5e pod that the DES prices, not the CUDA
card the port runs on, so the port's VoS equals the JAX package's.
"""
from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Per-chip roofline constants (TPU v5e)
# ---------------------------------------------------------------------------
PEAK_FLOPS_BF16 = 197e12       # FLOP/s, bf16 MXU peak
PEAK_FLOPS_INT8 = 394e12       # FLOP/s, int8
HBM_BW = 819e9                 # bytes/s
HBM_BYTES = 16 * 2**30         # 16 GiB HBM per chip
ICI_LINK_BW = 50e9             # bytes/s per ICI link (one direction)
ICI_LINKS_PER_CHIP = 4         # 2D torus on v5e: 4 links/chip
DCN_BW_PER_HOST = 25e9         # bytes/s inter-pod (data-center network)
VMEM_BYTES = 128 * 2**20       # ~128 MiB VMEM per chip (v5e class)

# Power model (modeled; the container has no power registers — see DESIGN §8)
CHIP_TDP_W = 200.0             # watts, per-chip board power at f=1.0
CHIP_STATIC_W = 60.0           # static/leakage floor, independent of DVFS
HOST_POWER_W = 350.0           # per-host (CPU, NIC, fans), amortized

# Pod geometry
POD_X, POD_Y = 16, 16
CHIPS_PER_POD = POD_X * POD_Y
CHIPS_PER_HOST = 4             # v5e: 4 chips per host VM


@dataclasses.dataclass(frozen=True)
class DVFSState:
    """A modeled DVFS operating point.

    ``f`` scales MXU/VPU clock: compute time ∝ 1/f. Dynamic power scales
    cubically with frequency (classic DVFS model); HBM/ICI are unscaled.
    This replaces the paper's RAPL power capping (DESIGN §2, §8).
    """
    f: float  # frequency factor in (0, 1]

    @property
    def power_w(self) -> float:
        dynamic = (CHIP_TDP_W - CHIP_STATIC_W) * self.f ** 3
        return CHIP_STATIC_W + dynamic

    def compute_scale(self) -> float:
        return 1.0 / self.f


# Discrete DVFS ladder available to the scheduler (JSPC picks per job,
# CPC picks one for the whole pod).
DVFS_LADDER = tuple(DVFSState(f) for f in (1.0, 0.9, 0.8, 0.7, 0.6, 0.5))
DVFS_NOMINAL = DVFS_LADDER[0]


def pod_power_cap_w(fraction: float, chips: int = CHIPS_PER_POD) -> float:
    """System power cap as a fraction of the all-chips-nominal envelope."""
    hosts = chips // CHIPS_PER_HOST
    envelope = chips * CHIP_TDP_W + hosts * HOST_POWER_W
    return fraction * envelope


def bisection_bandwidth(chips: int) -> float:
    """Approx bisection bandwidth (bytes/s) of a 2D-torus slice of `chips`."""
    # square-ish slice: side = sqrt(chips); 2 * side wraparound links per cut
    side = max(1, int(chips ** 0.5))
    return 2 * side * ICI_LINK_BW
