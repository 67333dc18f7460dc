"""Seeded synthetic hierarchical fleets: O(100–1000) heterogeneous
edge sites grouped into regions, each with its own pipeline chain,
drift phase and RAP trunk.

``generate_fleet`` is deterministic per :class:`FleetGenSpec` — the
same spec always yields the same :class:`~repro_torch.scenario.spec
.ScenarioSpec`, field for field (the property suite pins this), so
benchmark scenarios at planet scale stay reproducible data rather than
hand-written builders.

The workload shape keeps the *DES* tractable while the *fleet* scales:
fires scale with services (``n_regions × services_per_region``), not
with sites, so a 500-site scenario co-simulates in seconds — the
placement *search space* is what explodes with sites, which is exactly
what the decomposed ``region_search`` exists to handle.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Tuple

from repro_torch.placement.edge import EdgeSpec
from repro_torch.placement.network import LinkSpec
from repro_torch.region.hier import HierFleetSpec, RegionSpec
from repro_torch.online.fleet import SiteSpec
from repro_torch.scenario.spec import (FarmSpec, RateSpec, ScenarioSpec,
                                       ServiceSpec)
from repro_torch.scenario.profiles import ServiceSLO


@dataclasses.dataclass(frozen=True)
class FleetGenSpec:
    """Knobs of the synthetic fleet generator. Everything downstream of
    ``seed`` is deterministic."""
    name: str = "hier-fleet"
    n_sites: int = 500
    n_regions: int = 8
    services_per_region: int = 3     # chain length: agg → trend → post…
    seed: int = 0
    horizon_s: float = 3600.0
    epoch_s: Optional[float] = None  # None → one static epoch
    base_rate_hz: float = 5.0
    drift: str = "diurnal"           # constant | diurnal | bursts
    outage_regions: int = 0          # first K regions lose their farm site
    rap_uplink_bps: float = 1.5e9
    rap_rtt_s: float = 0.012
    things_per_farm: int = 8

    def __post_init__(self):
        if self.n_regions < 1:
            raise ValueError("n_regions must be >= 1")
        if self.n_sites < self.n_regions:
            raise ValueError("need at least one site per region")
        if self.services_per_region < 1:
            raise ValueError("services_per_region must be >= 1")
        if self.drift not in ("constant", "diurnal", "bursts"):
            raise ValueError(f"unknown drift kind {self.drift!r}")
        if not 0 <= self.outage_regions <= self.n_regions:
            raise ValueError("outage_regions out of range")


def _site(rng: random.Random, name: str) -> SiteSpec:
    """One heterogeneous gateway: ingest-bound box (slow record pump,
    frugal active power) on a thin last-mile link with compact
    delta-coded records — the regime where the edge/DC optimum actually
    flips with the record rate instead of one side winning outright."""
    box = 2.0 ** rng.uniform(-1.0, 1.0)       # box class: ¼×–4× spread
    edge = EdgeSpec(
        name=name,
        throughput_rps=2000.0 * box,
        flops_per_s=20e9 * box,
        ram_bytes=float(rng.choice((128, 256, 512, 1024)) * 2 ** 20),
        energy_per_record_j=50e-6 * 2.0 ** rng.uniform(-0.5, 0.5),
        active_power_w=1.0 * 2.0 ** rng.uniform(-0.5, 0.5))
    link = LinkSpec(
        uplink_bps=15e3 * 2.0 ** rng.uniform(-1.0, 1.0),
        downlink_bps=2e6 * 2.0 ** rng.uniform(-1.0, 1.0),
        rtt_s=rng.uniform(0.030, 0.080),
        record_bytes=64.0, compression=0.25)
    return SiteSpec(name=name, edge=edge, link=link)


def _rate(gen: FleetGenSpec, rng: random.Random, region: int) -> RateSpec:
    """Region-phase-shifted drift so regions peak at different times —
    what makes per-region re-placement decisions diverge."""
    base = gen.base_rate_hz * 2.0 ** rng.uniform(-0.5, 0.5)
    if gen.drift == "constant":
        return RateSpec.constant(base)
    if gen.drift == "diurnal":
        # ~9× swing: troughs sit below the edge/DC flip point, peaks
        # above it, so the per-region optimum genuinely moves per epoch
        return RateSpec.diurnal(
            base, amplitude=0.8,
            period_s=gen.horizon_s,
            phase_s=region * gen.horizon_s / max(1, gen.n_regions))
    # bursts: staggered per-region surge windows
    t0 = (0.15 + 0.6 * region / max(1, gen.n_regions)) * gen.horizon_s
    return RateSpec.bursts(base, burst_hz=base * 4.0,
                           windows=[(t0, t0 + 0.15 * gen.horizon_s)])


def generate_fleet(gen: FleetGenSpec) -> ScenarioSpec:
    """Spec → scenario: ``n_sites`` heterogeneous gateways partitioned
    into ``n_regions`` regions (each with a RAP trunk), one pipeline
    chain per region rooted at a farm pinned inside the region."""
    rng = random.Random(gen.seed * 9_176_003 + 17)

    # -------------------------------------------------------------- sites
    counts = [gen.n_sites // gen.n_regions
              + (1 if r < gen.n_sites % gen.n_regions else 0)
              for r in range(gen.n_regions)]
    sites: List[SiteSpec] = []
    regions: List[RegionSpec] = []
    region_sites: List[List[str]] = []
    for r in range(gen.n_regions):
        names = [f"r{r:02d}-s{i:03d}" for i in range(counts[r])]
        region_sites.append(names)
        for n in names:
            sites.append(_site(rng, n))
        rap = LinkSpec(
            uplink_bps=gen.rap_uplink_bps * 2.0 ** rng.uniform(-0.5, 0.5),
            downlink_bps=2.0 * gen.rap_uplink_bps
            * 2.0 ** rng.uniform(-0.5, 0.5),
            rtt_s=gen.rap_rtt_s * 2.0 ** rng.uniform(-0.3, 0.3),
            energy_per_byte_j=4e-9)
        regions.append(RegionSpec(name=f"region-{r:02d}",
                                  sites=tuple(names), rap=rap))

    # ----------------------------------------------------- farms, services
    farms: List[FarmSpec] = []
    services: List[ServiceSpec] = []
    outages: List[Tuple[str, Tuple[Tuple[float, float], ...]]] = []
    farm_pin: List[Tuple[str, str]] = []    # (queue, site)
    for r in range(gen.n_regions):
        queue = f"r{r:02d}-q"
        farm_site = region_sites[r][rng.randrange(counts[r])]
        farm_pin.append((queue, farm_site))
        farms.append(FarmSpec(queue=queue, n_things=gen.things_per_farm,
                              seed=gen.seed * 101 + r,
                              rate=_rate(gen, rng, r)))
        # the region's services form a fan: a light windowing root and
        # the heavy analytics stages both read the *raw* farm queue
        # (that is where the record volume — hence the edge/DC placement
        # tension — lives); further light stages chain off the root's
        # republished aggregates. Per-region flops jitter means some
        # regions' heavy stage fits their beefier boxes while others
        # must offload — regional optima genuinely diverge.
        chain_q = queue
        for k in range(gen.services_per_region):
            name = f"r{r:02d}-svc{k}"
            heavy = (k % 2 == 1)
            if heavy:
                services.append(ServiceSpec(
                    name=name, queue=queue, column="latency_ms",
                    agg="mean", width_s=300.0, slide_s=60.0,
                    buffer_budget=16384,
                    slo=ServiceSLO(soft_latency_s=5.0, hard_latency_s=15.0,
                                   soft_energy_j=80.0, hard_energy_j=400.0,
                                   gamma=2.0),
                    flops_per_record=2e8 * 2.0 ** rng.uniform(-1.0, 1.0),
                    bytes_per_record=16.0))
            else:
                root = (chain_q == queue)
                out_q = (f"r{r:02d}-out{k}"
                         if k + 2 < gen.services_per_region else None)
                # the root windows raw records on a per-fire energy
                # budget spanning the VDC floor (~2.3 J for a 4-chip
                # tile): edge fires cost well under a joule at the rate
                # trough and blow the hard threshold at the peak, so
                # drift moves it across the edge/DC flip point each
                # epoch; chained stages fire rarely and stay loose
                services.append(ServiceSpec(
                    name=name, queue=chain_q,
                    column="download_speed" if root else "value",
                    agg="max" if root else "mean",
                    width_s=120.0 if root else 300.0,
                    slide_s=30.0 if root else 60.0,
                    buffer_budget=8192,
                    publishes_to=out_q,
                    slo=(ServiceSLO(soft_latency_s=2.0, hard_latency_s=10.0,
                                    soft_energy_j=0.3, hard_energy_j=3.0)
                         if root else
                         ServiceSLO(soft_latency_s=2.0, hard_latency_s=10.0,
                                    soft_energy_j=1.0, hard_energy_j=60.0)),
                    flops_per_record=2e3))
                chain_q = out_q if out_q else chain_q
        if r < gen.outage_regions:
            outages.append((farm_site,
                            ((0.45 * gen.horizon_s, 0.65 * gen.horizon_s),)))

    # pin each farm queue to its site
    pin = dict(farm_pin)
    sites = [dataclasses.replace(
        s, farm_queues=tuple(q for q, st in pin.items() if st == s.name))
        for s in sites]

    spec = ScenarioSpec(
        name=f"{gen.name}-{gen.n_sites}x{gen.n_regions}",
        services=tuple(services), farms=tuple(farms),
        sites=tuple(sites), user_site=region_sites[0][0],
        regions=tuple(regions),
        horizon_s=gen.horizon_s, epoch_s=gen.epoch_s,
        dc_step_floor_s=2e-3,
        # windowed aggregators migrate their accumulator state, not raw
        # record buffers — keeps epoch-scale re-placement affordable on
        # thin last-mile links
        state_bytes_per_record=1.0,
        outages=tuple(outages))
    spec.validate()
    return spec


def hier_fleet_spec(spec: ScenarioSpec) -> HierFleetSpec:
    """The fleet topology of a generated scenario (convenience for
    callers that want the :class:`HierFleetSpec` without compiling)."""
    return HierFleetSpec(sites=spec.sites, user_site=spec.user_site,
                         regions=spec.regions)
