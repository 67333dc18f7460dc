"""Hierarchical fleet topology: edge sites → regional aggregation
points (RAPs) → DC core.

A flat :class:`~repro_torch.online.fleet.FleetSpec` models one shared WAN
uplink for the whole fleet — fine for a handful of gateways, wrong at
planet scale where hundreds of sites hang off *regional* aggregation
points and only the RAP trunks converge on the DC core. A
:class:`HierFleetSpec` partitions the sites into :class:`RegionSpec`s:
each region gets its own contended edge-tier pipe (the per-region twin
of the flat uplink) and a RAP trunk link whose RAP→DC direction is a
second FIFO tier. Same-region traffic turns around at the RAP; only
cross-region and edge→DC traffic transits the trunks.

Backward compatibility is *exact*: wrapping a flat fleet as a single
region with the :data:`TRANSPARENT_RAP` (infinite trunk bandwidth, zero
RTT, zero per-byte energy) routes every transfer bit-identically to the
flat fleet — the runtime (:class:`repro_torch.online.fleet.Fleet`) skips
transparent RAP legs entirely, and the one edge-tier pipe *is* the old
shared uplink. ``degenerate()`` builds that wrapper; the regression
suite pins the equivalence.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

from repro_torch.online.fleet import FleetSpec, SiteSpec, transparent_link
from repro_torch.placement.network import LinkSpec

#: The no-op RAP: a one-region hierarchy with this trunk is
#: bit-identical to the flat fleet (every RAP leg short-circuits).
TRANSPARENT_RAP = LinkSpec(uplink_bps=math.inf, downlink_bps=math.inf,
                           rtt_s=0.0, energy_per_byte_j=0.0)

#: A realistic metro-aggregation trunk: fat pipes (fiber backhaul), one
#: extra metro hop of latency. Generators default to scaled versions.
DEFAULT_RAP = LinkSpec(uplink_bps=2e9, downlink_bps=4e9, rtt_s=0.012,
                       energy_per_byte_j=4e-9)


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """One region: its member edge sites and the RAP trunk link that
    carries the region's traffic to/from the DC core. ``sites`` are
    names into the enclosing fleet's site list."""
    name: str
    sites: Tuple[str, ...]
    rap: LinkSpec = dataclasses.field(default_factory=lambda: DEFAULT_RAP)

    def __post_init__(self):
        if not self.name:
            raise ValueError("a region needs a name")
        if not self.sites:
            raise ValueError(f"region {self.name!r} has no sites")
        if len(set(self.sites)) != len(self.sites):
            raise ValueError(f"region {self.name!r}: duplicate sites")

    @property
    def transparent(self) -> bool:
        return transparent_link(self.rap)


@dataclasses.dataclass(frozen=True)
class HierFleetSpec(FleetSpec):
    """A fleet whose sites are partitioned into regions. With
    ``regions=()`` it degrades to a plain flat fleet; with regions the
    partition must be exact — every site in exactly one region."""
    regions: Tuple[RegionSpec, ...] = ()

    def __post_init__(self):
        super().__post_init__()
        if not self.regions:
            return
        names = [r.name for r in self.regions]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate region names: {names}")
        site_names = set(self.site_names)
        seen: Dict[str, str] = {}
        for r in self.regions:
            for s in r.sites:
                if s not in site_names:
                    raise ValueError(
                        f"region {r.name!r} claims unknown site {s!r}")
                if s in seen:
                    raise ValueError(
                        f"site {s!r} in both regions {seen[s]!r} "
                        f"and {r.name!r}")
                seen[s] = r.name
        missing = site_names - set(seen)
        if missing:
            raise ValueError(
                f"sites in no region: {sorted(missing)} — regions must "
                "partition the fleet exactly")

    # ------------------------------------------------------------- queries
    def region_of(self, site: str) -> str:
        """Region name of ``site`` (fleets built without regions place
        everything in an implicit region named after the fleet)."""
        return self.region_index()[site]

    def region_index(self) -> Mapping[str, str]:
        cached = getattr(self, "_region_index", None)
        if cached is None:
            cached = {s: r.name for r in self.regions for s in r.sites}
            object.__setattr__(self, "_region_index", cached)
        return cached

    def region(self, name: str) -> RegionSpec:
        for r in self.regions:
            if r.name == name:
                return r
        raise KeyError(name)

    @classmethod
    def degenerate(cls, flat: FleetSpec,
                   name: str = "global") -> "HierFleetSpec":
        """Wrap a flat fleet as a one-region hierarchy with a
        transparent RAP — routes bit-identically to ``flat`` (the
        regression suite pins this)."""
        return cls(sites=flat.sites, user_site=flat.user_site,
                   regions=(RegionSpec(name, flat.site_names,
                                       rap=TRANSPARENT_RAP),))


def regions_view(fleet: FleetSpec) -> Tuple[RegionSpec, ...]:
    """The one-transparent-region reading of any fleet: hierarchical
    fleets return their declared regions, flat fleets one region over
    all sites with the transparent RAP. Every per-region consumer
    (screen, forecast, fluid) goes through this so the flat path is the
    degenerate case of the hierarchical one, not a separate branch."""
    declared = tuple(getattr(fleet, "regions", ()) or ())
    if declared:
        return declared
    return (RegionSpec("fleet", fleet.site_names, rap=TRANSPARENT_RAP),)
