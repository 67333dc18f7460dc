"""Hierarchical fleets, carried from the JAX package's ``region``:
regions, RAP trunks, synthetic fleet generation and decomposed placement
search.

  hier.py      RegionSpec / HierFleetSpec — edge sites → regional
               aggregation points (RAPs) → DC core, per-tier FIFO
               contention; a flat FleetSpec is the degenerate
               one-region hierarchy with a transparent RAP
  generate.py  FleetGenSpec / generate_fleet — seeded synthetic
               O(100–1000)-site heterogeneous fleets with per-region
               drift phases and pipeline chains
  search.py    partition_services / region_search — decompose the
               placement search by origin region: per-region screened
               candidate generation, global cross-region coordination,
               exact DES on the finalists; region_search_exact is the
               analytic twin the warm-started online controller runs
               each epoch

Only ``hier`` is imported eagerly; the generator and search resolve
lazily so importing ``repro_torch.region`` from
``repro_torch.scenario.spec`` cannot cycle back through the
scenario/placement packages.
"""
from repro_torch.region.hier import (DEFAULT_RAP, HierFleetSpec, RegionSpec,
                                     TRANSPARENT_RAP, regions_view)

_GENERATE_NAMES = ("FleetGenSpec", "generate_fleet", "hier_fleet_spec")
_SEARCH_NAMES = ("RegionPartition", "partition_services", "region_search",
                 "region_search_exact")

__all__ = ["RegionSpec", "HierFleetSpec", "TRANSPARENT_RAP", "DEFAULT_RAP",
           "regions_view", *_GENERATE_NAMES, *_SEARCH_NAMES]


def __getattr__(name):
    if name in _GENERATE_NAMES:
        from repro_torch.region import generate
        return getattr(generate, name)
    if name in _SEARCH_NAMES:
        from repro_torch.region import search
        return getattr(search, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
