"""Hierarchical fleets, carried from the JAX package's ``region``:

  hier.py      RegionSpec / HierFleetSpec — edge sites → regional
               aggregation points (RAPs) → DC core, per-tier FIFO
               contention; a flat FleetSpec is the degenerate
               one-region hierarchy with a transparent RAP

The fleet generator and the decomposed region search are not ported yet.
"""
from repro_torch.region.hier import (DEFAULT_RAP, HierFleetSpec, RegionSpec,
                                     TRANSPARENT_RAP, regions_view)
