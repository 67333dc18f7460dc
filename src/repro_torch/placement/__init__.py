"""Edge↔DC placement engine of the port, carried from the JAX package's
``placement``: edge devices, the edge↔DC network, per-service placement
plans over a pipeline DAG, and the search for VoS-optimal placements.
Co-simulation itself lives in the unified Scenario API
(``repro_torch.scenario``); the ``cosim`` module here is a deprecation
shim over it:

  edge.py      EdgeNode — gateway-class device, serial fire execution
  network.py   NetworkModel — uplink/downlink transfer time + energy
  plan.py      PlacementPlan — per-service edge|dc + VDC chips/DVFS hints
  cosim.py     DEPRECATED CoSimulator shim → repro_torch.scenario.engine
  search.py    exhaustive / screened / robust VoS-optimal placement search
  parallel.py  ParallelEvaluator — the exact tier over a forked pool

The co-sim, search and parallel names resolve lazily so the shim's
import of ``repro_torch.scenario`` cannot cycle back through this
package's eager imports.
"""
from repro_torch.placement.edge import EdgeNode, EdgeSpec, FireExec
from repro_torch.placement.network import LinkSpec, NetworkModel
from repro_torch.placement.plan import (PlacementPlan, ServicePlacement,
                                        SITE_DC, SITE_EDGE, enumerate_plans,
                                        service_options)

_COSIM_NAMES = ("CoSimConfig", "CoSimResult", "CoSimulator",
                "RecordLedger", "ServiceLedger", "ServiceProfile",
                "ServiceSLO", "analytics_cost_model")
_SEARCH_NAMES = ("Evaluator", "SearchResult", "exhaustive_search",
                 "greedy_search", "robust_search", "screened_search",
                 "search_placement")
_PARALLEL_NAMES = ("ParallelEvaluator", "default_workers")

__all__ = ["EdgeNode", "EdgeSpec", "FireExec", "LinkSpec", "NetworkModel",
           "PlacementPlan", "ServicePlacement", "SITE_DC", "SITE_EDGE",
           "enumerate_plans", "service_options",
           *_COSIM_NAMES, *_SEARCH_NAMES, *_PARALLEL_NAMES]


def __getattr__(name):
    if name in _COSIM_NAMES:
        from repro_torch.placement import cosim
        return getattr(cosim, name)
    if name in _SEARCH_NAMES:
        from repro_torch.placement import search
        return getattr(search, name)
    if name in _PARALLEL_NAMES:
        from repro_torch.placement import parallel
        return getattr(parallel, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
