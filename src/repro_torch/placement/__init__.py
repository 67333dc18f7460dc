"""Edge↔DC placement model of the port, carried from the JAX package's
``placement``: edge devices, the edge↔DC network and per-service
placement plans over a pipeline DAG. Co-simulation itself lives in the
unified Scenario API (``repro_torch.scenario``).

  edge.py     EdgeNode — gateway-class device, serial fire execution
  network.py  NetworkModel — uplink/downlink transfer time + energy
  plan.py     PlacementPlan — per-service edge|dc + VDC chips/DVFS hints

The placement search, its parallel evaluator and the co-sim shim are
not ported yet.
"""
from repro_torch.placement.edge import EdgeNode, EdgeSpec, FireExec
from repro_torch.placement.network import LinkSpec, NetworkModel
from repro_torch.placement.plan import (PlacementPlan, ServicePlacement,
                                        SITE_DC, SITE_EDGE, enumerate_plans,
                                        service_options)
