"""Pipeline mash-up (paper §3): services compose by connecting Sinks to
Fetches, expressing a data flow. A Pipeline advances all producers, then
all services in topological order.

The data-flow edges are recorded so downstream tooling (e.g. the
edge↔DC placement engine, ``placement``) can recover the service
DAG: an edge (u, q) means service ``u``'s sink republishes into queue
``q``; the consumers of ``q`` are u's downstream services.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.pipeline.service import StreamService
from repro_torch.pipeline.streams import Broker, NeubotFarm


class Pipeline:
    def __init__(self, broker: Broker):
        self.broker = broker
        self.farms: List[NeubotFarm] = []
        self.services: List[StreamService] = []
        self.edges: List[Tuple[str, str]] = []   # (upstream name, queue)

    def add_farm(self, farm: NeubotFarm) -> "Pipeline":
        self.farms.append(farm)
        return self

    def add_service(self, svc: StreamService) -> "Pipeline":
        self.services.append(svc)
        return self

    def connect(self, upstream: StreamService, downstream_queue: str) -> None:
        """Sink of `upstream` republishes into `downstream_queue`."""
        q = self.broker.queue(downstream_queue)

        def sink(res: Dict) -> None:
            from repro_torch.pipeline.streams import Record
            q.publish(Record(ts=res["ts"], values={"value": res["value"]}))

        upstream.connect(sink)
        self.edges.append((upstream.cfg.name, downstream_queue))

    def topology(self) -> Dict[str, List[str]]:
        """Service DAG: name -> upstream service names (empty for services
        fed directly by producer queues)."""
        topo: Dict[str, List[str]] = {}
        for svc in self.services:
            topo[svc.cfg.name] = [u for (u, q) in self.edges
                                  if q == svc.cfg.queue]
        return topo

    def advance_to(self, ts: float) -> Dict[str, List[Dict]]:
        for farm in self.farms:
            farm.advance_to(ts)
        out: Dict[str, List[Dict]] = {}
        for svc in self.services:
            out[svc.cfg.name] = svc.run_until(ts)
        return out
