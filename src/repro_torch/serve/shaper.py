"""Uplink shaping: the serving runtime's cross-site byte movement.

Placement-as-routing means a DC-placed stage's inputs go through an
uplink shaper and an edge-placed stage's remote inputs are hauled
between gateways. The shaper delegates every transfer to the *same*
:class:`~repro_torch.online.fleet.Fleet` physical models the DES uses — the
shared :class:`~repro_torch.online.fleet.ContendedUplink` FIFO, per-site
:class:`~repro_torch.placement.network.NetworkModel` byte/energy accounting —
so a measured byte costs exactly what a simulated byte costs. The only
difference is *when* admissions happen: the runtime's stages reach the
shaper at their virtual-time instants (the serving analogue of the
engine's causal cursor), so FIFO admission order is the order stages
actually offload.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.online.fleet import Fleet
from repro_torch.placement.plan import SITE_DC


class UplinkShaper:
    def __init__(self, fleet: Fleet):
        self.fleet = fleet

    def ship_inputs(self, origins: Dict[Optional[str], int],
                    origin_site: Callable[[Optional[str]], str],
                    dst: str, base: float) -> float:
        """Arrival time at ``dst`` of a fire's newly covered records
        that live on other sites (mirrors the engine's input haul:
        per-source-site grouped transfers, DC-origin results ride the
        result hop instead of re-shipping)."""
        groups: Dict[str, int] = {}
        for o, c in origins.items():
            so = origin_site(o)
            if so == dst or so == SITE_DC or c == 0:
                continue
            groups[so] = groups.get(so, 0) + c
        t = base
        for so in sorted(groups):
            t = max(t, self.fleet.ship_records(so, dst, groups[so], base))
        return t

    def result_arrival(self, src: str, dst: str, ready_out: float) -> float:
        """When one completed aggregate becomes visible on ``dst``
        (mirrors the engine's result hop: free to the same site, rides
        the consumer's record uplink to the DC, downlink from the DC,
        FIFO-contended uplink between gateways)."""
        if src == dst or dst == SITE_DC:
            return ready_out
        if src == SITE_DC:
            return ready_out + self.fleet.downlink_time(dst)
        return self.fleet.ship_result(src, dst, ready_out)

    def ship_state(self, src: str, dst: str, nbytes: float,
                   t0: float) -> float:
        """Migration state transfer (arrival time); contends the shared
        uplink like any transfer."""
        return self.fleet.ship_state(src, dst, nbytes, t0)

    def result_downlink(self, result_site: str) -> None:
        """Account one completed DC aggregate surfacing at the user's
        site (one downlink record, as the engine books per DC fire)."""
        self.fleet.site(result_site).net.downlink(1)
