"""Multi-edge-site fleet topology (online controller subsystem).

The paper's deployment has *one* gateway next to the IoT farm; a fleet
has several — heterogeneous gateway-class boxes, each with its own
last-mile :class:`~repro_torch.placement.network.LinkSpec` toward the DC, all
sharing one contended WAN uplink: concurrent uplink transfers (record
hauls, DC offloads, migration state) serialize FIFO through the shared
pipe, so one site's burst delays every site's offloads.

A fleet can also be *hierarchical* (``repro_torch.region.HierFleetSpec``):
sites are partitioned into regions, each with its own shared edge-tier
pipe (the per-region twin of the flat fleet's single uplink) and a
regional aggregation point (RAP) whose trunk link to the DC core is a
second FIFO tier. :class:`Fleet` duck-types the hierarchy off the
spec's ``regions`` attribute, so the flat ``FleetSpec`` remains a
degenerate one-region hierarchy with a *transparent* RAP (infinite
trunk bandwidth, zero RTT — contributes nothing, bit-identically).

Routing between placement sites (flat; [RAP] legs apply only to
non-transparent hierarchies):

  edge→DC    src site's uplink through its region's edge-tier FIFO,
             half-RTT after serialization completes [then the RAP trunk
             FIFO + half trunk RTT].
  DC→edge    [RAP trunk downlink, uncontended] then the dst site's
             downlink (uncontended direction).
  edge→edge  relayed through the backhaul: src uplink (FIFO) then the
             dst site's downlink — a pipeline cut spanning two gateways
             pays both legs [cross-region cuts additionally pay the src
             RAP trunk up and the dst RAP trunk down; same-region cuts
             turn around at the RAP and never touch the trunk].

Sites can fail and recover (drift scenarios): while a site is down its
device executes nothing — fires queue until recovery (the outage windows
push the device's busy horizon), and the controller is expected to move
services off the site at the next epoch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.placement.edge import EdgeNode, EdgeSpec, FireExec
from repro_torch.placement.network import LinkSpec, NetworkModel
from repro_torch.placement.plan import SITE_DC


def transparent_link(link: LinkSpec) -> bool:
    """True when ``link`` is a transparent (no-op) pipe — the degenerate
    RAP that makes a flat fleet and a one-region hierarchy bit-identical
    (infinite bandwidth, zero RTT, zero per-byte energy)."""
    return (math.isinf(link.uplink_bps) and math.isinf(link.downlink_bps)
            and link.rtt_s == 0.0 and link.energy_per_byte_j == 0.0)


@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """One edge gateway site: device + last-mile link + the producer
    queues whose farms are physically attached to it."""
    name: str
    edge: EdgeSpec
    link: LinkSpec = dataclasses.field(default_factory=LinkSpec)
    farm_queues: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """The static fleet topology. ``user_site`` is where DC results
    surface for the user (one downlink per completed DC fire, as in the
    single-site co-sim); defaults to the first site."""
    sites: Tuple[SiteSpec, ...]
    user_site: str = ""

    def __post_init__(self):
        names = [s.name for s in self.sites]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate site names: {names}")
        if SITE_DC in names:
            raise ValueError(f"{SITE_DC!r} is reserved for the data center")
        if not self.sites:
            raise ValueError("a fleet needs at least one edge site")
        queues: Dict[str, str] = {}
        for s in self.sites:
            for q in s.farm_queues:
                if q in queues:
                    raise ValueError(
                        f"farm queue {q!r} pinned to both {queues[q]!r} "
                        f"and {s.name!r}")
                queues[q] = s.name
        if self.user_site and self.user_site not in names:
            raise ValueError(f"user_site {self.user_site!r} not in {names}")
        # O(1) lookup caches (a 500-site fleet is queried per service per
        # plan evaluation; the linear scans used to dominate)
        object.__setattr__(self, "_site_by_name",
                           {s.name: s for s in self.sites})
        object.__setattr__(self, "_site_of_queue", dict(queues))

    @property
    def site_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.sites)

    def site(self, name: str) -> SiteSpec:
        try:
            return self._site_by_name[name]
        except KeyError:
            raise KeyError(name) from None

    def farm_site(self, queue: str) -> str:
        """Site whose farm publishes into ``queue``; unpinned queues
        default to the first site (the classic single-gateway reading)."""
        return self._site_of_queue.get(queue, self.sites[0].name)

    @property
    def result_site(self) -> str:
        return self.user_site or self.sites[0].name


class LinkQueue:
    """FIFO serialization of one shared pipe: a transfer occupies the
    pipe for its serialization time; concurrent transfers queue in
    admission order. Propagation (half-RTT) overlaps and does not hold
    the pipe. One instance per contended tier — the flat fleet's shared
    WAN uplink, a region's edge-tier pipe, or a RAP's trunk to the DC
    core."""

    def __init__(self):
        self.busy_until = 0.0
        self.queue_wait_s = 0.0     # total time transfers sat in the FIFO
        self.transfers = 0
        # admission log [ready_ts, serialization_s, active] — lets an
        # admitted-but-unserviced transfer be withdrawn (its source site
        # died before the pipe got to it) with exact FIFO restoration
        self._log: List[List] = []

    def admit(self, ready_ts: float, serialization_s: float) -> float:
        """Returns the time the transfer starts serializing."""
        start = max(ready_ts, self.busy_until)
        self.queue_wait_s += start - ready_ts
        self.busy_until = start + serialization_s
        self.transfers += 1
        self._log.append([ready_ts, serialization_s, True])
        return start

    @property
    def last_token(self) -> int:
        """Token of the most recent admission (pass to ``withdraw``)."""
        return len(self._log) - 1

    def withdraw(self, token: int) -> bool:
        """Withdraw admission ``token`` and restore ``busy_until`` /
        ``queue_wait_s`` / ``transfers`` exactly as if it had never been
        admitted (the remaining admissions replay in order). Returns
        False when the token was already withdrawn."""
        if token < 0 or token >= len(self._log) or not self._log[token][2]:
            return False
        self._log[token][2] = False
        self.busy_until = 0.0
        self.queue_wait_s = 0.0
        self.transfers = 0
        for ready_ts, ser, active in self._log:
            if not active:
                continue
            start = max(ready_ts, self.busy_until)
            self.queue_wait_s += start - ready_ts
            self.busy_until = start + ser
            self.transfers += 1
        return True

    def withdraw_last(self) -> bool:
        """Withdraw the most recent still-active admission."""
        for i in range(len(self._log) - 1, -1, -1):
            if self._log[i][2]:
                return self.withdraw(i)
        return False


class ContendedUplink(LinkQueue):
    """The flat fleet's single shared WAN uplink — now just a
    :class:`LinkQueue` under its historical name (kept because it is
    part of the public ``repro_torch.online`` surface)."""


class EdgeSite:
    """Live state of one gateway: serial device + link accounting +
    failure windows. ``outages`` are the *scheduled* maintenance windows
    (the oracle may read them); ``crashes`` / ``partitions`` /
    ``straggles`` are realized chaos windows kept separate so planning
    stays blind to them — a crash downs device *and* link, a partition
    downs only the link, a straggle multiplies link serialization."""

    def __init__(self, spec: SiteSpec,
                 outages: Sequence[Tuple[float, float]] = (),
                 crashes: Sequence[Tuple[float, float]] = (),
                 partitions: Sequence[Tuple[float, float]] = (),
                 straggles: Sequence[Tuple[float, float, float]] = ()):
        self.spec = spec
        self.node = EdgeNode(spec.edge)
        self.net = NetworkModel(spec.link)
        self.outages = sorted(outages)
        self.crashes = sorted(crashes)
        self.partitions = sorted(partitions)
        self.straggles = sorted(straggles)
        # device-down = scheduled outage OR unplanned crash;
        # link-dead = crash OR partition
        self._device_down = sorted(self.outages + self.crashes)
        self._link_dead = sorted(self.crashes + self.partitions)
        # realized uplink occupancy (chaos telemetry feed): seconds the
        # site's transfers held a shared pipe, and how many transfers
        self.link_busy_s = 0.0
        self.link_transfers = 0

    def available_at(self, t: float) -> float:
        """Earliest time >= t at which the device is not down."""
        for down, up in self._device_down:
            if down <= t < up:
                return up
        return t

    def failed_at(self, t: float) -> bool:
        return any(down <= t < up for down, up in self._device_down)

    def crashed_at(self, t: float) -> bool:
        return any(lo <= t < hi for lo, hi in self.crashes)

    def partitioned_at(self, t: float) -> bool:
        return any(lo <= t < hi for lo, hi in self.partitions)

    def link_blocked_until(self, t: float) -> Optional[float]:
        """End of the link-dead (crash ∪ partition) window covering
        ``t``, or None when the link is up."""
        out = None
        for lo, hi in self._link_dead:
            if lo <= t < hi:
                out = hi if out is None else max(out, hi)
        return out

    def straggle_factor(self, t: float) -> float:
        f = 1.0
        for lo, hi, fac in self.straggles:
            if lo <= t < hi:
                f = max(f, fac)
        return f

    def execute_fire(self, ready_ts: float, n_records: int,
                     flops_per_record: float = 0.0) -> FireExec:
        """Serial execution with down-window deferral: a down site
        (scheduled outage or unplanned crash) executes nothing, so any
        fire whose execution would *overlap* a down window (including
        one that would start just before the site fails) is deferred to
        recovery."""
        dur = self.node.fire_time(n_records, flops_per_record)
        start = max(ready_ts, self.node.busy_until)
        moved = True
        while moved:
            moved = False
            for down, up in self._device_down:
                if start < up and start + dur > down:
                    start = max(up, self.node.busy_until)
                    moved = True
        if start > self.node.busy_until:
            self.node.busy_until = start
        return self.node.execute_fire(ready_ts, n_records, flops_per_record)


class Fleet:
    """Live multi-site topology: per-site devices and links plus the
    contended shared pipes every WAN transfer serializes through — one
    uplink for a flat fleet, a per-region edge tier + per-region RAP
    trunk for a hierarchical one (``spec.regions``, duck-typed)."""

    def __init__(self, spec: FleetSpec,
                 outages: Optional[Mapping[str, Sequence[Tuple[float, float]]]]
                 = None, chaos=None):
        self.spec = spec
        outages = outages or {}
        unknown = set(outages) - set(spec.site_names)
        if unknown:
            raise ValueError(f"outages for unknown sites: {sorted(unknown)}")
        # chaos: an optional compiled ChaosTimeline — per-site realized
        # crash/partition/straggle windows injected physically (and kept
        # apart from the forecastable `outages`). None → every chaos
        # path below is dormant and routing is bit-identical.
        self.chaos = chaos
        self.sites: Dict[str, EdgeSite] = {
            s.name: EdgeSite(
                s, outages.get(s.name, ()),
                crashes=chaos.crash_windows(s.name) if chaos else (),
                partitions=chaos.partition_windows(s.name) if chaos else (),
                straggles=chaos.straggle_windows(s.name) if chaos else ())
            for s in spec.sites}

        regions = tuple(getattr(spec, "regions", ()) or ())
        if regions:
            self.region_names: Tuple[str, ...] = tuple(r.name for r in regions)
            self._region_of: Dict[str, int] = {
                site: i for i, r in enumerate(regions) for site in r.sites}
            self._edge_q: List[LinkQueue] = [LinkQueue() for _ in regions]
            self._rap_q: List[LinkQueue] = [LinkQueue() for _ in regions]
            # transparent RAPs short-circuit (None): the degenerate
            # one-region hierarchy routes bit-identically to a flat fleet
            self._rap: List[Optional[NetworkModel]] = [
                None if transparent_link(r.rap) else NetworkModel(r.rap)
                for r in regions]
        else:
            self.region_names = ("fleet",)
            self._region_of = {name: 0 for name in spec.site_names}
            self._edge_q = [LinkQueue()]
            self._rap_q = [LinkQueue()]
            self._rap = [None]
        # historical name: the (first) edge-tier shared pipe
        self.uplink: LinkQueue = self._edge_q[0]

    def site(self, name: str) -> EdgeSite:
        return self.sites[name]

    def region_of(self, site: str) -> int:
        return self._region_of[site]

    # ---------------------------------------------------------- RAP legs
    def _rap_up(self, region: int, wire_bytes: float, t: float) -> float:
        """Trunk leg RAP→DC-core: FIFO-contended serialization plus half
        the trunk RTT; accounts trunk bytes/energy. No-op when the RAP
        is transparent."""
        net = self._rap[region]
        if net is None:
            return t
        ser = wire_bytes / net.spec.uplink_bps
        start = self._rap_q[region].admit(t, ser)
        net.bytes_up += wire_bytes
        net.energy_j += wire_bytes * net.spec.energy_per_byte_j
        return start + ser + net.spec.rtt_s / 2

    def _rap_down(self, region: int, wire_bytes: float, t: float) -> float:
        """Trunk leg DC-core→RAP (uncontended direction, like a site
        downlink); accounts trunk bytes/energy."""
        net = self._rap[region]
        if net is None:
            return t
        net.bytes_down += wire_bytes
        net.energy_j += wire_bytes * net.spec.energy_per_byte_j
        return t + net.spec.rtt_s / 2 + wire_bytes / net.spec.downlink_bps

    def _crosses_core(self, src: str, dst: str) -> bool:
        """True when a src→dst transfer transits the DC core (leaves the
        src region / enters the dst region) rather than turning around
        inside one region."""
        if src == SITE_DC or dst == SITE_DC:
            return True
        return self._region_of[src] != self._region_of[dst]

    # ------------------------------------------------------------- routing
    def _admit_src(self, site: EdgeSite, region: int, ser0: float,
                   ready_ts: float) -> Tuple[float, float]:
        """Admit one uplink serialization for ``site``, chaos-aware:
        a straggling link inflates the serialization, and a transfer
        admitted into a dead-link window (the source crashed or
        partitioned before the pipe got to it) is *withdrawn* and
        re-admitted at heal. Without chaos windows this is exactly one
        ``admit`` at ×1.0. Returns ``(start, serialization_s)``."""
        q = self._edge_q[region]
        ser = ser0 * site.straggle_factor(ready_ts)
        start = q.admit(ready_ts, ser)
        while True:
            blocked = site.link_blocked_until(start)
            if blocked is None:
                break
            q.withdraw_last()
            ser = ser0 * site.straggle_factor(blocked)
            start = q.admit(blocked, ser)
        site.link_busy_s += ser
        site.link_transfers += 1
        return start, ser

    def ship_records(self, src: str, dst: str, n_records: int,
                     ready_ts: float) -> float:
        """Route ``n_records`` raw records src→dst; returns their arrival
        time. Same-site moves are free; any uplink leg contends FIFO."""
        if n_records <= 0 or src == dst:
            return ready_ts
        t = ready_ts
        cross = self._crosses_core(src, dst)
        if src != SITE_DC:
            site = self.sites[src]
            ser0 = site.net.uplink_serialization_s(n_records)
            start, ser = self._admit_src(site, self._region_of[src], ser0, t)
            site.net.uplink(n_records)          # bytes + NIC energy
            t = start + ser + site.net.spec.rtt_s / 2
            if cross:
                t = self._rap_up(self._region_of[src],
                                 site.net.uplink_wire_bytes(n_records), t)
        if dst != SITE_DC:
            dsite = self.sites[dst]
            blocked = dsite.link_blocked_until(t)
            if blocked is not None:   # dst link dead: delivery waits for heal
                t = blocked
            if cross:
                t = self._rap_down(self._region_of[dst],
                                   n_records * dsite.net.spec.record_bytes, t)
            t += dsite.net.downlink_records(n_records)
        return t

    def ship_result(self, src: str, dst: str, ready_ts: float) -> float:
        """Route one aggregate result src→dst (service handoff across a
        cut). Results are single records: the uplink leg still pays FIFO
        admission, the downlink leg is propagation-dominated."""
        if src == dst:
            return ready_ts
        t = ready_ts
        cross = self._crosses_core(src, dst)
        if src != SITE_DC:
            site = self.sites[src]
            ser0 = site.net.spec.result_bytes / site.net.spec.uplink_bps
            start, ser = self._admit_src(site, self._region_of[src], ser0, t)
            site.net.bytes_up += site.net.spec.result_bytes
            site.net.energy_j += (site.net.spec.result_bytes
                                  * site.net.spec.energy_per_byte_j)
            t = start + ser + site.net.spec.rtt_s / 2
            if cross:
                t = self._rap_up(self._region_of[src],
                                 site.net.spec.result_bytes, t)
        if dst != SITE_DC:
            dsite = self.sites[dst]
            blocked = dsite.link_blocked_until(t)
            if blocked is not None:
                t = blocked
            if cross:
                t = self._rap_down(self._region_of[dst],
                                   dsite.net.spec.result_bytes, t)
            t += dsite.net.downlink(1)
        return t

    def ship_state(self, src: str, dst: str, state_bytes: float,
                   ready_ts: float) -> float:
        """Migration state transfer (operator buffer shipped under a new
        placement plan). Occupies the shared pipes like any transfer —
        a migration storm visibly delays record offloads."""
        if state_bytes <= 0 or src == dst:
            return ready_ts
        t = ready_ts
        cross = self._crosses_core(src, dst)
        if src != SITE_DC:
            site = self.sites[src]
            ser0 = state_bytes / site.net.spec.uplink_bps
            start, ser = self._admit_src(site, self._region_of[src], ser0, t)
            site.net.bytes_up += state_bytes
            site.net.energy_j += state_bytes * site.net.spec.energy_per_byte_j
            t = start + ser + site.net.spec.rtt_s / 2
            if cross:
                t = self._rap_up(self._region_of[src], state_bytes, t)
        if dst != SITE_DC:
            site = self.sites[dst]
            blocked = site.link_blocked_until(t)
            if blocked is not None:
                t = blocked
            if cross:
                t = self._rap_down(self._region_of[dst], state_bytes, t)
            t += (site.net.spec.rtt_s / 2
                  + state_bytes / site.net.spec.downlink_bps)
            site.net.bytes_down += state_bytes
            site.net.energy_j += state_bytes * site.net.spec.energy_per_byte_j
        return t

    def downlink_time(self, dst: str) -> float:
        """Propagation+wire time of one result onto ``dst``'s downlink
        (no accounting — used for SLO shifts). Results surfacing from
        the DC core additionally ride the dst region's RAP trunk down
        in a hierarchy."""
        t = self.sites[dst].net.downlink_time(1)
        net = self._rap[self._region_of[dst]]
        if net is not None:
            t += (net.spec.rtt_s / 2
                  + self.sites[dst].net.spec.result_bytes
                  / net.spec.downlink_bps)
        return t

    # ---------------------------------------------------------- accounting
    @property
    def uplink_wait_s(self) -> float:
        """Total FIFO queue wait across every contended tier (edge-tier
        pipes + RAP trunks). Flat fleets: exactly the single uplink's."""
        return (sum(q.queue_wait_s for q in self._edge_q)
                + sum(q.queue_wait_s for q in self._rap_q))

    @property
    def uplink_transfers(self) -> int:
        return (sum(q.transfers for q in self._edge_q)
                + sum(q.transfers for q in self._rap_q))

    @property
    def edge_energy_j(self) -> float:
        return sum(s.node.energy_j for s in self.sites.values())

    @property
    def network_energy_j(self) -> float:
        return (sum(s.net.energy_j for s in self.sites.values())
                + sum(n.energy_j for n in self._rap if n is not None))

    @property
    def bytes_up(self) -> float:
        return sum(s.net.bytes_up for s in self.sites.values())

    @property
    def bytes_down(self) -> float:
        return sum(s.net.bytes_down for s in self.sites.values())

    def per_site_energy(self) -> Dict[str, Dict[str, float]]:
        return {name: {"edge_j": round(site.node.energy_j, 3),
                       "network_j": round(site.net.energy_j, 3),
                       "bytes_up": int(site.net.bytes_up),
                       "bytes_down": int(site.net.bytes_down)}
                for name, site in self.sites.items()}

    def per_region_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-region tier accounting: edge-tier FIFO wait/transfers and
        RAP trunk wait/transfers/bytes (zeros for transparent RAPs)."""
        out: Dict[str, Dict[str, float]] = {}
        for i, name in enumerate(self.region_names):
            rap = self._rap[i]
            out[name] = {
                "edge_fifo_wait_s": round(self._edge_q[i].queue_wait_s, 3),
                "edge_transfers": self._edge_q[i].transfers,
                "rap_fifo_wait_s": round(self._rap_q[i].queue_wait_s, 3),
                "rap_transfers": self._rap_q[i].transfers,
                "rap_bytes_up": int(rap.bytes_up) if rap else 0,
                "rap_bytes_down": int(rap.bytes_down) if rap else 0,
            }
        return out
