"""Edge↔DC network model.

Every cut edge in a placement plan (an edge-resident service feeding a
DC-resident one, or vice versa) pays a network hop: half-RTT plus
serialization at the link bandwidth, and NIC/radio energy per byte on
the edge side. Records can optionally be compressed before the uplink
(the paper's pipelines ship pre-aggregated or delta-coded measurements;
``compression`` is the resulting size factor).

Results flowing DC→edge are single aggregate records, so the downlink
is dominated by RTT rather than bandwidth.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Defaults ≈ a fixed-wireless uplink from an edge site to a DC."""
    uplink_bps: float = 20e6          # edge → DC
    downlink_bps: float = 100e6       # DC → edge
    rtt_s: float = 0.040
    record_bytes: float = 64.0        # wire size of one raw record
    result_bytes: float = 64.0        # wire size of one aggregate result
    compression: float = 1.0          # uplink size factor in (0, 1]
    energy_per_byte_j: float = 40e-9  # edge NIC/radio energy


class NetworkModel:
    """Transfer-time and energy accounting over one edge↔DC link."""

    def __init__(self, spec: LinkSpec):
        if not 0.0 < spec.compression <= 1.0:
            raise ValueError("compression must be in (0, 1]")
        self.spec = spec
        self.bytes_up = 0.0
        self.bytes_down = 0.0
        self.energy_j = 0.0

    def uplink_wire_bytes(self, n_records: int) -> float:
        return n_records * self.spec.record_bytes * self.spec.compression

    def uplink_serialization_s(self, n_records: int) -> float:
        """Time the uplink pipe is *occupied* by this transfer (excludes
        propagation) — what a contended shared uplink serializes on."""
        return self.uplink_wire_bytes(n_records) / self.spec.uplink_bps

    def uplink_time(self, n_records: int) -> float:
        return self.spec.rtt_s / 2 + self.uplink_serialization_s(n_records)

    def downlink_time(self, n_results: int = 1) -> float:
        wire = n_results * self.spec.result_bytes
        return self.spec.rtt_s / 2 + wire / self.spec.downlink_bps

    def uplink(self, n_records: int) -> float:
        """Ship `n_records` edge→DC; returns transfer time, accounts
        bytes and edge-side energy."""
        wire = n_records * self.spec.record_bytes * self.spec.compression
        self.bytes_up += wire
        self.energy_j += wire * self.spec.energy_per_byte_j
        return self.uplink_time(n_records)

    def downlink(self, n_results: int = 1) -> float:
        """Return `n_results` aggregates DC→edge."""
        wire = n_results * self.spec.result_bytes
        self.bytes_down += wire
        self.energy_j += wire * self.spec.energy_per_byte_j
        return self.downlink_time(n_results)

    def downlink_records(self, n_records: int) -> float:
        """Raw records arriving over this site's downlink (site→site
        routing relays through the backhaul: src uplink, then the dst
        site's downlink). Record-sized wire, not aggregate-sized."""
        wire = n_records * self.spec.record_bytes
        self.bytes_down += wire
        self.energy_j += wire * self.spec.energy_per_byte_j
        return self.spec.rtt_s / 2 + wire / self.spec.downlink_bps
