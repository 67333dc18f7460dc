"""Edge device model for the placement engine.

The paper's edge tier is a small gateway-class box next to the IoT farm:
it can absorb the stream and run light aggregation windows, but a heavy
analytics operator (CNN scoring, large post-mortem scans) quickly
outgrows it — that is precisely the offloading decision the placement
engine searches over.

An :class:`EdgeNode` is a single serial executor (one device per site):
service fires queue behind each other, so co-locating too many services
on the edge shows up as queueing latency, not just energy. Per-fire cost
has an ingest term (records/s the box can pump through its buffers), a
compute term (operator FLOPs against the box's sustained FLOP/s) and a
fixed per-fire overhead (scheduler wakeup + fetch).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EdgeSpec:
    """A gateway-class edge device (defaults ≈ a quad-core ARM box)."""
    name: str = "edge-0"
    throughput_rps: float = 50_000.0      # records/s ingest+window pump
    flops_per_s: float = 20e9             # sustained analytics FLOP/s
    ram_bytes: float = 256 * 2**20        # buffer budget for all services
    record_bytes: float = 64.0            # in-RAM footprint of one record
    energy_per_record_j: float = 20e-6    # ingest/window energy
    active_power_w: float = 6.0           # draw while a fire executes
    fire_overhead_s: float = 2e-3         # wakeup + fetch per fire

    def ram_required(self, buffer_records: int) -> float:
        """RAM footprint of hosting `buffer_records` of service buffer
        budget on this device (single source of the record-footprint
        model — the co-sim's feasibility check goes through here)."""
        return buffer_records * self.record_bytes


@dataclasses.dataclass(frozen=True)
class FireExec:
    """Accounting for one service fire executed on the edge."""
    start: float
    finish: float
    energy_j: float


class EdgeNode:
    """Serial executor with busy-queue semantics and energy accounting."""

    def __init__(self, spec: EdgeSpec):
        self.spec = spec
        self.busy_until = 0.0
        self.energy_j = 0.0

    def fire_time(self, n_records: int, flops_per_record: float) -> float:
        """Service time of one window fire over `n_records` values."""
        s = self.spec
        ingest = n_records / s.throughput_rps
        compute = n_records * flops_per_record / s.flops_per_s
        return max(ingest, compute) + s.fire_overhead_s

    def execute_fire(self, ready_ts: float, n_records: int,
                     flops_per_record: float = 0.0) -> FireExec:
        """Run one fire as soon as its inputs are ready and the device is
        free; returns start/finish/energy. Mutates the busy horizon."""
        dur = self.fire_time(n_records, flops_per_record)
        start = max(ready_ts, self.busy_until)
        finish = start + dur
        energy = (n_records * self.spec.energy_per_record_j
                  + dur * self.spec.active_power_w)
        self.busy_until = finish
        self.energy_j += energy
        return FireExec(start, finish, energy)
