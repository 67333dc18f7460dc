"""Stream transport: an in-process broker with the RabbitMQ semantics the
paper deploys (named queues, bounded capacity, consumer offsets) and IoT
producers that generate Neubot-shaped network-test records (DESIGN §8:
the original dataset is not shipped; records are synthetic but share the
schema: timestamp, download_speed, upload_speed, latency, connection_type).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import random
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Record:
    ts: float
    values: Dict[str, float]


DEFAULT_QUEUE_CAPACITY = 65536


class Queue:
    """Bounded FIFO with per-consumer offsets (retained until all consume).

    Capacity is enforced with an oldest-drop policy: a publish into a
    full queue evicts the head record and counts it in ``dropped`` (the
    conservation ledger's ``overflow`` bucket). ``len(buf) <= capacity``
    is an invariant at every point, including across ``set_capacity``
    shrinks."""

    def __init__(self, name: str, capacity: int = DEFAULT_QUEUE_CAPACITY):
        if capacity < 1:
            raise ValueError(f"queue {name!r}: capacity must be >= 1, "
                             f"got {capacity}")
        self.name = name
        self.capacity = capacity
        self.buf: Deque[Record] = collections.deque()
        self.base_seq = 0              # seq of buf[0]
        self.offsets: Dict[str, int] = {}
        self.dropped = 0

    def publish(self, rec: Record) -> None:
        if len(self.buf) >= self.capacity:
            self.buf.popleft()
            self.base_seq += 1
            self.dropped += 1
        self.buf.append(rec)

    def set_capacity(self, capacity: int) -> None:
        """Rebound the queue; shrinking below the current backlog evicts
        the oldest records with the same drop accounting as a full
        publish."""
        if capacity < 1:
            raise ValueError(f"queue {self.name!r}: capacity must be >= 1, "
                             f"got {capacity}")
        self.capacity = capacity
        while len(self.buf) > self.capacity:
            self.buf.popleft()
            self.base_seq += 1
            self.dropped += 1

    def register(self, consumer: str) -> None:
        self.offsets.setdefault(consumer, self.base_seq + len(self.buf))

    def backlog(self, consumer: str) -> int:
        """Records published but not yet fetched by ``consumer`` (what a
        backpressured publisher is waiting on)."""
        off = max(self.offsets.get(consumer, self.base_seq), self.base_seq)
        return self.base_seq + len(self.buf) - off

    def fetch(self, consumer: str, max_n: int = 1 << 30) -> List[Record]:
        off = self.offsets.get(consumer, self.base_seq)
        off = max(off, self.base_seq)
        start = off - self.base_seq
        out = list(self.buf)[start:start + max_n]
        self.offsets[consumer] = off + len(out)
        return out


class Broker:
    def __init__(self):
        self.queues: Dict[str, Queue] = {}

    def queue(self, name: str, capacity: Optional[int] = None) -> Queue:
        """Get-or-create a queue. ``capacity=None`` (the default) leaves
        an existing queue's bound untouched; an explicit capacity is
        applied even when the queue already exists — previously it was
        silently ignored, so two declarations with different bounds
        diverged from what actually ran."""
        if name not in self.queues:
            self.queues[name] = Queue(name, capacity if capacity is not None
                                      else DEFAULT_QUEUE_CAPACITY)
        elif capacity is not None and capacity != self.queues[name].capacity:
            self.queues[name].set_capacity(capacity)
        return self.queues[name]


_TWOPI = 2.0 * math.pi
_sqrt, _log, _cos, _sin = math.sqrt, math.log, math.cos, math.sin


class StreamProducer:
    """One 'thing' producing measurements at a fixed rate.

    ``_record`` inlines ``random.gauss`` / ``random.choice([0,1,2])``
    against the producer's own ``Random`` instance — same underlying
    Mersenne-Twister draw sequence (gauss pair-caching and the
    ``getrandbits`` rejection loop included), so the generated values
    are bit-identical to the stdlib calls while skipping their
    per-record attribute-lookup and call overhead. The functional drive
    creates millions of records per scenario; this is its hottest path.
    """

    def __init__(self, broker: Broker, queue: str, thing_id: int,
                 rate_hz: float = 1.0, seed: int = 0):
        self.q = broker.queue(queue)
        self.thing_id = thing_id
        self.period = 1.0 / rate_hz
        self.rng = random.Random(seed * 7919 + thing_id)
        self._random = self.rng.random
        self._getrandbits = self.rng.getrandbits
        self._gauss_next: Optional[float] = None
        self._next_t = 0.0

    def _record(self, ts: float) -> Record:
        rnd = self._random
        g = self._gauss_next
        # gauss(base, 4e6)
        if g is None:
            x2pi = rnd() * _TWOPI
            g2rad = _sqrt(-2.0 * _log(1.0 - rnd()))
            z = _cos(x2pi) * g2rad
            g = _sin(x2pi) * g2rad
        else:
            z, g = g, None
        base = 20e6 + 5e6 * _sin(ts / 3600.0 + self.thing_id)
        dl = base + z * 4e6
        # gauss(base / 4, 1e6)
        if g is None:
            x2pi = rnd() * _TWOPI
            g2rad = _sqrt(-2.0 * _log(1.0 - rnd()))
            z = _cos(x2pi) * g2rad
            g = _sin(x2pi) * g2rad
        else:
            z, g = g, None
        ul = base / 4 + z * 1e6
        # gauss(30, 12)
        if g is None:
            x2pi = rnd() * _TWOPI
            g2rad = _sqrt(-2.0 * _log(1.0 - rnd()))
            z = _cos(x2pi) * g2rad
            g = _sin(x2pi) * g2rad
        else:
            z, g = g, None
        lat = 30 + z * 12
        self._gauss_next = g
        # choice([0, 1, 2]) == seq[_randbelow(3)] with k = 2 bits
        grb = self._getrandbits
        r = grb(2)
        while r >= 3:
            r = grb(2)
        return Record(ts=ts, values={
            "thing": float(self.thing_id),
            "download_speed": max(0.1e6, dl),
            "upload_speed": max(0.05e6, ul),
            "latency_ms": max(1.0, lat),
            "connection_type": float(r),
        })

    def advance_to(self, ts: float) -> int:
        n = 0
        while self._next_t <= ts:
            self.q.publish(self._record(self._next_t))
            self._next_t += self.period
            n += 1
        return n


class NeubotFarm:
    """An IoT farm of producers on one queue (the paper's clustered
    RabbitMQ deployment, scaled by n_things)."""

    def __init__(self, broker: Broker, queue: str = "neubotspeed",
                 n_things: int = 8, rate_hz: float = 1.0, seed: int = 0):
        self.producers = [StreamProducer(broker, queue, i, rate_hz, seed)
                          for i in range(n_things)]

    def advance_to(self, ts: float) -> int:
        return sum(p.advance_to(ts) for p in self.producers)
