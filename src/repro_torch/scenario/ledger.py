"""Record-conservation accounting shared by every co-simulation.

The functional dataflow always executes in-process through the real
:class:`~repro_torch.pipeline.composition.Pipeline`; these taps instrument the
broker queues and service fires so the engine can attribute every record
to exactly one terminal bucket (set partitions, not tallies), and the
drive helper advances the pipeline deterministically over the horizon.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.pipeline.composition import Pipeline

_EPS = 1e-6


# ---------------------------------------------------------------------------
# Record-conservation ledger
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServiceLedger:
    """Exact per-service record accounting (set partitions, not tallies)."""
    service: str
    queue: str = ""           # input queue (shared queues fan out)
    produced: int = 0         # published into the service's input queue
    overflow: int = 0         # queue capacity drops, never fetched
    unread: int = 0           # still sitting in the queue
    fetched: int = 0
    processed_edge: int = 0   # covered by a fire executed on the edge
    processed_dc: int = 0     # covered by a fire whose DC task completed
    dropped_dc: int = 0       # shipped, but the DC scheduler dropped it
    inflight_dc: int = 0      # shipped, task still pending at the horizon
    buffered: int = 0         # in the service buffer, not yet covered
    evicted_stored: int = 0   # spilled to the post-mortem store (retained)
    evicted_lost: int = 0     # evicted with no store attached
    # records processed TWICE under an at-least-once cold cutover (the
    # replay re-covers records the dead source already covered). Outside
    # the conservation partition on purpose: each record still lands in
    # exactly one terminal bucket; this counts the extra passes.
    duplicates: int = 0

    @property
    def covered(self) -> int:
        return (self.processed_edge + self.processed_dc
                + self.dropped_dc + self.inflight_dc)

    @property
    def in_flight(self) -> int:
        return (self.unread + self.buffered + self.inflight_dc
                + self.evicted_stored)

    @property
    def dropped(self) -> int:
        return self.overflow + self.dropped_dc + self.evicted_lost

    def conserved(self) -> bool:
        return (self.produced == self.overflow + self.unread + self.fetched
                and self.fetched == self.covered + self.buffered
                + self.evicted_stored + self.evicted_lost)


@dataclasses.dataclass
class RecordLedger:
    services: Dict[str, ServiceLedger] = dataclasses.field(default_factory=dict)

    def conserved(self) -> bool:
        return all(s.conserved() for s in self.services.values())

    def totals(self) -> Dict[str, int]:
        """Rolled-up counts. Queue-level keys (produced/overflow/unread)
        are deduplicated per queue so shared queues are not counted once
        per consumer; the remaining keys are per-consumer deliveries and
        may legitimately exceed `produced` when a queue fans out."""
        consumer_keys = ("fetched", "processed_edge", "processed_dc",
                         "dropped_dc", "inflight_dc", "buffered",
                         "evicted_stored", "evicted_lost")
        out = {k: sum(getattr(s, k) for s in self.services.values())
               for k in consumer_keys}
        seen = set()
        for k in ("produced", "overflow", "unread"):
            out[k] = 0
        for s in self.services.values():
            if s.queue in seen:
                continue
            seen.add(s.queue)
            for k in ("produced", "overflow", "unread"):
                out[k] += getattr(s, k)
        # at-least-once accounting: emitted only when nonzero so
        # chaos-free totals stay byte-identical to recorded benchmarks
        dup = sum(s.duplicates for s in self.services.values())
        if dup:
            out["duplicates"] = dup
        return out


class _PublisherContext:
    """Which service's fire is currently publishing (None = a producer
    farm). Lets queue taps attribute each record to its origin, which
    the uplink model needs to tell edge-origin records from results that
    never left the DC."""
    current: Optional[str] = None


class _QueueTap:
    """Instruments one broker queue: identity and origin of every
    published, dropped and per-consumer fetched record. Consumers (the
    service taps) may register a per-consumer listener to observe each
    fetched batch incrementally instead of re-scanning buffers."""

    def __init__(self, q, ctx: _PublisherContext):
        self.q = q
        self.pub_refs: List[object] = []
        self.drop_refs: List[object] = []
        self.origin: Dict[int, Optional[str]] = {}
        self.fetched: Dict[str, Dict[int, object]] = {}
        self.listeners: Dict[str, object] = {}
        orig_pub, orig_fetch = q.publish, q.fetch
        pub_append = self.pub_refs.append
        origin = self.origin
        buf = q.buf    # the deque is mutated in place, never reassigned

        def publish(rec):
            # detect overflow from the queue's own counter (drop-oldest:
            # the victim is the head snapshotted before the publish);
            # below capacity no drop is possible, skip the snapshots
            if len(buf) >= q.capacity:
                oldest = buf[0] if buf else None
                before = q.dropped
                orig_pub(rec)
                if q.dropped > before:
                    self.drop_refs.append(oldest)
            else:
                orig_pub(rec)
            pub_append(rec)
            origin[id(rec)] = ctx.current

        def fetch(consumer, max_n=1 << 30):
            recs = orig_fetch(consumer, max_n)
            if recs:
                got = self.fetched.get(consumer)
                if got is None:
                    got = self.fetched[consumer] = {}
                got.update(zip(map(id, recs), recs))
                lis = self.listeners.get(consumer)
                if lis is not None:
                    lis(recs)
            else:
                self.fetched.setdefault(consumer, {})
            return recs

        q.publish, q.fetch = publish, fetch


@dataclasses.dataclass
class FireRec:
    """One recorded service fire."""
    ts: float
    n_window: int   # values the operator aggregated (incl. store history)
    n_new: int      # records newly covered by this fire (first coverage)
    # n_new split by origin: None = farm/source, else producing service
    origins: Dict[Optional[str], int] = dataclasses.field(default_factory=dict)


class _ServiceTap:
    """Wraps StreamService.fire to log fires, first-coverage counts and
    per-origin attribution; marks the service as publisher while its
    sinks run.

    Coverage tracking is incremental: the queue tap's fetch listener
    feeds each newly fetched batch into an insertion-ordered uncovered
    map and the service's spill hook retires evictions, so a fire scans
    only the handful of records still awaiting coverage instead of the
    whole operator buffer (which is mostly already-covered window
    history). The counts and the per-origin attribution are identical
    to the original full-buffer scan: the uncovered map preserves
    buffer order, so records are covered in the same order."""

    def __init__(self, svc, qtap: _QueueTap, ctx: _PublisherContext):
        self.svc = svc
        self.fires: List[FireRec] = []
        self.covered: Dict[int, object] = {}
        self._uncovered: Dict[int, object] = {}
        orig_fire = svc.fire
        origin_get = qtap.origin.get
        unc = self._uncovered
        covered = self.covered

        def on_fetched(recs):
            unc.update(zip(map(id, recs), recs))

        qtap.listeners[svc.cfg.name] = on_fetched

        def on_spill(spill):
            for r in spill:
                unc.pop(id(r), None)

        svc._spill_hook = on_spill

        def fire(now):
            n_new = 0
            origins: Dict[Optional[str], int] = {}
            if unc:
                newly = [rid for rid, r in unc.items() if r.ts < now]
                n_new = len(newly)
                for rid in newly:
                    covered[rid] = unc.pop(rid)
                    o = origin_get(rid)
                    origins[o] = origins.get(o, 0) + 1
            prev = ctx.current
            ctx.current = svc.cfg.name
            try:
                res = orig_fire(now)
            finally:
                ctx.current = prev
            self.fires.append(FireRec(ts=now, n_window=res["n"],
                                      n_new=n_new, origins=origins))
            return res

        svc.fire = fire


def _topo_order(topology: Dict[str, List[str]],
                insertion: Sequence[str]) -> List[str]:
    """Kahn's algorithm, stable w.r.t. pipeline insertion order."""
    for n, ups in topology.items():
        for u in ups:
            if u not in topology:
                raise ValueError(
                    f"upstream {u!r} of {n!r} was connect()ed but never "
                    "add_service()d to the pipeline")
    indeg = {n: len(ups) for n, ups in topology.items()}
    order, ready = [], [n for n in insertion if indeg[n] == 0]
    while ready:
        n = ready.pop(0)
        order.append(n)
        for m in insertion:
            if n in topology[m]:
                indeg[m] -= topology[m].count(n)
                if indeg[m] == 0 and m not in order and m not in ready:
                    ready.append(m)
    if len(order) != len(topology):
        raise ValueError("pipeline topology has a cycle")
    return order


def tap_pipeline(pipe: Pipeline
                 ) -> Tuple[Dict[str, _ServiceTap], Dict[str, _QueueTap]]:
    """Instrument every queue/service of ``pipe`` without driving it.
    Returns the service taps and the per-service queue taps. This is the
    shared half of :func:`tap_and_drive`; the live serving runtime
    (``repro_torch.serve``) taps the pipeline the same way but lets its event
    loop do the driving, so engine and runtime emit one ledger schema."""
    ctx = _PublisherContext()
    qtaps: Dict[int, _QueueTap] = {}
    for s in pipe.services:
        if id(s.q) not in qtaps:
            qtaps[id(s.q)] = _QueueTap(s.q, ctx)
    staps = {s.cfg.name: _ServiceTap(s, qtaps[id(s.q)], ctx)
             for s in pipe.services}
    by_service = {s.cfg.name: qtaps[id(s.q)] for s in pipe.services}
    return staps, by_service


def tap_and_drive(pipe: Pipeline, horizon_s: float,
                  step_s: Optional[float] = None
                  ) -> Tuple[Dict[str, _ServiceTap], Dict[str, _QueueTap]]:
    """Instrument every queue/service of ``pipe`` and drive the
    functional dataflow to ``horizon_s`` in ``step_s`` increments
    (default: the minimum service slide). Returns the service taps and
    the per-service queue taps — the placement-independent fire trace
    every engine run replays."""
    staps, by_service = tap_pipeline(pipe)
    step = step_s or min(s.cfg.window.slide_s for s in pipe.services)
    t = 0.0
    while t < horizon_s - _EPS:
        t = min(t + step, horizon_s)
        pipe.advance_to(t)
    return staps, by_service
