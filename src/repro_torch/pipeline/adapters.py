"""Async-capable operator adapters.

:meth:`~repro_torch.pipeline.service.StreamService.run_until` fuses the Fig. 2
recurrence — fetch, then fire every due window — into one synchronous
call. An event-loop runtime needs *time between the halves*: the window
is snapshotted when the fire is dispatched, but the operator only runs
(and its sinks only publish) once the placed device finishes executing,
possibly much later and on another site. :class:`StageAdapter` splits
the recurrence accordingly and adds the dispatch-time introspection the
serving layer needs (window size, newly covered records and their
origins — for shipping cost — and input-queue backlog — for
backpressure) without touching the operator classes themselves.

The adapter expects the pipeline to be instrumented with the
conservation taps (:func:`repro_torch.scenario.ledger.tap_pipeline`): the
taps own the covered-record set and the per-record origin attribution the
preview reads, and they record the canonical ``FireRec`` trace when
:meth:`fire` finally runs.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

from repro_torch.pipeline.service import StreamService


class StageAdapter:
    """One service, split into dispatch-time and completion-time halves.

    The adapter is only safe under *serial* use (one in-flight fire per
    service): :meth:`preview_cover` assumes nothing covers records
    between the dispatch that previewed them and the :meth:`fire` that
    claims them — which is exactly the serving runtime's model of an
    operator instance."""

    def __init__(self, svc: StreamService, qtap, stap):
        self.svc = svc
        self.qtap = qtap            # _QueueTap of the input queue
        self.stap = stap            # _ServiceTap of this service
        self.name = svc.cfg.name
        self.slide_s = svc.cfg.window.slide_s

    def fire_times(self, horizon_s: float) -> Iterator[float]:
        """The service's fire grid over the horizon — same float
        accumulation as ``run_until``'s ``_next_fire`` so the engine's
        drive and the runtime schedule byte-identical fire sets."""
        t = self.slide_s
        while t <= horizon_s:
            yield t
            t += self.slide_s

    # ---- dispatch-time half ----------------------------------------------
    def fetch(self) -> int:
        """Consume the input queue into the operator buffer (Fetch)."""
        return self.svc.fetch()

    def peek_window(self, ts: float) -> int:
        """Window size the fire at ``ts`` will aggregate — what the
        placed device's execution time is charged for."""
        return int(len(self.svc._window_values(ts)))

    def preview_cover(self, ts: float
                      ) -> Tuple[int, Dict[Optional[str], int]]:
        """(n_new, origins) the fire at ``ts`` will newly cover, without
        mutating the tap's covered set: the runtime needs per-origin
        record counts *at dispatch* to ship cross-site inputs, while the
        tap claims coverage only when the operator actually fires."""
        n_new = 0
        origins: Dict[Optional[str], int] = {}
        for r in self.svc.buffer:
            if id(r) not in self.stap.covered and r.ts < ts:
                n_new += 1
                o = self.qtap.origin.get(id(r))
                origins[o] = origins.get(o, 0) + 1
        return n_new, origins

    def backlog(self) -> int:
        """Unfetched records in this stage's input queue (what an
        upstream publisher backpressures on)."""
        return self.svc.q.backlog(self.name)

    # ---- completion-time half --------------------------------------------
    def fire(self, ts: float) -> Optional[Dict]:
        """Run OperatorLogic for the window at logical time ``ts`` and
        let the Sinks publish downstream. Called at the fire's *virtual
        completion* instant — the window is still the dispatch-time
        snapshot because the stage is serial and only ``fetch`` mutates
        the buffer."""
        return self.svc.fire(ts)
