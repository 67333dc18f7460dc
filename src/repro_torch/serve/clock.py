"""Deterministic virtual-time driver for the serving event loop.

A live runtime on wall-clock asyncio is not reproducible — task wake
order depends on host scheduling jitter. The serving runtime therefore
runs on *virtual* time: every actor (farm driver, service stage) parks
on this clock instead of ``asyncio.sleep``, and the epoch driver
advances time by resolving parked wakes in ``(t, prio, seq)`` order —
producers (prio 0) before stages (prio 1 + topo-rank), matching the
engine's ``(ts, rank)`` dispatch tie-break — then letting the event
loop settle until every actor is parked again. Two runs of the same
scenario replay the identical interleaving, which is what makes the
seeded-determinism guarantee (identical ledgers and telemetry) hold on
a real event loop.

Actors may also park on *event* futures (queue backpressure) that other
actors resolve mid-settle; the clock counts parked actors and
resolved-but-unconsumed futures so it knows when an instant has fully
played out.
"""
from __future__ import annotations

import asyncio
import heapq
from typing import List, Tuple

_EPS = 1e-9


class VirtualClock:
    def __init__(self, settle_rounds: int = 200_000):
        self.now = 0.0
        self._heap: List[Tuple[float, int, int, asyncio.Future]] = []
        self._seq = 0
        self._actors = 0        # live actor coroutines
        self._parked = 0        # of those, currently awaiting a future
        self._pending = 0       # futures resolved, awaiter not yet resumed
        self._settle_rounds = settle_rounds

    # ---------------------------------------------------------- actor side
    def spawn(self, coro) -> asyncio.Task:
        """Run ``coro`` as a clock-tracked actor task."""
        async def _wrap():
            self._actors += 1
            try:
                await coro
            finally:
                self._actors -= 1
        return asyncio.get_running_loop().create_task(_wrap())

    async def sleep_until(self, t: float, prio: int = 1) -> None:
        """Park until virtual time ``t``; returns immediately if the
        clock is already there. ``prio`` breaks same-instant ties."""
        if t <= self.now + _EPS:
            return
        fut = asyncio.get_running_loop().create_future()
        self._seq += 1
        heapq.heappush(self._heap, (t, prio, self._seq, fut))
        await self._park(fut)

    def event(self) -> asyncio.Future:
        """A park-able future another actor resolves via :meth:`fire`
        (timeless wake: queue backpressure release)."""
        return asyncio.get_running_loop().create_future()

    async def wait(self, fut: asyncio.Future) -> None:
        await self._park(fut)

    def fire(self, fut: asyncio.Future) -> None:
        if not fut.done():
            self._pending += 1
            fut.set_result(None)

    async def _park(self, fut: asyncio.Future) -> None:
        self._parked += 1
        try:
            await fut
        finally:
            self._parked -= 1
            if fut.done() and not fut.cancelled():
                self._pending -= 1

    # --------------------------------------------------------- driver side
    def quiescent(self) -> bool:
        """Every live actor is parked and every resolved wake has been
        consumed — the current instant has fully played out."""
        return self._pending == 0 and self._parked == self._actors

    async def _settle(self) -> None:
        for _ in range(self._settle_rounds):
            await asyncio.sleep(0)
            if self.quiescent():
                return
        raise RuntimeError(
            "serve runtime failed to settle: an actor is spinning without "
            "parking on the virtual clock")

    async def advance_past(self, t_limit: float) -> None:
        """Play the world up to (but excluding) ``t_limit``: resolve
        every scheduled wake with ``t < t_limit`` in ``(t, prio, seq)``
        order, settling the loop between instants, then pin ``now`` at
        the boundary. Wakes at exactly ``t_limit`` belong to the next
        epoch — the driver decides the next plan first, matching the
        engine's strict ``ts < t1`` epoch attribution."""
        await self._settle()
        while self._heap and self._heap[0][0] < t_limit - _EPS:
            t = self._heap[0][0]
            self.now = t
            while self._heap and self._heap[0][0] <= t + _EPS:
                _, _, _, fut = heapq.heappop(self._heap)
                self.fire(fut)
            await self._settle()
        if t_limit != float("inf"):
            self.now = max(self.now, t_limit)
