"""Serving actors: farm drivers and service stages on the virtual loop.

A :class:`FarmDriver` advances one producer farm in drive-step
increments at producer priority (before any stage at the same instant,
matching the engine's farms-then-services drive order). Farms never
backpressure — sensors do not pause — so a slow consumer shows up as
broker-queue overflow (oldest-drop, ledger-accounted), not as lost
wall-clock.

A :class:`ServiceStage` is one real operator instance executing its
service's fire grid serially: park until the fire's timestamp, fetch
and snapshot the window (dispatch half), route the execution to the
placed site — hauling remote inputs through the uplink shaper, running
on the gateway's serial device or in the DC chip pool — park until the
virtual completion, wait for downstream queue space (backpressure), and
only then run the operator and let its sinks publish (completion half).
Late upstream results are simply *absent from the window* — the runtime
never waits on dependencies the way the DES does; that divergence is
part of the measured sim-to-real gap.
"""
from __future__ import annotations

import asyncio
from typing import Callable, List, Optional

from repro_torch.core.value import task_value
from repro_torch.online.fleet import Fleet
from repro_torch.pipeline.adapters import StageAdapter
from repro_torch.placement.plan import SITE_DC
from repro_torch.scenario.observe import epoch_of
from repro_torch.scenario.profiles import ServiceProfile
from repro_torch.serve.clock import VirtualClock
from repro_torch.serve.metrics import ServeTelemetry
from repro_torch.serve.router import PlacementRouter
from repro_torch.serve.shaper import UplinkShaper

_EPS = 1e-6


class FarmDriver:
    """Advances one farm in drive-step increments at producer priority."""

    def __init__(self, farm, clock: VirtualClock, horizon_s: float,
                 step_s: float):
        self.farm = farm
        self.clock = clock
        self.horizon_s = horizon_s
        self.step_s = step_s

    async def run(self) -> None:
        t = 0.0
        while t < self.horizon_s - _EPS:
            t = min(t + self.step_s, self.horizon_s)
            await self.clock.sleep_until(t, prio=0)
            self.farm.advance_to(t)


class ServiceStage:
    """One serial operator instance serving one service's fire grid."""

    def __init__(self, adapter: StageAdapter, rank: int,
                 prof: ServiceProfile, clock: VirtualClock,
                 router: PlacementRouter, shaper: UplinkShaper,
                 telemetry: ServeTelemetry, fleet: Fleet,
                 bounds, horizon_s: float,
                 origin_site: Callable[[Optional[str], str, int], str],
                 result_site: str, dl_user: float,
                 stage_capacity: Optional[int] = None,
                 shed_after_s: Optional[float] = None):
        self.adapter = adapter
        self.name = adapter.name
        self.prio = rank + 1            # producers run first at an instant
        self.prof = prof
        self.vspec = prof.slo.value_spec()
        self.clock = clock
        self.router = router
        self.shaper = shaper
        self.telemetry = telemetry
        self.fleet = fleet
        self.bounds = bounds
        self.horizon_s = horizon_s
        self.origin_site = origin_site
        self.result_site = result_site
        self.dl_user = dl_user
        self.stage_capacity = stage_capacity
        self.shed_after_s = shed_after_s
        self.consumers: List["ServiceStage"] = []   # downstream stages
        self.finished = False       # fire grid exhausted; never fetches again
        self._bp_waiters: List[asyncio.Future] = []
        self.fires_dispatched = 0

    # ------------------------------------------------------------- plumbing
    def notify_fetch(self) -> None:
        """Wake publishers parked on this stage's input backlog."""
        waiters, self._bp_waiters = self._bp_waiters, []
        for fut in waiters:
            self.clock.fire(fut)

    async def _backpressure(self) -> None:
        """Publish-side bound: park until every downstream stage's input
        backlog is under the per-stage queue capacity. A consumer whose
        fire grid is exhausted never fetches again, so it stops counting
        (holding the publisher for it would deadlock the drain); its
        leftover records land as broker backlog the ledger accounts."""
        if self.stage_capacity is None:
            return
        while True:
            blocked = next((c for c in self.consumers
                            if not c.finished
                            and c.adapter.backlog() >= self.stage_capacity),
                           None)
            if blocked is None:
                return
            fut = self.clock.event()
            blocked._bp_waiters.append(fut)
            await self.clock.wait(fut)

    # ------------------------------------------------------------ fire path
    async def run(self) -> None:
        try:
            for idx, ts in enumerate(
                    self.adapter.fire_times(self.horizon_s)):
                await self.clock.sleep_until(ts, self.prio)
                await self._one_fire(idx, ts)
        finally:
            self.finished = True
            self.notify_fetch()     # release publishers parked on us

    async def _one_fire(self, idx: int, ts: float) -> None:
        # ---- dispatch half: snapshot the window as delivered ------------
        backlog = self.adapter.backlog()
        self.adapter.fetch()
        self.notify_fetch()
        n_window = self.adapter.peek_window(ts)
        n_new, origins = self.adapter.preview_cover(ts)
        epoch = epoch_of(self.bounds, ts)
        p = self.router.placement(self.name, epoch)
        self.telemetry.on_dispatch(self.name, idx, p.site, n_window, n_new,
                                   backlog)
        self.fires_dispatched += 1

        base = max(ts, self.router.stall_ready(self.name, ts),
                   self.clock.now)
        if (self.shed_after_s is not None
                and base - ts > self.shed_after_s):
            # load shedding: the wait already burned the latency budget;
            # skip the fire, let the records roll into the next window
            self.telemetry.on_shed(self.name, idx)
            return
        arrival = self.shaper.ship_inputs(
            origins, lambda o: self.origin_site(o, self.name, epoch),
            p.site, base)

        # ---- placed execution -------------------------------------------
        if p.site == SITE_DC:
            dur, energy = self.router.dc_cost(self.name, n_window, p)
            await self.clock.sleep_until(arrival, self.prio)
            start = self.router.dc.acquire(max(arrival, self.clock.now),
                                           p.chips, dur)
            ready_out = start + dur
            await self.clock.sleep_until(ready_out, self.prio)
            self.shaper.result_downlink(self.result_site)
            lat = ready_out + self.dl_user - ts
        else:
            await self.clock.sleep_until(arrival, self.prio)
            ex = self.fleet.site(p.site).execute_fire(
                max(arrival, self.clock.now), n_window,
                self.prof.flops_per_record)
            ready_out, energy = ex.finish, ex.energy_j
            await self.clock.sleep_until(ready_out, self.prio)
            lat = ready_out - ts
        value = task_value(self.vspec, lat, energy)

        # ---- completion half: publish when results reach consumers ------
        pub_at = ready_out
        arr_cache = {}
        for cons in self.consumers:
            ep_now = min(epoch_of(self.bounds, ready_out),
                         len(self.router.plans) - 1)
            dst = self.router.site(cons.name, ep_now)
            if dst not in arr_cache:
                arr_cache[dst] = self.shaper.result_arrival(p.site, dst,
                                                            ready_out)
            pub_at = max(pub_at, arr_cache[dst])
        await self.clock.sleep_until(pub_at, self.prio)
        await self._backpressure()
        self.adapter.fire(ts)       # the real operator + sink publishes
        self.telemetry.on_done(self.name, idx, value, lat, energy)
