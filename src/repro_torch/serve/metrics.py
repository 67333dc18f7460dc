"""Measured telemetry for the serving runtime.

The runtime must feed the *same* consumers the engine feeds — the
controller's :class:`~repro_torch.scenario.observe.EpochObservation` and the
calibration loop's realized-residual schema — but from measurement, not
simulation:

  rates_window      newly covered records/s per completed epoch, summed
                    at fire *dispatch* (so a boundary snapshot includes
                    fires whose execution is still in flight)
  realized_window   per-service {vos, completed, dropped, inflight,
                    lat_mean_s} per completed epoch, frozen at the first
                    boundary after the epoch (identical freezing rule to
                    the engine's, so the calibration loop sees one
                    schema from either source)

The fire grid is precomputed from each service's slide — the runtime
knows every fire it will ever dispatch — so an epoch snapshot can count
not-yet-dispatched fires (a stage lagging behind its schedule) as
``inflight`` instead of silently missing them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.scenario.observe import epoch_of

_EPS = 1e-9


@dataclasses.dataclass
class StageFire:
    """One scheduled fire of one service, updated as it moves through
    the serving lifecycle: scheduled -> dispatched -> done | shed."""
    svc: str
    idx: int
    ts: float
    epoch: int
    state: str = "scheduled"
    site: str = ""                   # routing site at dispatch (e.g. "dc")
    n_window: int = 0
    n_new: int = 0
    backlog: int = 0                 # input backlog observed at dispatch
    value: float = 0.0
    lat_s: float = float("nan")
    energy_j: float = 0.0

    @property
    def done(self) -> bool:
        return self.state == "done"

    @property
    def shed(self) -> bool:
        return self.state == "shed"


class ServeTelemetry:
    def __init__(self, order: Sequence[str],
                 slides: Dict[str, float],
                 bounds: Sequence[Tuple[float, float]],
                 horizon_s: float):
        self.order = list(order)
        self.bounds = list(bounds)
        self.fires: Dict[str, List[StageFire]] = {}
        for svc in self.order:
            grid: List[StageFire] = []
            t = slides[svc]
            while t <= horizon_s:       # same accumulation as run_until
                grid.append(StageFire(svc=svc, idx=len(grid), ts=t,
                                      epoch=epoch_of(bounds, t)))
                t += slides[svc]
            self.fires[svc] = grid
        self._realized: List[Dict[str, Dict]] = []

    # ------------------------------------------------------------ lifecycle
    def on_dispatch(self, svc: str, idx: int, site: str,
                    n_window: int, n_new: int, backlog: int = 0) -> None:
        f = self.fires[svc][idx]
        f.state, f.site = "dispatched", site
        f.n_window, f.n_new, f.backlog = n_window, n_new, backlog

    def on_done(self, svc: str, idx: int, value: float, lat_s: float,
                energy_j: float) -> None:
        f = self.fires[svc][idx]
        f.state, f.value, f.lat_s, f.energy_j = "done", value, lat_s, energy_j

    def on_shed(self, svc: str, idx: int) -> None:
        self.fires[svc][idx].state = "shed"

    # ----------------------------------------------------------- per epoch
    def measured_rates(self, epoch: int) -> Dict[str, float]:
        """Covered-records/s per service over one completed epoch, from
        dispatch-time measurements. The live analogue of the engine's
        drive-derived ``true_epoch_rates`` — minus clairvoyance: fires a
        lagging stage has not dispatched yet contribute nothing."""
        t0, t1 = self.bounds[epoch]
        dur = max(t1 - t0, _EPS)
        return {svc: sum(f.n_new for f in grid
                         if f.epoch == epoch and f.state != "scheduled")
                / dur
                for svc, grid in self.fires.items()}

    def residuals(self, epoch: int) -> Dict[str, Dict]:
        """Per-service realized residuals of one epoch as measured now —
        same keys and rounding as the engine's epoch residuals."""
        out = {s: {"vos": 0.0, "completed": 0, "dropped": 0,
                   "inflight": 0, "lat_mean_s": float("nan"),
                   "_lat_sum": 0.0}
               for s in self.order}
        for svc, grid in self.fires.items():
            d = out[svc]
            for f in grid:
                if f.epoch != epoch:
                    continue
                if f.done:
                    d["completed"] += 1
                    d["vos"] += f.value
                    d["_lat_sum"] += f.lat_s
                elif f.shed:
                    d["dropped"] += 1
                else:
                    d["inflight"] += 1
        for d in out.values():
            if d["completed"]:
                d["lat_mean_s"] = d["_lat_sum"] / d["completed"]
            del d["_lat_sum"]
            d["vos"] = round(d["vos"], 6)
        return out

    def realized_upto(self, upto_epoch: int) -> List[Dict[str, Dict]]:
        """Frozen residual snapshots for every epoch < ``upto`` —
        materialized exactly once at the first boundary after each epoch
        completes (the engine's freezing rule), so the calibration loop
        reads a one-pass deterministic feed."""
        while len(self._realized) < upto_epoch:
            self._realized.append(self.residuals(len(self._realized)))
        return [{s: dict(d) for s, d in per.items()}
                for per in self._realized[:upto_epoch]]
