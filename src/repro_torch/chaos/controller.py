"""Chaos-aware re-placement: react to faults the plan never foresaw.

:class:`ChaosController` is the honest :class:`~repro_torch.online.controller.
OnlineController` plus two abilities, both fed exclusively by *realized*
telemetry (it reads neither the chaos schedule nor the oracle fields):

1. **Telemetry-steered forecasting.** Partitions observed at an epoch
   boundary (``partitioned_now``) mark links dead in the forecast model;
   per-transfer uplink seconds (``link_secs_window``) feed the
   :class:`~repro_torch.runtime.straggler.StragglerMonitor`, and a flagged
   site's last-to-baseline serialization ratio inflates its
   serialization terms — the plan search routes around sick links.

2. **Emergency mid-epoch re-planning.** The engine cuts the epoch at
   each realized fault boundary and calls :meth:`decide_fault`. When the
   live plan is hit (hosting site crashed, feeding link partitioned, or
   simply beatable under the post-fault world), the controller re-runs
   the placement search against the updated model and returns the new
   plan — the engine applies checkpoint-aware migrations and adopts it
   immediately instead of waiting for the boundary.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.online.controller import ForecastModel, OnlineController
from repro_torch.placement.plan import PlacementPlan
from repro_torch.placement.search import Evaluator, search_placement
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.scenario.observe import BridgeInfo, EpochObservation
from repro_torch.chaos.inject import FaultObservation


class ChaosController(OnlineController):
    """Online controller hardened for unforecastable faults."""
    label = "chaos"

    def __init__(self, *args, replan_margin: float = 0.0,
                 straggle_threshold: float = 2.0,
                 straggle_window: int = 8, **kw):
        super().__init__(*args, **kw)
        self.label = "chaos" + ("-cal" if self.calibrate else "")
        self.replan_margin = float(replan_margin)
        self.straggle_threshold = float(straggle_threshold)
        self.straggle_window = int(straggle_window)

    def bind(self, info: BridgeInfo) -> None:
        super().bind(info)
        self._site_order: List[str] = list(info.fleet.site_names)
        self._monitor = StragglerMonitor(
            len(self._site_order), window=self.straggle_window,
            slack=self.straggle_threshold, min_samples=2)
        # per-site clean-serialization floor and freshest sample: the
        # slowdown estimate is each link's own last/baseline ratio, so
        # it survives the window median drifting up when every active
        # link straggles at once (the monitor's flags stay the
        # persistence gate; the ratio stays the magnitude)
        self._link_base: Dict[str, float] = {}
        self._link_last: Dict[str, float] = {}
        self._slowdown: Dict[str, float] = {}
        self._partitioned: Dict[str, bool] = {}
        self._last_rates: Optional[Dict[str, float]] = None
        self._seen_link_epochs = 0
        self.fault_log: List[Dict] = []

    # ----------------------------------------------------- model steering
    def _make_model(self, rates, down, corr) -> ForecastModel:
        self._last_rates = dict(rates)
        return ForecastModel(self.info, rates, down, corrections=corr,
                             link_slowdown=self._slowdown,
                             link_dead=self._partitioned)

    def _model_fingerprint(self, rates, down, corr) -> Tuple:
        base = super()._model_fingerprint(rates, down, corr)
        return base + (
            tuple(sorted((s, round(f, 6))
                         for s, f in self._slowdown.items())),
            tuple(sorted(s for s, v in self._partitioned.items() if v)))

    def _absorb_link_telemetry(self, obs: EpochObservation) -> None:
        """Feed each newly completed epoch's per-site mean serialization
        seconds per transfer into the straggler monitor; flagged sites
        get a slowdown estimate the forecast model plans around."""
        window = getattr(obs, "link_secs_window", None) or []
        for k in range(self._seen_link_epochs, len(window)):
            row = [window[k].get(s, 0.0) for s in self._site_order]
            for s, t in zip(self._site_order, row):
                if t > 0.0:
                    self._link_last[s] = t
                    self._link_base[s] = min(
                        t, self._link_base.get(s, t))
            active = sorted(t for t in row if t > 0.0)
            if not active:
                continue
            # idle sites contribute their own last-known seconds (so a
            # lone straggling link stays an outlier against its stable
            # peers); a never-observed site falls back to the median of
            # the active ones so it never reads as artificially fast
            med = active[len(active) // 2]
            self._monitor.record_step(
                k, [t if t > 0.0
                    else self._link_last.get(s, med)
                    for s, t in zip(self._site_order, row)])
        self._seen_link_epochs = len(window)
        self._slowdown = {}
        for h in self._monitor.persistent_stragglers(threshold=2):
            s = self._site_order[h]
            base = self._link_base.get(s, 0.0)
            if base <= 0.0:
                continue
            f = self._link_last.get(s, base) / base
            if f >= self.straggle_threshold:
                self._slowdown[s] = round(f, 3)

    # --------------------------------------------------------- epoch path
    def decide(self, obs: EpochObservation) -> PlacementPlan:
        self._partitioned = {
            s: bool(v)
            for s, v in (getattr(obs, "partitioned_now", None) or {}).items()
            if v}
        self._absorb_link_telemetry(obs)
        return super().decide(obs)

    # ------------------------------------------------------ mid-epoch path
    def _plan_is_hit(self, fobs: FaultObservation) -> bool:
        """Does any event touch a site the live plan depends on — as a
        host, or as the farm site feeding a hosted service? Heal events
        count too: capacity coming back mid-epoch is worth re-planning
        for."""
        if self.current is None:
            return True
        if not fobs.events:
            return False
        touched = {e["site"] for e in fobs.events}
        hosting = {self.current.site(s) for s in self.info.topology}
        feeding = {self.info.fleet.farm_site(self.info.services[s].queue)
                   for s in self.info.topology}
        if touched & (hosting | feeding):
            return True
        # a heal re-opens sites the plan might want back
        return any(e["kind"].endswith("-heal") for e in fobs.events)

    def decide_fault(self, fobs: FaultObservation
                     ) -> Optional[PlacementPlan]:
        """Emergency re-plan at a realized fault boundary. Returns the
        new plan to adopt mid-epoch, or None to ride out the epoch."""
        self._partitioned = {s: True for s, v in fobs.partitioned_now.items()
                             if v}
        down = {s: bool(v) for s, v in fobs.down_now.items()}
        rates = dict(self._last_rates) if self._last_rates else (
            dict(self.prior_rates) if self.prior_rates
            else {s: 1.0 for s in self.info.topology})
        corr = (self.calibration.corrections()
                if self.calibration is not None else None)
        if not self._plan_is_hit(fobs):
            return None
        model = self._make_model(rates, down, corr)
        cur = model.run(self.current) if self.current is not None else None
        fp = self._model_fingerprint(rates, down, corr) \
            + ("fault", round(fobs.t, 6))
        up = tuple(s for s in self.info.fleet.site_names if not down.get(s))
        ev = Evaluator(model, cache=self._xcache, key_prefix=fp)
        sr = search_placement(model, self.chips_options, self.dvfs_options,
                              seed=self.seed,
                              edge_sites=up or self.info.fleet.site_names,
                              warm_start=self.current, evaluator=ev)
        new = model.run(sr.plan)
        entry = {"t": round(fobs.t, 3), "epoch": fobs.epoch,
                 "events": list(fobs.events),
                 "cur_vos": (round(cur.vos, 4)
                             if cur is not None and cur.feasible else None),
                 "new_vos": round(new.vos, 4) if new.feasible else None,
                 "switched": False}
        must = cur is None or not cur.feasible
        better = (new.feasible and cur is not None and cur.feasible
                  and new.vos > cur.vos * (1.0 + self.replan_margin) + 1e-9)
        if new.feasible and (must or better) and (
                self.current is None
                or sr.plan.key() != self.current.key()):
            self.current = sr.plan
            entry["switched"] = True
            self.fault_log.append(entry)
            return sr.plan
        self.fault_log.append(entry)
        return None
