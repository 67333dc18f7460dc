"""Shared observation protocol: the DES engine and the live serving
runtime as interchangeable observation sources.

A *source* executes one scenario under a controller-produced plan
schedule and, at every epoch boundary, hands the controller one
:class:`EpochObservation`. Controllers are source-agnostic: the same
``bind(BridgeInfo)`` / ``decide(EpochObservation)`` contract drives both
the simulated world (:class:`~repro_torch.scenario.engine.ScenarioEngine`,
where ``realized_window`` carries *co-simulated* residuals) and the real
one (:class:`~repro_torch.serve.runtime.ServeRuntime`, where the same fields
carry *measured* residuals). The calibration loop
(:mod:`repro_torch.scenario.feedback`) trains on either feed unchanged —
that is the sim-to-real closure the JITA-4DS follow-up describes.

``repro_torch.scenario.engine`` and ``repro_torch.online`` re-export these
classes, as the JAX package's modules do. The epoch arithmetic and the
per-epoch telemetry merge are shared here so both sources produce
byte-compatible epoch records.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

try:                                     # py3.8+: typing.Protocol
    from typing import Protocol, runtime_checkable
except ImportError:                      # pragma: no cover
    Protocol, runtime_checkable = object, (lambda c: c)

from repro_torch.core.costmodel import CostModel
from repro_torch.online.fleet import FleetSpec
from repro_torch.scenario.profiles import ServiceProfile

_EPS = 1e-9

#: keys every per-service ``realized_window`` entry carries — the
#: measurement schema :meth:`repro_torch.scenario.feedback.CalibrationLoop.observe`
#: trains on (both sources must emit exactly these).
REALIZED_KEYS = ("vos", "completed", "dropped", "inflight", "lat_mean_s")


@dataclasses.dataclass(frozen=True)
class ServiceInfo:
    """Static per-service facts a controller may plan with."""
    queue: str
    slide_s: float
    width_s: float
    buffer_budget: int


@dataclasses.dataclass(frozen=True)
class BridgeInfo:
    """Snapshot handed to controllers at run start (``controller.bind``)."""
    topology: Dict[str, List[str]]
    profiles: Dict[str, ServiceProfile]
    fleet: FleetSpec
    services: Dict[str, ServiceInfo]
    cost: CostModel
    grid_chips: int
    epoch_s: float
    records_per_step: int
    outages: Dict[str, Tuple[Tuple[float, float], ...]]


@dataclasses.dataclass
class EpochObservation:
    """What a controller sees at an epoch boundary. ``*_oracle`` fields
    are ground truth about the *coming* epoch — only the clairvoyant
    baseline may read them; honest controllers plan from the observed
    past (``rates_window``) and the instantaneous site health. (A live
    runtime has no clairvoyance: its oracle fields fall back to the
    trailing measurement and the declared outage schedule.)

    ``realized_window`` is the source's realized per-service residual
    per *completed* epoch (oldest first): VoS earned so far, completed /
    dropped / still-inflight fire counts and the mean realized fire
    latency — the measurement a forecast-calibration loop
    (:mod:`repro_torch.scenario.feedback`) trains on. Like ``rates_window``
    it is strictly about the past, so honest controllers may read it.
    Each epoch's snapshot is *frozen* at the first boundary after the
    epoch completes: fires still in flight there stay counted
    ``inflight`` (their value is simply never attributed — a conscious
    under-measurement that keeps the feed one-pass and deterministic)."""
    epoch: int
    t0: float
    t1: float
    rates_window: List[Dict[str, float]]      # per completed epoch, oldest first
    down_now: Dict[str, bool]
    rates_oracle: Dict[str, float]
    down_oracle: Dict[str, bool]
    realized_window: List[Dict[str, Dict]] = dataclasses.field(
        default_factory=list)
    # realized chaos telemetry (strictly about the past / the instant):
    # which sites' links are partitioned right now (device up, link
    # dead — distinct from down_now), and per completed epoch the mean
    # uplink serialization seconds per transfer at each site (a
    # straggling link shows up here, and only here)
    partitioned_now: Dict[str, bool] = dataclasses.field(
        default_factory=dict)
    link_secs_window: List[Dict[str, float]] = dataclasses.field(
        default_factory=list)

    @property
    def rates_prev(self) -> Optional[Dict[str, float]]:
        return self.rates_window[-1] if self.rates_window else None


@runtime_checkable
class ObservationSource(Protocol):
    """What it takes to drive a controller: both
    :class:`~repro_torch.scenario.engine.ScenarioEngine` and
    :class:`~repro_torch.serve.runtime.ServeRuntime` satisfy this."""

    def info(self) -> BridgeInfo:
        """The static planning snapshot ``controller.bind`` receives."""

    def run(self, controller):
        """Execute the scenario under ``controller``'s plan schedule and
        return an :class:`~repro_torch.scenario.engine.EngineResult`."""


# ---------------------------------------------------------------------------
# Epoch arithmetic (one definition, two sources)
# ---------------------------------------------------------------------------
def epoch_bounds(horizon_s: float, epoch_s: Optional[float]
                 ) -> List[Tuple[float, float]]:
    """Epoch boundaries over the horizon; the last epoch absorbs any
    sub-epoch remainder (``epoch_s=None`` → one epoch)."""
    step = epoch_s or horizon_s
    bounds: List[Tuple[float, float]] = []
    t = 0.0
    while t < horizon_s - _EPS:
        t1 = min(t + step, horizon_s)
        if horizon_s - t1 < step * 0.5:
            t1 = horizon_s
        bounds.append((t, t1))
        t = t1
    return bounds


def epoch_of(bounds: Sequence[Tuple[float, float]], ts: float) -> int:
    """Index of the epoch containing ``ts`` (a fire exactly on a
    boundary belongs to the *later* epoch; past-horizon times clamp to
    the last)."""
    for k, (t0, t1) in enumerate(bounds):
        if ts < t1 or k == len(bounds) - 1:
            return k
    return len(bounds) - 1


# ---------------------------------------------------------------------------
# Per-epoch telemetry (byte-compatible between sources)
# ---------------------------------------------------------------------------
def attach_forecast(controller, epoch: int, meta: Dict) -> None:
    """Copy the controller's regret-telemetry entry for ``epoch`` into
    the epoch record, if the controller exposes one (controllers that
    score plans against a forecast append one per ``decide``)."""
    tel = getattr(controller, "telemetry", None)
    if tel and tel[-1].get("epoch") == epoch:
        meta["forecast"] = dict(tel[-1])


def merge_realized_vos(epoch_meta: List[Dict],
                       ep_vos: Sequence[float]) -> None:
    """Merge each epoch's realized VoS into its record and derive the
    calibration gap against the forecast the controller played.
    ``cosim_vos`` is the realized per-epoch VoS of the *source* — the
    co-simulated value under the engine, the measured value under the
    serve runtime (one key, so downstream consumers parse one schema)."""
    for k, meta in enumerate(epoch_meta):
        meta["vos"] = round(ep_vos[k], 4)
        fc = meta.get("forecast")
        if fc is not None and fc.get("chosen_vos") is not None:
            # calibration gap: what the forecast promised for the
            # played plan minus what the source realized this epoch
            fc["cosim_vos"] = round(ep_vos[k], 4)
            fc["calibration_gap"] = round(fc["chosen_vos"] - ep_vos[k], 4)
            if fc.get("chosen_vos_raw") is not None:
                # calibrated controllers also report the *raw*
                # (uncorrected) forecast of the played plan, so one
                # run carries its own calibrated-vs-raw comparison
                fc["calibration_gap_raw"] = round(
                    fc["chosen_vos_raw"] - ep_vos[k], 4)
