"""Compile a :class:`ChaosSpec` into a queryable fault timeline.

The timeline is the *ground truth* the engine injects physically:
per-site crash windows (device + link dead), partition windows (link
dead, device alive) and straggle windows (serialization × factor).
Random crashes are sampled through the step-keyed
:class:`~repro_torch.checkpoint.failure.FailureInjector` keyed by
(site, epoch), so two compilations of the same spec over the same
epoch grid produce the identical schedule — replay-stable chaos.

Controllers never see this object. They see only what the fleet
realizes: ``down_now`` flips once a crash fires, ``partitioned_now``
once a partition fires, and straggles surface as inflated per-transfer
link seconds in ``link_secs_window``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.checkpoint.failure import FailureInjector
from repro_torch.chaos.spec import ChaosSpec

_EPS = 1e-9
# step-key stride separating sites in the FailureInjector key space
_SITE_STRIDE = 100_003


@dataclasses.dataclass(frozen=True)
class FaultObservation:
    """What a controller is shown at a mid-epoch chaos boundary: the
    *realized* world at time ``t`` — never the schedule itself."""
    t: float
    epoch: int
    down_now: Dict[str, bool]
    partitioned_now: Dict[str, bool]
    straggle_now: Dict[str, float]
    events: List[Dict] = dataclasses.field(default_factory=list)


class ChaosTimeline:
    """Per-site fault windows compiled from a ChaosSpec."""

    def __init__(self, crash: Dict[str, List[Tuple[float, float]]],
                 partition: Dict[str, List[Tuple[float, float]]],
                 straggle: Dict[str, List[Tuple[float, float, float]]]):
        self._crash = {s: sorted(w) for s, w in crash.items() if w}
        self._partition = {s: sorted(w) for s, w in partition.items() if w}
        self._straggle = {s: sorted(w) for s, w in straggle.items() if w}

    @classmethod
    def compile(cls, spec: ChaosSpec, site_names: Sequence[str],
                horizon_s: float,
                epochs: Sequence[Tuple[float, float]]) -> "ChaosTimeline":
        crash: Dict[str, List[Tuple[float, float]]] = {}
        partition: Dict[str, List[Tuple[float, float]]] = {}
        straggle: Dict[str, List[Tuple[float, float, float]]] = {}
        for c in spec.crashes:
            crash.setdefault(c.site, []).append((c.at_s, c.recover_s))
        for p in spec.partitions:
            partition.setdefault(p.site, []).append((p.at_s, p.heal_s))
        for s in spec.straggles:
            straggle.setdefault(s.site, []).append(
                (s.at_s, s.until_s, s.factor))
        if spec.p_crash > 0.0:
            # deterministic random crashes: one step-keyed coin per
            # (site, epoch); onset mid-epoch (unforecastable by
            # construction), recovery one epoch later
            inj = FailureInjector(p_fail=spec.p_crash, seed=spec.seed)
            for si, site in enumerate(sorted(site_names)):
                for k, (t0, t1) in enumerate(epochs):
                    if inj.should_fail(si * _SITE_STRIDE + k):
                        mid = 0.5 * (t0 + t1)
                        crash.setdefault(site, []).append(
                            (mid, min(horizon_s, t1 + (t1 - t0))))
        return cls(crash, partition, straggle)

    # ------------------------------------------------------------- per-site
    def crash_windows(self, site: str) -> Tuple[Tuple[float, float], ...]:
        return tuple(self._crash.get(site, ()))

    def partition_windows(self, site: str) -> Tuple[Tuple[float, float], ...]:
        return tuple(self._partition.get(site, ()))

    def straggle_windows(self, site: str) \
            -> Tuple[Tuple[float, float, float], ...]:
        return tuple(self._straggle.get(site, ()))

    # -------------------------------------------------------------- queries
    def crashed(self, site: str, t: float) -> bool:
        return any(lo <= t < hi for lo, hi in self._crash.get(site, ()))

    def partitioned(self, site: str, t: float) -> bool:
        return any(lo <= t < hi for lo, hi in self._partition.get(site, ()))

    def straggle_factor(self, site: str, t: float) -> float:
        f = 1.0
        for lo, hi, fac in self._straggle.get(site, ()):
            if lo <= t < hi:
                f = max(f, fac)
        return f

    def boundaries(self, t0: float, t1: float) -> List[float]:
        """Fault onset/heal instants strictly inside (t0, t1) — the
        engine cuts the epoch here so a controller can react mid-epoch."""
        pts = set()
        for wins in self._crash.values():
            for lo, hi in wins:
                pts.update((lo, hi))
        for wins in self._partition.values():
            for lo, hi in wins:
                pts.update((lo, hi))
        for wins in self._straggle.values():
            for lo, hi, _ in wins:
                pts.update((lo, hi))
        return sorted(p for p in pts if t0 + _EPS < p < t1 - _EPS)

    def events_at(self, t: float) -> List[Dict]:
        """Faults whose onset or heal coincides with `t` (the trigger a
        FaultObservation carries, for telemetry — sites only, no
        future schedule)."""
        out = []
        for kind, table in (("crash", self._crash),
                            ("partition", self._partition)):
            for site, wins in sorted(table.items()):
                for lo, hi in wins:
                    if abs(lo - t) < _EPS:
                        out.append({"kind": kind, "site": site})
                    elif abs(hi - t) < _EPS:
                        out.append({"kind": f"{kind}-heal", "site": site})
        for site, wins in sorted(self._straggle.items()):
            for lo, hi, fac in wins:
                if abs(lo - t) < _EPS:
                    out.append({"kind": "straggle", "site": site})
                elif abs(hi - t) < _EPS:
                    out.append({"kind": "straggle-heal", "site": site})
        return out

    def any_faults(self) -> bool:
        return bool(self._crash or self._partition or self._straggle)
