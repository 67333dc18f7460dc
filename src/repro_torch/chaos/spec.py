"""Declarative fault injection: the chaos layer of a scenario.

A :class:`ChaosSpec` rides on :class:`~repro_torch.scenario.spec.ScenarioSpec`
and declares the *unplanned* part of the world: site crashes, network
partitions and straggling links. Unlike the spec's ``outages`` (which
are forecastable maintenance windows every controller may read through
``down_oracle``), chaos events are invisible to planning — the engine
realizes them physically (fires defer, transfers stall, links slow) and
the controller only observes them through realized telemetry after they
fire (``down_now`` / ``partitioned_now`` / ``link_secs_window``).

The taxonomy:

==============  ==========================  ===========================
fault           device                      link
==============  ==========================  ===========================
crash           dead until recovery         dead until recovery
partition       alive (local exec works)    dead until heal
straggle        alive                       serialization × ``factor``
==============  ==========================  ===========================

The spec also fixes the *migration semantics* the engine applies when a
controller re-places mid-epoch around a fault:

* ``migration="cold"`` — drop in-flight state; the destination restores
  the last checkpoint (``checkpoint_every`` fires between saves, the
  :class:`~repro_torch.checkpoint.ckpt.CheckpointManager` ``save_every``
  cadence) and replays the records covered since. Checkpoint size
  (``checkpoint_bytes_per_record``), not raw state bytes, crosses the
  uplink; a dead source is restored from the DC replica instead.
* ``migration="live"`` — pre-copy the full operator state while the
  source keeps serving, then stall only for the dirty delta + warm-up.
  A dead source forces a cold restore (there is nothing to pre-copy).

``ledger_mode`` picks the delivery guarantee of a cold cutover:
``exactly_once`` drains the source's in-flight work before switching
(slower cutover, zero duplicates); ``at_least_once`` cuts over
immediately and the replayed records are processed twice — the ledger
accounts them exactly in ``duplicates``, never silently lost.

``p_crash``/``seed`` sample additional random crashes through the
step-keyed :class:`~repro_torch.checkpoint.failure.FailureInjector`, so a
chaos schedule is deterministic and replay-stable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

MIGRATION_MODES = ("cold", "live")
LEDGER_MODES = ("exactly_once", "at_least_once")


@dataclasses.dataclass(frozen=True)
class SiteCrash:
    """Unplanned site crash: device and link dead until ``recover_s``."""
    site: str
    at_s: float
    recover_s: float


@dataclasses.dataclass(frozen=True)
class Partition:
    """Network partition: the site's link is dead until ``heal_s`` but
    the device keeps executing — local work proceeds, transfers stall."""
    site: str
    at_s: float
    heal_s: float


@dataclasses.dataclass(frozen=True)
class LinkStraggle:
    """Straggling link: every serialization through the site's uplink
    is inflated by ``factor`` while the window is active."""
    site: str
    at_s: float
    until_s: float
    factor: float = 4.0


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """The whole fault schedule plus the migration/ledger semantics."""
    crashes: Tuple[SiteCrash, ...] = ()
    partitions: Tuple[Partition, ...] = ()
    straggles: Tuple[LinkStraggle, ...] = ()
    migration: str = "cold"             # cold | live
    ledger_mode: str = "exactly_once"   # exactly_once | at_least_once
    # fires between checkpoints (CheckpointManager.save_every semantics:
    # a checkpoint exists at fire counts 0, N, 2N, ...)
    checkpoint_every: int = 4
    # wire footprint of one checkpointed record (compacted partial
    # aggregates — smaller than the live operator state)
    checkpoint_bytes_per_record: float = 8.0
    p_crash: float = 0.0                # random per-(site, epoch) crash
    seed: int = 0

    def validate(self, site_names: Sequence[str]) -> None:
        known = set(site_names)
        if self.migration not in MIGRATION_MODES:
            raise ValueError(f"migration {self.migration!r} not in "
                             f"{MIGRATION_MODES}")
        if self.ledger_mode not in LEDGER_MODES:
            raise ValueError(f"ledger_mode {self.ledger_mode!r} not in "
                             f"{LEDGER_MODES}")
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        for c in self.crashes:
            if c.site not in known:
                raise ValueError(f"crash for unknown site {c.site!r}")
            if c.recover_s <= c.at_s:
                raise ValueError(f"crash on {c.site!r}: empty window")
        for p in self.partitions:
            if p.site not in known:
                raise ValueError(f"partition for unknown site {p.site!r}")
            if p.heal_s <= p.at_s:
                raise ValueError(f"partition on {p.site!r}: empty window")
        for s in self.straggles:
            if s.site not in known:
                raise ValueError(f"straggle for unknown site {s.site!r}")
            if s.until_s <= s.at_s:
                raise ValueError(f"straggle on {s.site!r}: empty window")
            if s.factor < 1.0:
                raise ValueError(f"straggle on {s.site!r}: factor < 1")

    # ------------------------------------------------------------------ JSON
    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "ChaosSpec":
        return cls(
            crashes=tuple(SiteCrash(**c) for c in d.get("crashes", ())),
            partitions=tuple(Partition(**p)
                             for p in d.get("partitions", ())),
            straggles=tuple(LinkStraggle(**s)
                            for s in d.get("straggles", ())),
            migration=d.get("migration", "cold"),
            ledger_mode=d.get("ledger_mode", "exactly_once"),
            checkpoint_every=d.get("checkpoint_every", 4),
            checkpoint_bytes_per_record=d.get(
                "checkpoint_bytes_per_record", 8.0),
            p_crash=d.get("p_crash", 0.0),
            seed=d.get("seed", 0))
