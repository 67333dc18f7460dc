"""Live vs cold migration semantics for mid-epoch re-placement.

The legacy epoch-boundary path (:func:`repro_torch.core.elastic.plan_replacement`)
charges a single analytic cost: raw state bytes over the uplink plus a
warm-up stall. Under chaos that model is wrong twice over — a crashed
source cannot ship anything, and real systems do not ship raw operator
state. This module implements the checkpoint-aware semantics:

**cold** — drop in-flight state. The destination restores the newest
checkpoint (cadence: every ``checkpoint_every`` fires, the
``CheckpointManager.save_every`` policy) and *replays* the records the
source covered since that checkpoint. Checkpoint bytes — not raw state
bytes — cross the uplink. If the source site is dead (crashed or
partitioned) the checkpoint is fetched from the DC replica instead; if
the destination is where the service's input records originate, nothing
crosses the network at all (the local record log is replayed).

**live** — pre-copy the full operator state while the source keeps
serving, then stall only for the dirty delta (records that arrived
during the pre-copy, re-shipped) plus warm-up. A dead source forces a
cold restore — there is nothing left to pre-copy.

**ledger modes** — ``exactly_once`` drains the source's in-flight work
before cutover (the drain time is added to the stall; nothing is
double-processed). ``at_least_once`` cuts over immediately: the replayed
records are processed twice, and every one of them is accounted in the
migration's ``duplicates`` — duplicates are counted, never silently
lost.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping

from repro_torch.chaos.spec import ChaosSpec

SERVICE_WARMUP_S = 2.0


@dataclasses.dataclass
class ChaosMigration:
    """One service moved mid-epoch, with the full cost decomposition."""
    service: str
    src: str
    dst: str
    kind: str                 # "live" | "cold" | "cold-restore" | "cold-local"
    wire_bytes: float         # what actually crossed the network
    transfer_s: float
    replay_records: int = 0
    replay_s: float = 0.0
    drain_s: float = 0.0
    warmup_s: float = SERVICE_WARMUP_S
    duplicates: int = 0       # replayed records double-processed

    @property
    def stall_s(self) -> float:
        return self.transfer_s + self.replay_s + self.drain_s + self.warmup_s

    def digest(self) -> Dict:
        return {"service": self.service, "src": self.src, "dst": self.dst,
                "kind": self.kind, "wire_bytes": round(self.wire_bytes, 3),
                "transfer_s": round(self.transfer_s, 6),
                "replay_records": self.replay_records,
                "replay_s": round(self.replay_s, 6),
                "drain_s": round(self.drain_s, 6),
                "duplicates": self.duplicates,
                "stall_s": round(self.stall_s, 6)}


def plan_chaos_migrations(
        chaos: ChaosSpec,
        old: Mapping[str, object], new: Mapping[str, object],
        t: float, *,
        src_dead: Callable[[str], bool],
        ship: Callable[[str, str, float, float], float],
        state_bytes: Callable[[str], float],
        ckpt_bytes: Callable[[str], float],
        replay_records: Callable[[str], int],
        replay_time: Callable[[str, int, str], float],
        rate_rps: Callable[[str], float],
        drain_s: Callable[[str], float],
        dc_site: str,
        local_origin: Callable[[str, str], bool],
        warmup_s: float = SERVICE_WARMUP_S,
        charge: bool = True) -> List[ChaosMigration]:
    """Plan the migrations taking `old` assignments to `new` at time `t`.

    `ship(src, dst, nbytes, t) -> arrival_ts` charges the real FIFO
    (pass a no-op arrival when `charge` is false — screening). All other
    callables are keyed by service; `local_origin(svc, dst)` is true when
    the service's input records originate at `dst` (replay needs no
    network). `src_dead(site)` is the realized crash/partition state of
    a site's *link* at `t`.
    """
    migs: List[ChaosMigration] = []
    exactly_once = chaos.ledger_mode == "exactly_once"
    for svc in sorted(new):
        asg_new = new[svc]
        asg_old = old.get(svc)
        if asg_old is None or asg_old.site == asg_new.site:
            continue
        src, dst = asg_old.site, asg_new.site
        dead = src_dead(src)
        live = chaos.migration == "live" and not dead

        if live:
            nbytes = state_bytes(svc)
            arrive = ship(src, dst, nbytes, t) if charge else t
            pre_copy = max(0.0, arrive - t)
            # dirty delta: records that landed during the pre-copy must
            # be re-shipped before cutover; bounded by the full state
            dirty = min(nbytes,
                        rate_rps(svc) * pre_copy
                        * chaos.checkpoint_bytes_per_record)
            frac = dirty / nbytes if nbytes > 0 else 0.0
            m = ChaosMigration(
                service=svc, src=src, dst=dst, kind="live",
                wire_bytes=nbytes + dirty,
                transfer_s=pre_copy * frac,   # only the delta stalls
                drain_s=drain_s(svc) if exactly_once else 0.0,
                warmup_s=warmup_s)
            migs.append(m)
            continue

        # cold path: restore the newest checkpoint, replay the gap
        n_replay = replay_records(svc)
        if local_origin(svc, dst):
            # the records live where we are going — replay the local log
            kind, nbytes, arrive = "cold-local", 0.0, t
        elif dead:
            # source is unreachable: fetch the checkpoint replica
            # that the DC keeps (every save crosses the uplink anyway)
            kind = "cold-restore"
            nbytes = ckpt_bytes(svc)
            arrive = ship(dc_site, dst, nbytes, t) if charge else t
        else:
            kind = "cold"
            nbytes = ckpt_bytes(svc)
            arrive = ship(src, dst, nbytes, t) if charge else t
        m = ChaosMigration(
            service=svc, src=src, dst=dst, kind=kind,
            wire_bytes=nbytes,
            transfer_s=max(0.0, arrive - t),
            replay_records=n_replay,
            replay_s=replay_time(svc, n_replay, dst) if n_replay else 0.0,
            # a dead source has nothing to drain; exactly-once dedups
            # the replay instead of double-counting it
            drain_s=drain_s(svc) if (exactly_once and not dead) else 0.0,
            warmup_s=warmup_s,
            duplicates=0 if exactly_once else n_replay)
        migs.append(m)
    return migs
