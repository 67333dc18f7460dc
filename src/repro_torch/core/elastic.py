"""Cross-VDC elastic reallocation (§4.2 Discussion).

The paper raises re-dividing the shared fixed pool across VDCs online,
without disturbing running applications. Here: a running job can be
checkpointed, its VDC released, and resumed on a different submesh —
`repro_torch.checkpoint` re-shards the state onto the new mesh. The policy below
decides *when* growing a starved high-value job is worth the migration
overhead, using the same VoS calculus as admission.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Optional, Tuple

from repro_torch.core.costmodel import CostModel
from repro_torch.core.tasks import Task
from repro_torch.core.value import task_value
from repro_torch.core.vdc import PodGrid, VDC

MIGRATION_OVERHEAD_S = 30.0  # checkpoint + re-shard + restart (modeled)

# Relocating a *stream operator* between sites is far lighter than
# re-sharding a training job: the operator's buffered window state is
# shipped, then the operator warms back up (re-subscribes, rebuilds its
# scheduler state) before it may fire again.
SERVICE_WARMUP_S = 2.0


@dataclasses.dataclass
class Migration:
    task: Task
    old_chips: int
    new_chips: int
    gain: float


def plan_regrow(running: List[Tuple[Task, VDC]], grid: PodGrid,
                cost: CostModel, now: float) -> Optional[Migration]:
    """Propose the single best grow-migration, if any yields VoS gain.

    A job migrates to a larger free tile when the value recovered by
    finishing earlier exceeds what the migration pause costs.
    """
    best: Optional[Migration] = None
    for task, vdc in running:
        done_frac = 0.0
        if task.start is not None and task.finish and task.finish > task.start:
            done_frac = min(1.0, (now - task.start)
                            / (task.finish - task.start))
        steps_left = max(1, int(task.steps * (1 - done_frac)))
        for chips in task.ttype.allowable_chips:
            if chips <= vdc.chips or chips - vdc.chips > grid.free_chips:
                continue
            t_old = cost.time_per_step(task.ttype.arch, task.ttype.shape,
                                       vdc.chips, vdc.dvfs_f)
            t_new = cost.time_per_step(task.ttype.arch, task.ttype.shape,
                                       chips, vdc.dvfs_f)
            finish_old = now + steps_left * t_old
            finish_new = now + MIGRATION_OVERHEAD_S + steps_left * t_new
            e_old = task.energy_j
            v_old = task_value(task.value, finish_old - task.arrival, e_old)
            v_new = task_value(task.value, finish_new - task.arrival, e_old)
            gain = v_new - v_old
            if gain > 0 and (best is None or gain > best.gain):
                best = Migration(task, vdc.chips, chips, gain)
    return best


# ---------------------------------------------------------------------------
# Service re-placement (online controller)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServiceMigration:
    """One stream service relocating between sites under a new placement
    plan: its buffered operator state ships over the network, then the
    operator stalls for a warm-up before it may fire at the new site."""
    service: str
    src: str
    dst: str
    state_bytes: float
    transfer_s: float
    warmup_s: float = SERVICE_WARMUP_S

    @property
    def stall_s(self) -> float:
        return self.transfer_s + self.warmup_s


def plan_replacement(old: Mapping[str, object], new: Mapping[str, object],
                     state_bytes_fn: Callable[[str], float],
                     transfer_time_fn: Callable[[str, str, float], float],
                     warmup_s: float = SERVICE_WARMUP_S
                     ) -> List[ServiceMigration]:
    """Diff two placement assignments (service -> placement with a
    ``site`` attribute) into the migrations the switch requires. Only
    site moves ship state; a DC service changing its VDC chips/DVFS hint
    composes differently on its *next* fire for free (VDCs are built
    just-in-time per task, there is nothing resident to move)."""
    out: List[ServiceMigration] = []
    for name in sorted(new):
        np_, op = new[name], old.get(name)
        if op is None or op.site == np_.site:
            continue
        sb = state_bytes_fn(name)
        out.append(ServiceMigration(
            service=name, src=op.site, dst=np_.site, state_bytes=sb,
            transfer_s=transfer_time_fn(op.site, np_.site, sb),
            warmup_s=warmup_s))
    return out
