"""DC-side glue of the co-simulation engine: the analytics cost cells and
the hint-honouring heuristic, carried from the JAX package's
``scenario/engine.py``.

The rest of that module (``ScenarioEngine``, ``EngineConfig`` and the
fire life-cycle) is not ported yet; ``analytics_cost_model`` reads
``records_per_step``, ``mxu_efficiency`` and ``dc_step_floor_s`` from
whatever configuration object it is given.
"""
from __future__ import annotations

from typing import Dict

from repro_torch import hardware as hw
from repro_torch.core.costmodel import CellCost, CostModel
from repro_torch.core.heuristics import HEURISTICS, VPTRHeuristic
from repro_torch.scenario.profiles import ServiceProfile


def analytics_cost_model(profiles: Dict[str, ServiceProfile],
                         cfg) -> CostModel:
    """One roofline cell per service: a DC task step processes
    ``records_per_step`` window values of that service's operator. The
    collective term models the VDC composition / kernel-launch floor, so
    tiny windows don't pretend to finish in nanoseconds."""
    cells = {}
    ref = 256
    for name, prof in profiles.items():
        r = cfg.records_per_step
        t_c = (r * prof.flops_per_record
               / (ref * hw.PEAK_FLOPS_BF16 * cfg.mxu_efficiency))
        t_m = r * prof.bytes_per_record / (ref * hw.HBM_BW)
        cells[(f"svc:{name}", "window")] = CellCost(
            t_c, t_m, cfg.dc_step_floor_s, r * prof.bytes_per_record)
    return CostModel(cells)


class HintedVPTR(VPTRHeuristic):
    """VPTR that honours the placement plan's per-task DVFS hint."""
    name = "VPTR-hint"
    can_scale_f = True

    def _freqs(self, task, headroom_fn):
        return (getattr(task, "dvfs_hint", 1.0),)


def _fresh_heuristic(name: str):
    if name == "hinted":
        return HintedVPTR()
    return type(HEURISTICS[name])()
