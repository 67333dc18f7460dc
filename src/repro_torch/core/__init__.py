"""JITA-4DS core: the paper's contribution.

Value-of-Service metric (Fig. 3 / Eq. 1-2), VPTR & VPT-family heuristics
(§4.1-4.2), composable VDC submesh allocation, the discrete-event simulator
and its emulation-based validation."""
from repro_torch.core.value import ValueCurve, TaskValueSpec, task_value, vos_total
from repro_torch.core.tasks import Task, TaskType, WorkloadGenerator
from repro_torch.core.costmodel import CostModel
from repro_torch.core.vdc import PodGrid, VDC
from repro_torch.core.heuristics import (HEURISTICS, SimpleHeuristic, VPTHeuristic,
                                   VPTRHeuristic, VPTCPCHeuristic,
                                   VPTJSPCHeuristic, HybridHeuristic)
from repro_torch.core.simulator import Simulator, SimResult
