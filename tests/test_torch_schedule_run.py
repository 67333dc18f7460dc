"""The port's scheduler loop (launch/schedule_run) and emulator against
the JAX package's, on the CPU: the ``[plan]`` line (VoS and completed
jobs, from the carried core/) equals the reference's, the planned jobs
run the port's train_loop, and ``measured_cost_model`` keeps the
analytic model's ratios per cell."""
import contextlib
import io

import pytest

from repro.core.costmodel import CostModel as RCost
from repro.core.heuristics import HEURISTICS as RH
from repro.core.simulator import Simulator as RSim
from repro.core.tasks import PAPER_REGIME as R_REGIME
from repro.core.tasks import TaskType as RTask
from repro.core.tasks import WorkloadGenerator as RGen
from repro.launch.schedule_run import EDGE_ARCHS as R_EDGE
from repro_torch.core.costmodel import CostModel
from repro_torch.core.emulator import measure_step_time, measured_cost_model
from repro_torch.launch import schedule_run


def _reference_plan_line(jobs, heuristic):
    """The reference's ``main`` up to its [plan] line."""
    cost = RCost.analytic()
    gen = RGen([RTask(a, "train_4k") for a in R_EDGE], cost, seed=0,
               **R_REGIME)
    result = RSim(RH[heuristic], cost).run(list(gen.trace(jobs)))
    return result, (f"[plan] {heuristic}: VoS={result.vos:.1f} "
                    f"completed={result.completed}/{jobs}")


@pytest.mark.parametrize("jobs,heuristic", [(3, "VPTR"), (6, "VPTR"),
                                            (6, "Simple"), (8, "Hybrid")])
def test_plan_equals_the_reference(jobs, heuristic):
    assert schedule_run.EDGE_ARCHS == R_EDGE
    result, line = schedule_run.plan(jobs, heuristic)
    ref, ref_line = _reference_plan_line(jobs, heuristic)
    assert line == ref_line
    assert result.vos == ref.vos
    assert [(t.tid, t.ttype.arch, t.start, t.chips, t.dvfs_f, t.earned)
            for t in result.tasks] == [
        (t.tid, t.ttype.arch, t.start, t.chips, t.dvfs_f, t.earned)
        for t in ref.tasks]


def test_main_runs_the_planned_jobs_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        schedule_run.main(["--jobs", "3", "--steps", "2", "--device", "cpu"])
    lines = out.getvalue().splitlines()
    _, ref_line = _reference_plan_line(3, "VPTR")
    assert lines[0] == ref_line
    jobs = [ln for ln in lines if ln.startswith("  job ")]
    assert len(jobs) == 3 and all("ran 2 real steps" in ln for ln in jobs)


def test_measured_cost_model_keeps_the_analytic_ratios(monkeypatch):
    """Each cell's terms are the analytic cell's scaled by one factor, so
    their ratios are kept, and the dominant term is the measured train
    time times the shape's multiplier."""
    import repro_torch.core.emulator as E
    monkeypatch.setattr(E, "measure_step_time",
                        lambda arch, kind, device=None: {"smollm-135m": 0.5,
                                                         "mamba2-1.3b": 2.0
                                                         }[arch])
    archs = ["smollm-135m", "mamba2-1.3b"]
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    base = CostModel.analytic(archs, shapes)
    got = measured_cost_model(archs, shapes, scale=3.0)
    mult = {"train_4k": 1.0, "prefill_32k": 0.4, "decode_32k": 0.02}
    for a in archs:
        for s in shapes:
            ref, cell = base.cells[(a, s)], got.cells[(a, s)]
            f = cell.t_compute / ref.t_compute
            assert cell.t_memory == pytest.approx(ref.t_memory * f, rel=1e-12)
            assert cell.t_collective == pytest.approx(ref.t_collective * f,
                                                      rel=1e-12)
            assert cell.hbm_bytes == ref.hbm_bytes
            t = {"smollm-135m": 0.5, "mamba2-1.3b": 2.0}[a] * mult[s] * 3.0
            assert max(cell.t_compute, cell.t_memory,
                       cell.t_collective) == pytest.approx(t, rel=1e-12)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_measure_step_time_on_the_cpu(kind):
    t = measure_step_time("smollm-135m", kind, seq=16, batch=2, iters=1,
                          device="cpu")
    assert 0 < t < 60
