"""Whole runs at a reduced size on the CPU with the timed path broken
underneath (``harness/faults.py``), the look for a card skipped: each
fault that a cell can have makes ``correct`` false under the committed
limits. The controls (the reference in fp8, e4m3 and e5m2, in the
program's place) separate from the program."""
from __future__ import annotations

import pytest
import torch

from conftest import small_cell
from portbench import run as RUN
from portbench.harness import cells, compare, faults, manifest

M = manifest.load_manifest()
CELLS = {w["name"]: manifest.resolve(w["name"], M).traffic["kind"]
         for w in M["workloads"]}
CASES = [(n, f) for n, k in CELLS.items()
         for f in (faults.TRAIN if k == "train" else faults.SERVE)]


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    cell = small_cell(name)
    table = faults.TRAIN if cell.traffic["kind"] == "train" else faults.SERVE
    line = RUN.run(name, 7 * 10**9 + 3, 0.5, False, torch.device("cpu"),
                   cell=cell, wrap=table[fault])
    assert line["correct"] is False, line["checks"]


def _readings(cell, seed):
    """The readings against the fp32 reference of the program in the
    cell's bf16 (``"program"``) and of each control in its place."""
    cfg, tr, dev = cell.config, cell.traffic, torch.device("cpu")
    if tr["kind"] == "train":
        ref = compare.reference_train(cfg, tr, seed, dev)
        _, _, got = cells.first_steps(cell, seed, dev)
        out = {"program": compare.train_readings(got, ref)}
        for p in compare.CONTROLS:
            low = compare.reference_train(cfg, tr, seed, dev, precision=p)
            out[p] = compare.train_readings(low, ref)
        return out
    r = cells.serve(cell, seed, 0.5, False, dev, 0.0,
                    controls=compare.CONTROLS).readings
    return {"program": {"logit_gap": r["logit_gap"],
                        "logit_gap_mean": r["logit_gap_mean"]},
            **r["control"]}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_separates_from_the_program(name):
    """At 8 layers of width 128 on the CPU, each control (the reference
    in fp8, e4m3 and e5m2, in the program's place) reads at least three
    times what the program in the cell's bf16 reads on one of the numbers
    the cell compares: the separation its limits are set in (on the chip,
    at the cell's size, both fail them; PERF.md gives those readings)."""
    cell = small_cell(name, dtype="bfloat16")
    cell.config.update(n_layers=8, d_model=128)
    if cell.traffic["kind"] == "train":
        cell.traffic["seq"] = 128
    r = _readings(cell, 5 * 10**9 + 11)
    prog = r.pop("program")
    for p, ctl in r.items():
        assert any(ctl[k] >= 3 * prog[k] for k in cell.limits), (p, prog, ctl)
