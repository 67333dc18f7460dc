"""The plain reference against ``repro_torch`` at a reduced size on the
CPU, in float32: the scan alone, then whole runs of each cell (the first
three train steps; prefill and decode), which the harness compares as a
chip run does."""
from __future__ import annotations

import pytest
import torch

from conftest import small_cell
from portbench import run as RUN
from portbench.harness import manifest
from portbench.reference import ssm

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.parametrize("L,chunk,G", [(64, 16, 1), (50, 16, 2), (7, 32, 1)])
def test_ssd_matches_the_programs_recurrence(L, chunk, G):
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_reference
    g = torch.Generator().manual_seed(L)
    x = torch.randn(2, L, 4, 8, generator=g)
    dt = torch.rand(2, L, 4, generator=g) + 0.1
    A = -torch.linspace(1, 16, 4)
    B, C = (torch.randn(2, L, G, 16, generator=g) for _ in range(2))
    want = ssd_scan_reference(x.double(), dt.double(), A.double(),
                              B.double(), C.double())
    got = ssm.ssd(x, dt, A, B, C, chunk)
    assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_program(name):
    """float32 on both sides: the readings are rounding, far under the
    committed limits, and the run is correct."""
    torch.manual_seed(0)
    cell = small_cell(name)
    line = RUN.run(name, 2**31 + 12345, 0.5, False, torch.device("cpu"),
                   cell=cell)
    assert line["correct"] and line["failed"] == 0
    for k, c in line["checks"].items():
        assert c["value"] < 1e-3 * c["limit"] or c["value"] < 1e-6, (k, c)
    assert list(line)[-1] == "checks"
