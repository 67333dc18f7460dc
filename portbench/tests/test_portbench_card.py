"""A run of each cell on the card, end to end through the command's own
entry (skips where there is no card)."""
from __future__ import annotations

import pytest

from portbench import run as RUN
from portbench.harness import manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, card, capsys):
    import json
    assert RUN.main(["--workload", name, "--seed", "4000000019",
                     "--seconds", "5", "--trace", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
