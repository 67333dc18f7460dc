"""``BENCHMARK.json`` and the files it names: a cell (workload) resolves
to its configuration file, its traffic file
(``portbench/traffic/<traffic>.json``), its limits
(``portbench/limits/<workload>.json``), its end-to-end metrics and the
readers of its per-layer metrics (``portbench/metrics/<name>.py``).
Everything is found by the names the manifest gives, so a later cell,
mix or metric is a new entry and new files, never an edit here."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, manifest: dict, root: Path = ROOT) -> Cell:
    """The cell ``name`` with every file it needs read; KeyError for a
    name the manifest lacks."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{name}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if m["moves"] in moved and _reports(m, name)]
    return Cell(name, w["chips"], config, traffic, limits, e2e, per_layer)


def reader(metric: str) -> Callable:
    """``read(run)`` of ``portbench/metrics/<metric>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"]) for m in cell.per_layer}
