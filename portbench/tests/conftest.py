"""Shared set-up of the benchmark's CPU tests: the checkout's root and
``src`` on the import path, and small copies of the manifest's cells.
Whether a card is there is decided in the ``card`` fixture, never while
a module is imported."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.harness import manifest  # noqa: E402


def small_cell(name: str, dtype: str = "float32"):
    """The manifest's cell ``name`` at a size a CPU test holds: every
    width cut, the traffic's shapes cut, the limits as committed."""
    cell = copy.deepcopy(manifest.resolve(name, manifest.load_manifest()))
    cfg = cell.config
    cfg.update(n_layers=2, d_model=64, vocab_size=500, padded_vocab=512)
    if "ssm" in cfg:
        cfg["ssm"].update(d_state=16, head_dim=16, chunk_size=32)
    if "moe" in cfg:
        cfg.update(n_heads=4, n_kv_heads=2, head_dim=16)
        cfg["moe"].update(n_experts=4, top_k=2, d_ff_expert=64)
    tr = cell.traffic
    if tr["kind"] == "train":
        tr.update(batch=2, seq=64)
    else:
        tr.update(batch=2, prompt_len={"16": 0.5, "40": 0.5}, block=2,
                  output_tokens=5, rate_per_s=4.0)
        tr["check"]["requests"] = 2
        tr["trace"].update(op_requests=1, op_decode_steps=2, timeline_requests=1, timeline_decode_steps=2)
    tr["compute_dtype"] = dtype
    return cell


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
