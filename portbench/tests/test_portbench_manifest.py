"""The manifest against the benchmark's contract, and each cell against
the files it names."""
from __future__ import annotations

import json
import re

import pytest

from portbench.harness import manifest
from portbench.harness.readers import forward_flops
from portbench.reference import common as R

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


def test_keys_and_names():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"]
    assert 1 <= M["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in M[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in M["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in M["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200


def test_metrics():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert set(e2e) == {"train_tokens_per_s", "ttft_ms_p95", "itl_ms_p95",
                        "setup_s"}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            reported = e2e[m["moves"]].get("workloads", CELLS)
            assert cell in reported, (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = manifest.resolve(name, M)
    assert cell.traffic["kind"] in ("train", "serve")
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for name_, read in manifest.readers(cell).items():
        assert callable(read), name_


@pytest.mark.parametrize("entry", M["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    cfg = json.loads((manifest.ROOT / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"]
    assert cfg["source"] == entry["source"]


def test_frozen_model_flops():
    """The configurations' frozen counts, recounted from their widths."""
    cfgs = {c["name"]: json.loads((manifest.ROOT / c["file"]).read_text())
            for c in M["configs"]}
    m = cfgs["mamba2-1.3b"]
    D, s = m["d_model"], m["ssm"]
    din, H = s["expand"] * D, s["expand"] * D // s["head_dim"]
    GN = s["n_groups"] * s["d_state"]
    assert m["model_flops"]["projection_params"] == m["n_layers"] * (
        D * (2 * din + 2 * GN + H) + din * D)
    assert m["model_flops"]["logits_params"] == m["vocab_size"] * D
    assert m["model_flops"]["ssd_per_token"] == \
        4 * s["d_state"] * s["head_dim"] * H
    g = cfgs["granite-moe-1b-a400m"]
    D, e = g["d_model"], g["moe"]
    H, KV, d = g["n_heads"], g["n_kv_heads"], g["head_dim"]
    assert g["model_flops"]["projection_params"] == g["n_layers"] * (
        2 * D * H * d + 2 * D * KV * d + D * e["n_experts"]
        + e["top_k"] * 3 * D * e["d_ff_expert"])
    assert g["model_flops"]["logits_params"] == g["vocab_size"] * D
    assert g["model_flops"]["attention_per_pair"] == 4 * d * H
    # a train step of mamba2-1.3b at 2 x 4,096: 6·N·D plus the SSD
    assert forward_flops(m, 2, 4096, 4096) * 3 == pytest.approx(68.4e12,
                                                                rel=2e-3)


def test_learning_rate_matches_the_programs_schedule():
    import torch
    from repro_torch.optim import cosine_schedule
    o = manifest.resolve(CELLS[0], M).traffic["optimizer"]
    for step in (0, 1, 2, 99, 100, 5000, 10000):
        want = float(cosine_schedule(step, o["warmup_steps"],
                                     o["total_steps"], o["peak_lr"]))
        assert R.learning_rate(step, o) == pytest.approx(want, rel=1e-6)
    assert torch.is_tensor(cosine_schedule(0, 1, 2, 1.0))


def test_optimizer_constants_are_the_programs():
    """The traffic's b1, b2, eps and final share of the peak rate, which
    the reference reads, are what the program's step fixes; the adapter
    refuses others."""
    import copy
    from portbench.harness import program
    tr = manifest.resolve(CELLS[0], M).traffic
    for k in ("b1", "b2", "eps", "final_lr_frac"):
        bad = copy.deepcopy(tr)
        bad["optimizer"][k] *= 1.5
        with pytest.raises(ValueError, match=k):
            program.trainer(None, bad, None)
