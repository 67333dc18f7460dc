"""granite-4.0-h-small's reference (``reference/hybrid.py``) against
``repro_torch`` on the CPU, in float32, at a small size that keeps one
whole period of the layer pattern (10 layers, attention at layer 5):

* the harness's comparison of the first three train steps (the loss,
  step 1's gradients, the change after three AdamW steps);
* prefill, then decode through the KV and SSM caches, against the
  reference's full forward;
* the share of the MoE: the partial outputs of all the shares of a
  layer's experts, with the shared expert counted once, add up to the
  uncut reference layer;
* the configuration file: its frozen model FLOPs recounted from its
  widths, and its source keys and the harness's keys stating one run;
* ``moe_dropped_held.train``: the drops of the held experts over their
  own assignments.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import types

import pytest
import torch

from conftest import small_cell
from portbench import run as RUN
from portbench.harness import manifest, program
from portbench.harness import spans as S
from portbench.harness import weights as W
from portbench.harness.readers import Run, forward_flops
from portbench.harness.trace import Trace
from portbench.reference import common as R
from portbench.reference import hybrid

NAME = "granite-4.0-h-small.train_4k"
CPU = torch.device("cpu")
SEED = 2**31 + 271828


def period_cell():
    """The cell cut for the CPU with one whole period: 10 layers, d 64,
    heads 4 / 2 of 16, SSD heads of 16, 2 of 16 routed experts held,
    top-2, a shared expert of 96."""
    cell = small_cell(NAME)
    cell.config["n_layers"] = 10
    cell.config["moe"].update(n_experts=2, routed_experts=16, top_k=2,
                              shared_ff=96)
    return cell


@pytest.fixture
def period_arch(monkeypatch):
    """The adapter's arch with the router's and the shared expert's widths
    of the cut file (the adapter keeps the registered ones, 72 and
    1,536, which the committed file states)."""
    arch = program.arch

    def cut(cfg):
        m = cfg["moe"]
        return dataclasses.replace(arch(cfg), routed_experts=m["routed_experts"],
                                   shared_expert_ff=m["shared_ff"])
    monkeypatch.setattr(program, "arch", cut)
    return cut


def test_the_program_stacks_the_files_layers(period_arch):
    cfg = period_cell().config
    a = period_arch(cfg)
    assert hybrid.mixers(cfg)[5] == "attention"
    assert [k.split("+")[0] for k in a.layer_kinds()] == [
        "attn" if m == "attention" else "ssm" for m in hybrid.mixers(cfg)]
    assert all(k.endswith("+moe") for k in a.layer_kinds())
    assert a.positional == "nope"
    mdl = program.model(a, W.make(hybrid.param_spec(cfg), SEED, CPU), CPU)
    assert mdl.blocks[5].moe.router.shape == (64, 16)
    assert mdl.blocks[5].moe.w_gate.shape == (2, 64, 64)


def test_a_whole_period_trains_as_the_reference(period_arch):
    """float32 on both sides: the readings are rounding, far under the
    committed limits, and the run is correct."""
    torch.manual_seed(0)
    line = RUN.run(NAME, SEED, 0.5, False, CPU, cell=period_cell())
    assert line["correct"] and line["failed"] == 0
    assert line["readings"]["loss_gap"] < 1e-5
    for k, c in line["checks"].items():
        assert c["value"] < 1e-3 * c["limit"] or c["value"] < 1e-6, (k, c)


@torch.no_grad()
def test_a_prefill_then_decode_reads_the_references_logits(period_arch):
    """The prompt's last logits, then one decode step a token through
    both kinds of cache, against the reference's forward over the whole
    sequence, its MoE routing each call's positions together."""
    cfg = period_cell().config
    B, L, n, V = 2, 24, 6, cfg["vocab_size"]
    a = program.arch(cfg)
    mdl = program.model(a, W.make(hybrid.param_spec(cfg), SEED, CPU), CPU)
    prefill, decode = program.server(a, {"compute_dtype": "float32"}, L + n)
    toks = torch.randint(0, V, (B, L + n),
                         generator=torch.Generator().manual_seed(3))
    logits, cache = prefill(mdl, {"tokens": toks[:, :L]})
    assert [sorted(c) for c in cache[4:6]] == [["conv", "h"], ["k", "v"]]
    got = [logits]
    for j in range(L, L + n - 1):
        logits, cache = decode(mdl, cache, toks[:, j:j + 1], j)
        got.append(logits)
    got = torch.stack(got, dim=1)[..., :V]

    R.exact_fp32()
    p = W.make(hybrid.param_spec(cfg), SEED, CPU)
    mm = R.Products("fp32")
    h, _ = hybrid.hidden(cfg, p, toks[:, :L + n - 1], mm,
                         list(range(L, L + n - 1)))
    want = R.logits(cfg, p, h[:, L - 1:], mm)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def _layer_weights(D, E, F_, Fs, seed):
    g = torch.Generator().manual_seed(seed)
    shapes = {"router": (D, E), "w_gate": (E, D, F_), "w_up": (E, D, F_),
              "w_down": (E, F_, D), "shared.w_gate": (D, Fs),
              "shared.w_up": (D, Fs), "shared.w_down": (Fs, D)}
    return {k: torch.randn(s, generator=g) / s[-2] ** 0.5
            for k, s in shapes.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_b_the_shares_add_up_to_the_uncut_layer(seed):
    """Eight shares of 2 of 16 experts (e0 = 0, 2, ..., 14), each routing
    over all 16 and computing its own, and the shared expert once: their
    sum is the reference's layer holding all 16, as are the aux loss's
    parts. Capacity drops assignments at this size."""
    from repro_torch.configs import MoEConfig
    from repro_torch.models import moe as MOE
    D, E, k, F_, Fs, T, held = 64, 16, 2, 32, 48, 96, 2
    moe = {"n_experts": E, "routed_experts": E, "top_k": k, "d_ff_expert": F_,
           "shared_ff": Fs, "capacity_factor": MOE.CAPACITY_FACTOR,
           "aux_loss_weight": 0.01}
    p = _layer_weights(D, E, F_, Fs, seed)
    x = torch.randn(T, D, generator=torch.Generator().manual_seed(seed + 7))
    R.exact_fp32()
    want, aux_want = hybrid.moe_share(moe, p, "", x, R.Products("fp32"))
    top_e = torch.topk(x @ p["router"], k).indices
    assert int(torch.bincount(top_e.flatten()).max()) > hybrid.capacity(T, moe)

    layer = MOE.MoE(torch.Generator(), D, MoEConfig(held, k, F_), E, Fs)
    layer.load_state_dict({"router": p["router"], "shared.w_gate":
                           p["shared.w_gate"], "shared.w_up": p["shared.w_up"],
                           "shared.w_down": p["shared.w_down"],
                           **{w: p[w][:held] for w in hybrid._EXPERT}})
    y = layer.shared(x[None])[0]
    aux = torch.zeros(())
    for e0 in range(0, E, held):
        w = {"router": p["router"],
             **{n: p[n][e0:e0 + held] for n in hybrid._EXPERT}}
        part, a = MOE._moe_local(w, layer.routed, x, held, e0)
        y, aux = y + part, aux + a
    assert torch.allclose(y, want, rtol=1e-5, atol=1e-5)
    assert torch.allclose(aux, aux_want, rtol=1e-5)
    # the first share through the layer's own path: the routed part of
    # experts 0-1 and the shared expert
    first, _ = MOE.moe_fwd(layer, x[None])
    w0 = {"router": p["router"], **{n: p[n][:held] for n in hybrid._EXPERT}}
    share0 = MOE._moe_local(w0, layer.routed, x, held, 0)[0]
    assert torch.allclose(first[0], share0 + layer.shared(x[None])[0],
                          rtol=1e-6, atol=1e-6)


def _file():
    entry = next(c for c in manifest.load_manifest()["configs"]
                 if c["name"] == "granite-4.0-h-small")
    return json.loads((manifest.ROOT / entry["file"]).read_text())


def test_c_frozen_model_flops():
    """The frozen counts, recounted from the file's widths and pattern:
    the per-layer terms are the 10 layers' averages, since the harness
    multiplies them by every layer."""
    c = _file()
    D, s, m = c["d_model"], c["ssm"], c["moe"]
    H, KV, d = c["n_heads"], c["n_kv_heads"], c["head_dim"]
    din = s["expand"] * D
    Hs, GN = din // s["head_dim"], s["n_groups"] * s["d_state"]
    kinds = hybrid.mixers(c)
    n_ssm, n_attn, n = kinds.count("mamba"), kinds.count("attention"), len(kinds)
    assert (n, n_ssm, n_attn) == (c["n_layers"], 9, 1)
    held_per_token = m["top_k"] * m["n_experts"] / m["routed_experts"]
    moe = (D * m["routed_experts"] + held_per_token * 3 * D * m["d_ff_expert"]
           + 3 * D * m["shared_ff"])
    f = c["model_flops"]
    assert f["projection_params"] == (
        n_ssm * (D * (2 * din + 2 * GN + Hs) + din * D)
        + n_attn * (2 * D * H * d + 2 * D * KV * d) + n * moe)
    assert f["logits_params"] == c["vocab_size"] * D
    assert f["ssd_per_token"] == pytest.approx(
        4 * s["d_state"] * s["head_dim"] * Hs * n_ssm / n, rel=1e-12)
    assert f["attention_per_pair"] == pytest.approx(4 * d * H * n_attn / n,
                                                    rel=1e-12)
    # a train step at 2 x 4,096
    assert forward_flops(c, 2, 4096, 4096) * 3 == pytest.approx(84.5e12,
                                                                rel=2e-3)


def test_the_file_states_one_run():
    """The source's keys (as the published config.json names them) and
    the harness's keys say the same run, and the router keeps its
    published width."""
    c = _file()
    m, s = c["moe"], c["ssm"]
    assert c["num_hidden_layers"] == c["n_layers"] == len(c["layer_types"])
    assert c["hidden_size"] == c["d_model"]
    assert (c["num_attention_heads"], c["num_key_value_heads"]) == (
        c["n_heads"], c["n_kv_heads"])
    assert c["hidden_size"] // c["num_attention_heads"] == c["head_dim"]
    assert c["num_local_experts"] == m["n_experts"]
    assert (c["num_experts_per_tok"], c["intermediate_size"],
            c["shared_intermediate_size"]) == (m["top_k"], m["d_ff_expert"],
                                               m["shared_ff"])
    assert m["routed_experts"] == 72 and m["routed_experts"] % m["n_experts"] == 0
    assert (c["mamba_d_state"], c["mamba_d_conv"], c["mamba_expand"],
            c["mamba_d_head"], c["mamba_n_groups"], c["mamba_chunk_size"]) == (
        s["d_state"], s["d_conv"], s["expand"], s["head_dim"], s["n_groups"],
        s["chunk_size"])
    assert c["mamba_n_heads"] == s["expand"] * c["d_model"] // s["head_dim"]
    assert c["rms_norm_eps"] == c["norm_eps"]
    assert c["tie_word_embeddings"] == c["tie_embeddings"]
    assert c["position_embedding_type"] == "nope"
    assert c["logits_scaling"] == 1 and "logits_scaling" in c["reduced"]
    a = program.arch(c)
    assert (a.n_routed, a.shared_expert_ff, a.moe.n_experts) == (
        m["routed_experts"], m["shared_ff"], m["n_experts"])
    # the muP multipliers and the convolution's bias, which the program
    # takes from its registered arch and the reference from this file
    assert (a.embedding_multiplier, a.attention_multiplier,
            a.residual_multiplier, a.ssm_conv_bias) == (
        c["embedding_multiplier"], c["attention_multiplier"],
        c["residual_multiplier"], c["mamba_conv_bias"])


def _expert_load(at_ms, value, C, first, experts):
    return types.SimpleNamespace(
        name="moe.expert_load", value=value, at_ns=at_ms * 1_000_000,
        attrs={"capacity": C, "assignments": sum(value), "first": first,
               "experts": experts})


def test_dropped_held_share_reads_the_held_experts(monkeypatch):
    """Σ max(0, load − C) ÷ Σ load over each call's held experts, inside
    the traced steps; where ``moe_dropped.train`` divides by all T·k."""
    read = manifest.reader("moe_dropped_held.train")
    calls = [_expert_load(10, [9, 1, 6, 2, 7, 5], 4, first=2, experts=2),
             _expert_load(20, [3, 8, 0, 5, 1, 1], 4, first=2, experts=2),
             _expert_load(500, [50, 0, 0, 0, 0, 0], 4, 0, 2)]  # outside
    rec = types.SimpleNamespace(spans=lambda: [], counters=lambda: calls)
    monkeypatch.setitem(sys.modules, S.PROGRAM_RECORD, rec)
    timeline = Trace([], [], {S.STEP: [(0, 100 * 1_000_000, -1)]}, [])
    run = Run({}, {}, timeline=timeline)
    assert read(run) == pytest.approx(100 * (2 + 0 + 0 + 1) / (6 + 2 + 0 + 5))
    all_tk = manifest.reader("moe_dropped.train")(run)
    assert all_tk == pytest.approx(100 * 3 / (30 + 18))
    assert read(Run({}, {})) is None
    monkeypatch.delitem(sys.modules, S.PROGRAM_RECORD)
    assert read(run) is None
