"""granite-4.0-h-small on the port, on the CPU: the hybrid stack of Mamba-2
and NoPE attention layers, each with an MoE that may hold a share of the
experts its router scores, and a shared expert.

* the registered configuration's shape and parameter counts (32B total,
  about 9B a token);
* a layer that holds all its experts and has no shared expert is the
  layer it was: the same parameters, the same numbers bit for bit;
* a held share routes over every expert and computes its own;
* prefill, then decode through the KV and SSM caches side by side,
  gives the forward's logits;
* a reduced train step records ``moe.shared`` spans in the forward, the
  recompute and the backward of every layer, and ``attn`` / ``ssm``
  spans at the pattern's layers;
* the published muP multipliers and the Mamba-2 convolution's bias are
  registered, each Mamba-2 layer holds the bias under its axes, and
  ``train_loop`` trains an ``ArchConfig`` as it is given.

The JAX package has no such architecture; the port is held against the
benchmark's plain reference in ``portbench/tests/test_portbench_hybrid.py``.
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import MoEConfig, get_arch
from repro_torch.launch.train import train_loop
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.train import TrainHParams, init_train_state, make_train_step

NAME = "granite-4.0-h-small"


@pytest.fixture(autouse=True)
def fresh_record():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def one_period():
    """The reduced configuration cut to one period of 10 layers."""
    return dataclasses.replace(get_arch(NAME).reduced(), n_layers=10)


def test_registered_shape():
    a = get_arch(NAME)
    kinds = a.layer_kinds()
    assert len(kinds) == 40
    assert [i for i, k in enumerate(kinds) if k == "attn+moe"] == [5, 15, 25,
                                                                   35]
    assert kinds.count("ssm+moe") == 36
    assert a.ssm.n_heads(a.d_model) == 128 and a.head_dim == 128
    assert (a.n_routed, a.moe.top_k, a.shared_expert_ff) == (72, 10, 1536)
    assert a.positional == "nope" and a.padded_vocab == a.vocab_size
    pc = a.param_counts()
    assert 32.0e9 < pc["total"] < 32.5e9
    assert 8.5e9 < pc["active"] < 9.5e9
    # one chip's share of 9 of the 72 experts: k · 9/72 held experts a token
    share = dataclasses.replace(a, moe=dataclasses.replace(a.moe, n_experts=9))
    D, F_ = a.d_model, a.moe.d_ff_expert
    assert pc["active"] - share.param_counts()["active"] == pytest.approx(
        40 * 10 * (1 - 9 / 72) * 3 * D * F_)


@pytest.mark.parametrize("seed", [0, 1])
def test_a_layer_holding_all_its_experts_is_unchanged(seed):
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=32)
    a = MOE.MoE(torch.Generator().manual_seed(seed), 64, cfg)
    b = MOE.MoE(torch.Generator().manual_seed(seed), 64, cfg, routed=8,
                shared_ff=0)
    assert a.routed is a.cfg and b.routed is b.cfg and b.shared is None
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == ["router", "w_gate", "w_up", "w_down"] == list(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    x = torch.randn(2, 24, 64, generator=torch.Generator().manual_seed(9))
    ya, aux_a = MOE.moe_fwd(a, x)
    w = {k: getattr(a, k) for k in ("router", "w_gate", "w_up", "w_down")}
    y, aux = MOE._moe_local(w, cfg, x.reshape(48, 64), 8, 0)
    assert torch.equal(ya, y.reshape(2, 24, 64)) and torch.equal(aux_a, aux)


def test_a_held_share_routes_over_every_expert():
    """Holding experts 0-3 of 16 computes exactly what the whole layer's
    experts 0-3 give: the same routing, the same capacity, the same
    slots; the shared expert is added once."""
    D, k, F_ = 64, 2, 32
    whole = MOE.MoE(torch.Generator().manual_seed(0), D,
                    MoEConfig(n_experts=16, top_k=k, d_ff_expert=F_))
    share = MOE.MoE(torch.Generator().manual_seed(1), D,
                    MoEConfig(n_experts=4, top_k=k, d_ff_expert=F_),
                    routed=16, shared_ff=48)
    assert share.routed.n_experts == 16 and share.router.shape == (D, 16)
    with torch.no_grad():
        share.router.copy_(whole.router)
        for n in ("w_gate", "w_up", "w_down"):
            getattr(share, n).copy_(getattr(whole, n)[:4])
    x = torch.randn(1, 40, D, generator=torch.Generator().manual_seed(2))
    y, aux = MOE.moe_fwd(share, x)
    w = {n: getattr(whole, n)[:4] if n != "router" else whole.router
         for n in ("router", "w_gate", "w_up", "w_down")}
    want, aux_want = MOE._moe_local(w, whole.cfg, x[0], 4, 0)
    assert MOE._capacity(40, share.routed) == MOE._capacity(40, whole.cfg)
    assert torch.allclose(y[0], want + share.shared(x)[0], atol=1e-6)
    assert torch.equal(aux, aux_want)


@torch.no_grad()
def test_prefill_then_decode_equals_forward(monkeypatch):
    """Under a capacity no group reaches (the forward routes all positions
    together, the prefill the prompt and each decode step its own)."""
    monkeypatch.setattr(MOE, "CAPACITY_FACTOR", 1000.0)
    cfg = one_period()
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(1))
    full, _ = M.forward(cfg, model, {"tokens": toks},
                        compute_dtype=torch.float32)
    logits, cache = M.prefill(cfg, model, {"tokens": toks[:, :12]}, 20,
                              compute_dtype=torch.float32)
    kinds = [sorted(c) for c in cache]
    assert kinds[5] == ["k", "v"] and kinds[4] == kinds[6] == ["conv", "h"]
    got = [logits]
    for j in range(12, 19):
        logits, cache = M.decode_step(cfg, model, cache, toks[:, j:j + 1], j,
                                      compute_dtype=torch.float32)
        got.append(logits)
    got = torch.stack(got, dim=1)
    want = full[:, 11:19]
    real = cfg.vocab_size
    assert torch.allclose(got[..., :real], want[..., :real], atol=1e-4,
                          rtol=1e-4)


def test_spans_of_a_train_step():
    cfg = one_period()
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    step = make_train_step(cfg, TrainHParams(remat="full",
                                             compute_dtype=torch.bfloat16))
    toks = torch.randint(0, cfg.vocab_size, (2, 33),
                         generator=torch.Generator().manual_seed(1))
    tracing.enable()
    step(init_train_state(model), {"tokens": toks[:, :-1],
                                   "labels": toks[:, 1:]})
    spans = tracing.spans()
    by = Counter((s.name, s.phase, s.attrs.get("layer")) for s in spans)
    for i, kind in enumerate(cfg.layer_kinds()):
        mixer = kind.split("+")[0]
        other = "ssm" if mixer == "attn" else "attn"
        for phase in ("forward", "recompute", "backward"):
            assert by[(mixer, phase, i)] == 1, (mixer, phase, i)
            assert by[(other, phase, i)] == 0
            assert by[("moe", phase, i)] == 1
    assert [i for i, k in enumerate(cfg.layer_kinds()) if k == "attn+moe"] \
        == [5]
    layer_of = {s.id: s.attrs.get("layer") for s in spans if s.name == "moe"}
    shared = Counter((s.phase, layer_of.get(s.parent)) for s in spans
                     if s.name == "moe.shared")
    for i in range(cfg.n_layers):
        for phase in ("forward", "recompute", "backward"):
            assert shared[(phase, i)] == 1, (phase, i)
    loads = [c for c in tracing.counters() if c.name == "moe.expert_load"]
    assert loads and all(c.attrs["first"] == 0 and c.attrs["experts"] == 4
                         and len(c.value) == 72 for c in loads)


def test_mup_and_the_convolutions_bias():
    a = get_arch(NAME)
    assert (a.embedding_multiplier, a.residual_multiplier,
            a.attention_multiplier, a.ssm_conv_bias) == (12.0, 0.22,
                                                         1 / 128, True)
    cfg = one_period()
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    names = list(model.state_dict())
    assert sorted(M.param_axes(cfg)) == sorted(names)
    din = cfg.ssm.d_inner(cfg.d_model)
    GN = cfg.ssm.n_groups * cfg.ssm.d_state
    for i, kind in enumerate(cfg.layer_kinds()):
        has = f"blocks.{i}.ssm.conv_x_bias" in names
        assert has == kind.startswith("ssm")
        if has:
            blk = model.blocks[i].ssm
            assert blk.conv_x_bias.shape == (din,)
            assert blk.conv_BC_bias.shape == (2 * GN,)


@pytest.mark.parametrize("name", ["smollm-135m", NAME])
def test_train_loop_takes_an_arch_config(name):
    """An ``ArchConfig`` trains as the registered name's reduced config
    does: the same losses."""
    kw = dict(steps=2, batch=2, seq=32, device="cpu", log_every=10**9)
    _, by_name = train_loop(name, **kw)
    _, by_cfg = train_loop(get_arch(name).reduced(), **kw)
    assert by_name == by_cfg and all(map(math.isfinite, by_cfg))
