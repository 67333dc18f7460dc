"""``repro_torch.tracing`` on the CPU, with the reduced granite-moe and
mamba2 configurations:

* off, a train step and a decode step record nothing, and the loss, the
  updated parameters and the logits are bitwise those of a traced run;
* under a CPU ``torch.profiler`` every span in memory has a
  ``repro_torch.<name>`` range (``.backward`` for its backward part)
  that starts and ends within 1 ms of it: one clock;
* each layer-kind span of a train step is one ``forward``, one
  ``recompute`` under remat "full" and one ``backward`` a layer; no
  ``recompute`` without remat; prefill and decode have no ``backward``;
* the ``moe.expert_load`` counter's dropped assignments (Σ over the
  local experts of max(0, load − C)) equal the drops of a plain loop
  over the choices in GShard's order;
* the bounded buffer drops what does not fit and counts it.
"""
from __future__ import annotations

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_arch
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.train import TrainHParams, init_train_state, make_train_step
from repro_torch.train.serve_step import make_decode_step, make_prefill_step

ARCHS = ["granite-moe-1b-a400m", "mamba2-1.3b"]
KINDS = {"granite-moe-1b-a400m": ("attn", "moe"), "mamba2-1.3b": ("ssm",)}
SEQ, PROMPT = 32, 8


@pytest.fixture(autouse=True)
def fresh_record():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def run(name: str, remat: str = "full", dtype=torch.bfloat16):
    """One train step, then a prefill and a decode step on the updated
    model → (loss, parameters, the decode's logits)."""
    cfg = get_arch(name).reduced()
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    step = make_train_step(cfg, TrainHParams(remat=remat, compute_dtype=dtype))
    toks = torch.randint(0, cfg.vocab_size, (2, SEQ + 1),
                         generator=torch.Generator().manual_seed(1))
    state, metrics = step(init_train_state(model),
                          {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    prefill = make_prefill_step(cfg, PROMPT + 4, dtype)
    decode = make_decode_step(cfg, dtype)
    logits, cache = prefill(state.params, {"tokens": toks[:, :PROMPT]})
    logits, _ = decode(state.params, cache, logits.argmax(-1)[:, None], PROMPT)
    params = {k: p.detach().clone()
              for k, p in state.params.named_parameters()}
    return metrics["loss"], params, logits


@pytest.mark.parametrize("name", ARCHS)
def test_off_records_nothing_and_on_changes_no_bit(name):
    loss, params, logits = run(name)
    assert tracing.spans() == [] and tracing.counters() == []
    assert not tracing.enabled()
    x = torch.ones(2, requires_grad=True)
    with tracing.span("probe") as sp:
        assert sp.input(x) is x and sp.output(x) is x
    assert tracing.span("other") is sp           # one shared no-op

    tracing.enable()
    loss_on, params_on, logits_on = run(name)
    assert tracing.spans()
    assert torch.equal(loss, loss_on)
    assert all(torch.equal(params[k], params_on[k]) for k in params)
    assert torch.equal(logits, logits_on)


@pytest.mark.parametrize("name", ARCHS)
def test_spans_share_the_profilers_clock(name):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert tracing.enabled()
        run(name)
    assert not tracing.enabled()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    spans = tracing.spans()
    assert spans
    assert all(not n.startswith("repro_torch::") for n in ranges)
    for s in spans:
        name_ = tracing.PREFIX + s.name + (".backward" if s.phase == "backward"
                                          else "")
        off = min(max(abs(a - s.start_ns), abs(b - s.end_ns))
                  for a, b in ranges[name_])
        assert off <= 1_000_000, (s, off)


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("name", ARCHS)
def test_phases_of_each_layer_kind(name, remat):
    tracing.enable()
    run(name, remat=remat)
    n_layers = get_arch(name).reduced().n_layers
    spans = tracing.spans()
    by_phase = Counter((s.name, s.phase, s.attrs.get("layer")) for s in spans)
    served = {s.id for s in spans if s.name in ("serve.prefill",
                                                  "serve.decode")}
    for kind in KINDS[name]:
        for i in range(n_layers):
            assert by_phase[(kind, "backward", i)] == 1
            assert by_phase[(kind, "recompute", i)] == (remat == "full")
            # the train step's forward, the prefill's and the decode's
            assert by_phase[(kind, "forward", i)] == 3
    assert not any(s.phase == "backward" and s.parent in served
                   for s in spans)
    in_serving = [s for s in spans if s.parent in served]
    assert in_serving and all(s.phase == "forward" for s in in_serving)
    assert by_phase[("head", "backward", None)] == 1
    for phase in ("train.forward", "train.backward", "train.optimizer"):
        assert by_phase[(phase, "forward", None)] == 1


def plain_drops(top_e: torch.Tensor, C: int, E: int) -> int:
    """The assignments a token-by-token loop over the choices, in GShard's
    order (choice-major, then token), finds past an expert's capacity."""
    load, dropped = [0] * E, 0
    for j in range(top_e.shape[1]):
        for t in range(top_e.shape[0]):
            e = int(top_e[t, j])
            dropped += load[e] >= C
            load[e] += 1
    return dropped


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expert_load_counts_the_dropped(seed, monkeypatch):
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    monkeypatch.setattr(MOE, "_capacity", lambda tokens, c: c.top_k)
    g = torch.Generator().manual_seed(seed)
    moe = MOE.MoE(g, cfg.d_model, cfg.moe)
    x = torch.randn(3, 16, cfg.d_model, generator=g)
    tracing.enable()
    MOE.moe_fwd(moe, x)
    (rec,) = [c for c in tracing.counters() if c.name == "moe.expert_load"]
    C, first, n = rec.attrs["capacity"], rec.attrs["first"], \
        rec.attrs["experts"]
    assert C == k and rec.attrs["assignments"] == 3 * 16 * k
    dropped = sum(max(0, load - C) for load in rec.value[first:first + n])

    probs = torch.softmax(torch.einsum("td,de->te", x.reshape(-1, cfg.d_model),
                                       moe.router), -1)
    _, top_e = MOE._top_k(probs, k)
    assert dropped == plain_drops(top_e, C, E) > 0


@pytest.mark.parametrize("capacity", [1, 5, 40])
def test_bounded_buffer_counts_what_it_dropped(capacity, monkeypatch):
    tracing.enable()
    run("granite-moe-1b-a400m", remat="none")
    total = len(tracing.spans()) + len(tracing.counters())
    assert tracing.dropped() == 0 and total > 40

    tracing.reset()
    monkeypatch.setattr(tracing.TRACER, "capacity", capacity)
    run("granite-moe-1b-a400m", remat="none")
    assert len(tracing.spans()) + len(tracing.counters()) == capacity
    assert tracing.dropped() == total - capacity
