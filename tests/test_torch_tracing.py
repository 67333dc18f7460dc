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
* the bounded buffer drops what does not fit and counts it;
* the span tree of one train step, one prefill and one decode step is
  the one recorded before the layer walker took over the three copies
  of a layer's structure (reduced mamba2, granite-moe and
  granite-4.0-h-small), and whisper's decoder layers have their spans
  over a sequence too.
"""
from __future__ import annotations

import hashlib
import itertools
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_arch
from repro_torch.data import make_batch
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


def tree(spans) -> str:
    """The spans in the order they closed, one line each: phase, name and
    layer, and the span open around it by name and layer (ids come from a
    process-wide counter and are left out); a run of equal lines is one
    line with its count."""
    by_id = {s.id: s for s in spans}

    def at(s):
        layer = s.attrs.get("layer")
        return s.name if layer is None else f"{s.name}@{layer}"
    lines = [f"{s.phase[0]} {at(s)} < "
             + (at(by_id[s.parent]) if s.parent in by_id else "-")
             for s in spans]
    return "\n".join(k if (n := len(list(g))) == 1 else f"{k} x{n}"
                     for k, g in itertools.groupby(lines))


# recorded before the walker: f forward, r recompute, b backward
TREES = {
    "mamba2-1.3b": """
f weight_cast < ssm@0 x9
f ssm@0 < train.forward
f weight_cast < ssm@1 x9
f ssm@1 < train.forward
f weight_cast < head
f head < train.forward
f train.forward < -
b weight_cast < head
b head < train.backward
r weight_cast < ssm@1 x9
r ssm@1 < ssm@1
b weight_cast < ssm@1 x9
b ssm@1 < train.backward
r weight_cast < ssm@0 x9
r ssm@0 < ssm@0
b weight_cast < ssm@0 x9
b ssm@0 < train.backward
f train.backward < -
f train.optimizer < -
f weight_cast < ssm@0 x9
f ssm@0 < serve.prefill
f weight_cast < ssm@1 x9
f ssm@1 < serve.prefill
f weight_cast < head
f head < serve.prefill
f serve.prefill < -
f weight_cast < ssm@0 x7
f ssm@0 < serve.decode
f weight_cast < ssm@1 x7
f ssm@1 < serve.decode
f weight_cast < head
f head < serve.decode
f serve.decode < -
""",
    "granite-moe-1b-a400m": """
f weight_cast < attn@0 x4
f attn@0 < train.forward
f weight_cast < moe.route
f moe.route < moe@0
f moe.dispatch < moe@0
f weight_cast < moe.experts x3
f moe.experts < moe@0
f moe.combine < moe@0
f moe@0 < train.forward
f weight_cast < attn@1 x4
f attn@1 < train.forward
f weight_cast < moe.route
f moe.route < moe@1
f moe.dispatch < moe@1
f weight_cast < moe.experts x3
f moe.experts < moe@1
f moe.combine < moe@1
f moe@1 < train.forward
f weight_cast < head
f head < train.forward
f train.forward < -
b weight_cast < head
b head < train.backward
r weight_cast < attn@1 x4
r attn@1 < moe@1
r weight_cast < moe.route
r moe.route < moe@1
r moe.dispatch < moe@1
r weight_cast < moe.experts x3
r moe.experts < moe@1
r moe.combine < moe@1
r moe@1 < moe@1
b moe.combine < moe@1
b weight_cast < moe.experts x3
b moe.experts < moe@1
b moe.dispatch < moe@1
b weight_cast < moe.route
b moe.route < moe@1
b moe@1 < train.backward
b weight_cast < attn@1 x4
b attn@1 < train.backward
r weight_cast < attn@0 x4
r attn@0 < moe@0
r weight_cast < moe.route
r moe.route < moe@0
r moe.dispatch < moe@0
r weight_cast < moe.experts x3
r moe.experts < moe@0
r moe.combine < moe@0
r moe@0 < moe@0
b moe.combine < moe@0
b weight_cast < moe.experts x3
b moe.experts < moe@0
b moe.dispatch < moe@0
b weight_cast < moe.route
b moe.route < moe@0
b moe@0 < train.backward
b weight_cast < attn@0 x4
b attn@0 < train.backward
f train.backward < -
f train.optimizer < -
f weight_cast < attn@0 x4
f attn@0 < serve.prefill
f weight_cast < moe.route
f moe.route < moe@0
f moe.dispatch < moe@0
f weight_cast < moe.experts x3
f moe.experts < moe@0
f moe.combine < moe@0
f moe@0 < serve.prefill
f weight_cast < attn@1 x4
f attn@1 < serve.prefill
f weight_cast < moe.route
f moe.route < moe@1
f moe.dispatch < moe@1
f weight_cast < moe.experts x3
f moe.experts < moe@1
f moe.combine < moe@1
f moe@1 < serve.prefill
f weight_cast < head
f head < serve.prefill
f serve.prefill < -
f weight_cast < attn@0 x4
f attn@0 < serve.decode
f weight_cast < moe.route
f moe.route < moe@0
f moe.dispatch < moe@0
f weight_cast < moe.experts x3
f moe.experts < moe@0
f moe.combine < moe@0
f moe@0 < serve.decode
f weight_cast < attn@1 x4
f attn@1 < serve.decode
f weight_cast < moe.route
f moe.route < moe@1
f moe.dispatch < moe@1
f weight_cast < moe.experts x3
f moe.experts < moe@1
f moe.combine < moe@1
f moe@1 < serve.decode
f weight_cast < head
f head < serve.decode
f serve.decode < -
""",
}
# granite-4.0-h-small's 20 layers: the tree's 1,113 lines by digest, and
# its spans counted by phase and name
HYBRID_TREE = (
    1113, "86e18fa70b909a0e364b918f26628f6891b3292ae852f1873bffb8cddf9100d6")
HYBRID_COUNTS = {
    "b attn": 2, "b head": 1, "b moe": 20, "b moe.combine": 20,
    "b moe.dispatch": 20, "b moe.experts": 20, "b moe.route": 20,
    "b moe.shared": 20, "b ssm": 18, "b weight_cast": 347, "f attn": 6,
    "f head": 3, "f moe": 60, "f moe.combine": 60, "f moe.dispatch": 60,
    "f moe.experts": 60, "f moe.route": 60, "f moe.shared": 60,
    "f serve.decode": 1, "f serve.prefill": 1, "f ssm": 54,
    "f train.backward": 1, "f train.forward": 1, "f train.optimizer": 1,
    "f weight_cast": 969, "r attn": 2, "r moe": 20, "r moe.combine": 20,
    "r moe.dispatch": 20, "r moe.experts": 20, "r moe.route": 20,
    "r moe.shared": 20, "r ssm": 18, "r weight_cast": 346}


@pytest.mark.parametrize("name", [*TREES, "granite-4.0-h-small"])
def test_span_tree_of_a_step_a_prefill_and_a_decode(name):
    """One train step (remat full, bf16), one prefill and one decode step
    record the span tree recorded before the layer walker."""
    tracing.enable()
    run(name)
    spans = tracing.spans()
    got = tree(spans)
    if name in TREES:
        assert got == TREES[name].strip()
        return
    lines = got.split("\n")
    assert Counter(f"{s.phase[0]} {s.name}" for s in spans) == HYBRID_COUNTS
    assert (len(lines), hashlib.sha256(got.encode()).hexdigest()) \
        == HYBRID_TREE


def test_whisper_decoder_layers_have_spans_over_a_sequence():
    """Whisper's decoder layers, whose decode had their spans, have them
    in the forward and the prefill too: attn and mlp of each layer, in
    the loss's forward and inside ``serve.prefill`` (the encoder's layers
    have none)."""
    cfg = get_arch("whisper-medium").reduced()
    model = M.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in
             make_batch(cfg, SEQ, 2, 0).items()}
    tracing.enable()
    M.loss_fn(cfg, model, batch, remat="full")[0].backward()
    M.prefill(cfg, model, batch, SEQ + 4)
    spans = tracing.spans()
    parent = {s.id: s.name for s in spans}
    layers = [(s.name, s.attrs["layer"], s.phase, parent.get(s.parent))
              for s in spans if s.name in ("attn", "mlp")]
    each = [(kind, i) for i in range(cfg.n_layers) for kind in ("attn",
                                                                "mlp")]
    forward = [(k, i, "forward", None) for k, i in each]
    assert [x for x in layers if x[2] == "forward" and x[3] is None] \
        == forward
    assert [x for x in layers if x[3] == "serve.prefill"] == [
        (k, i, "forward", "serve.prefill") for k, i in each]
    assert Counter(x[2] for x in layers) == {
        "forward": 4 * cfg.n_layers, "recompute": 2 * cfg.n_layers,
        "backward": 2 * cfg.n_layers}
