"""``repro_torch.graphs``' bookkeeping on the CPU: how each call of a
key runs (``eager``, ``capture``, ``replay``), which graphs are held and
which is dropped first, ``note`` and ``release``; and ``Graphs`` called
on the CPU, which runs every call op by op. The captures and replays
themselves run on the card (``tests/test_torch_gpu.py``: the train
step's, the decode step's and the fluid engine's graphs against their
op-by-op runs, bit for bit)."""
from __future__ import annotations

import pytest
import torch

from repro_torch import graphs as G

A, B = ("a",), ("b",)
P, Q = torch.zeros(1), torch.zeros(1)
X = {"x": torch.zeros(2, 3)}
KX = G.shape_key(X)

# each step: a call of (key, bound) -> how it runs, then the keys whose
# graphs are held, oldest first; "note" and "release" are those calls
CASES = {
    "sightings": (1, [(A, (), "eager", []), (A, (), "capture", [A]),
                      (A, (), "replay", [A]), (A, (), "replay", [A])]),
    "bound": (1, [(A, (P,), "eager", []), (A, (P,), "capture", [A]),
                  (A, (P,), "replay", [A]), (A, (Q,), "capture", [A]),
                  (A, (Q,), "replay", [A]), (A, (P, Q), "capture", [A])]),
    "capacity_1": (1, [(A, (), "eager", []), (A, (), "capture", [A]),
                       (B, (), "eager", []), (B, (), "capture", [B]),
                       (A, (), "capture", [A]), (A, (), "replay", [A])]),
    "capacity_8": (8, [*[((i,), (), "eager", []) for i in range(9)],
                       *[((i,), (), "capture",
                          [(j,) for j in range(max(0, i - 7), i + 1)])
                         for i in range(9)],
                       ((1,), (), "replay", [(j,) for j in range(1, 9)]),
                       ((0,), (), "capture", [(j,) for j in range(2, 9)]
                        + [(0,)])]),
    # a decode step, which notes each call's key first: its first call
    # (the warm-up) captures, every request's steps replay with no new
    # capture, another model's parameters capture again
    "decode_step": (1, [("note", X), (KX, (P,), "capture", [KX]),
                        ("note", X), (KX, (P,), "replay", [KX]),
                        ("note", X), (KX, (P,), "replay", [KX]),
                        ("note", X), (KX, (Q,), "capture", [KX]),
                        ("note", X), (KX, (Q,), "replay", [KX])]),
    "note": (1, [("note", X), (KX, (), "capture", [KX]),
                 (KX, (), "replay", [KX])]),
    "release": (8, [(A, (), "eager", []), (A, (), "capture", [A]),
                    (B, (), "eager", [A]), (B, (), "capture", [A, B]),
                    ("release",), (B, (), "capture", [B]),
                    (A, (), "capture", [B, A])]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bookkeeping(case):
    capacity, steps = CASES[case]
    graphs = G.Graphs(capacity)
    for i, step in enumerate(steps):
        if step[0] == "note":
            graphs.note(step[1])
        elif step[0] == "release":
            graphs.release()
        else:
            key, bound, how, held = step
            assert graphs.decide(key, bound) == how, (i, step)
            assert list(graphs.held) == held, (i, step)


def test_shape_key_names_every_tensor_and_shape():
    x = {"t": torch.zeros(2, 3), "a": torch.zeros(4)}
    y = {"r": torch.zeros(5, 1)}
    assert G.shape_key(x, y) == (("a", (4,)), ("t", (2, 3)), ("r", (5, 1)))
    assert G.shape_key(x) == G.shape_key(dict(reversed(x.items())))
    assert G.shape_key(x) != G.shape_key({**x, "a": torch.zeros(5)})


def test_cpu_calls_run_op_by_op_and_are_seen():
    """On the CPU every call runs ``fn`` itself, captures nothing, and
    records its key as seen; the outputs are ``fn``'s own."""
    graphs, calls = G.Graphs(1), []

    def fn(x, y):
        calls.append(x["t"].shape)
        return x["t"] + y["u"]

    x, y = {"t": torch.ones(3)}, {"u": torch.full((3,), 2.0)}
    for _ in range(3):
        out, how = graphs(fn, x, y, warm=lambda *a: calls.append("warm"))
        assert how == "eager" and torch.equal(out, torch.full((3,), 3.0))
    assert calls == [(3,)] * 3 and graphs.held == {}
    assert graphs.seen == {G.shape_key(x, y)}
