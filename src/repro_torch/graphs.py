"""CUDA-graph replay of a function of tensors, one graph per input shape:
the rule of the train step and of the fluid engine's time loop.

A call passes ``fn`` and its inputs, dicts of tensors, keyed by every
tensor's name and shape (``shape_key``). A key's first sighting runs
``fn`` op by op, so a one-off call pays no capture. Its next sighting
empties the allocator's cache, warms up on static copies of the inputs on
a side stream (``warm``, or ``fn`` itself), captures ``fn`` of the copies
on that same stream (which keeps the warm-up's cuBLAS workspaces out of
the graph's pool) and replays it; later sightings copy the inputs in and
replay. A graph remembers ``bound``, the tensors ``fn`` updates in place,
by identity, and a call that brings others captures again. At most
``capacity`` graphs are held: a call that does not replay first drops
the oldest and returns its pool to the card (a pool holds its run's
activations, which the coming run needs room for). A call returns the
outputs, for a replay the graph's own tensors, valid until its next
replay, and how it ran: ``"eager"``, ``"capture"`` or ``"replay"``. On
the CPU every call runs op by op. The bookkeeping (``decide``) touches
no device, so it runs on the CPU as on the card.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

Inputs = Mapping[str, torch.Tensor]


def shape_key(*inputs: Inputs) -> tuple:
    """Every input tensor's name and shape, dict by dict."""
    return tuple((k, tuple(v.shape)) for d in inputs
                 for k, v in sorted(d.items()))


class Graphs:
    """The graphs of one caller, oldest first, and the keys it has seen."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.seen: set = set()
        self.held: Dict[tuple, SimpleNamespace] = {}

    def decide(self, key: tuple, bound: tuple = ()) -> str:
        """How a call of ``key`` runs, with its sighting recorded, the
        graphs it replaces dropped and, for a capture, its slot held."""
        slot = self.held.get(key)
        if slot is not None and _same(slot.bound, bound):
            return "replay"
        if slot is not None:
            self._drop(key)
        while self.held and len(self.held) >= self.capacity:
            self._drop(next(iter(self.held)))
        if key not in self.seen:
            self.seen.add(key)
            return "eager"
        self.held[key] = SimpleNamespace(bound=bound, graph=None)
        return "capture"

    def note(self, *inputs: Inputs) -> None:
        """Records a sighting that its caller ran op by op itself."""
        self.seen.add(shape_key(*inputs))

    def __call__(self, fn: Callable, *inputs: Inputs,
                 warm: Optional[Callable] = None,
                 bound: tuple = ()) -> Tuple[Any, str]:
        """``fn(*inputs)`` op by op, captured or replayed -> (its
        outputs, how it ran)."""
        dev = next(iter(inputs[0].values())).device
        if dev.type != "cuda":
            self.note(*inputs)
            return fn(*inputs), "eager"
        key = shape_key(*inputs)
        how = self.decide(key, bound)
        if how == "eager":
            return fn(*inputs), how
        slot = self.held[key]
        if how == "capture":
            try:
                _capture(slot, fn, warm or fn, inputs, dev)
            except BaseException:
                del self.held[key]
                raise
        for static, d in zip(slot.static, inputs):
            for k, v in d.items():
                static[k].copy_(v)
        slot.graph.replay()
        return slot.out, how

    def release(self) -> None:
        """Drops every graph; the keys stay seen."""
        for key in list(self.held):
            self._drop(key)

    def _drop(self, key: tuple) -> None:
        if self.held.pop(key).graph is not None:
            torch.cuda.empty_cache()


def _capture(slot, fn: Callable, warm: Callable, inputs, dev) -> None:
    slot.static = tuple({k: v.clone() for k, v in d.items()} for d in inputs)
    # the op-by-op runs' cached blocks belong to another stream: give them
    # back first, so that the warm-up and then the graph's pool (entering
    # the capture empties the cache again) take their place
    torch.cuda.empty_cache()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        warm(*slot.static)
    torch.cuda.current_stream(dev).wait_stream(side)
    slot.graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(slot.graph, stream=side):
        slot.out = fn(*slot.static)


def _same(a: tuple, b: tuple) -> bool:
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))
