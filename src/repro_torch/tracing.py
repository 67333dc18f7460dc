"""Spans and counters inside ``repro_torch``, on the clock that
``torch.profiler`` uses.

Tracing is off by default and then costs a flag test per span: no
tensor op, no autograd node, no host sync, the same numbers. It is on
after ``enable()``, or while a ``torch.profiler`` trace records (checked
as each span opens). To see where a step spends its time::

    from repro_torch import tracing
    tracing.enable()
    state, metrics = train_step(state, batch)
    for s in tracing.spans():
        print(s.name, s.phase, s.attrs, (s.end_ns - s.start_ns) / 1e6, "ms")
    tracing.disable(); tracing.reset()

or take any ``torch.profiler`` trace: each span is also a range named
``repro_torch.<name>`` there (the backward part of a span
``repro_torch.<name>.backward``), with the aten ops and the kernels they
launched inside it.

A span records its name, its phase, its attributes (``layer=i``), the
span it opened in, its thread and its start and end by
``time.time_ns()``, the profiler's time base. The phase is ``forward``,
``recompute`` (a span that opens inside autograd's backward: a
rematerialized layer run again) or ``backward``. A span's backward part
needs its region marked: ``x = sp.input(x)`` on the input that carries
the gradient and ``y = sp.output(y)`` on the region's result put two
identity autograd nodes around it, where tracing is on and the span is
a forward one with grad enabled. The result's node opens the backward
span when the gradient reaches it, the input's node closes it, both on
the thread that runs the backward. A region of one op marks that op's
own autograd node instead (``y = sp.node(y)``: hooks before and after
it runs, no node added).

A counter (``count``) keeps a host int or a reference to a tensor the
program has already computed, never reduced or copied while recording;
``counters()`` reads the values back to the host. Spans and counters
share one bounded buffer; ``dropped()`` counts what did not fit.

A tally (``tally``) is a host int that counts whether tracing is on or
off, one int add a call and no tensor op: it counts what happens in the
untraced steps too. ``tallies()`` reads them. The train step keeps
three: each call adds one to ``train.graph.replay`` (it ran by a replay
of its CUDA graph) or to ``train.graph.eager`` (op by op), and a call
that captured the graph first also adds one to ``train.graph.capture``.
``reset()`` forgets the records and zeroes the tallies.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

import torch

PREFIX = "repro_torch."
CAPACITY = 200_000          # records kept; the rest are counted as dropped


@dataclasses.dataclass
class Span:
    id: int
    name: str
    phase: str                  # "forward", "recompute" or "backward"
    attrs: Dict[str, Any]
    parent: Optional[int]       # the id of the span open around it
    thread: int                 # threading.get_ident() of its thread
    start_ns: int
    end_ns: int


@dataclasses.dataclass
class Count:
    name: str
    value: Any                  # an int, or a tensor's values as a list
    attrs: Dict[str, Any]
    phase: str                  # "forward" or "recompute"
    at_ns: int


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() >= 0


class Tracer:
    """The record of one process: the open spans of each thread, and the
    finished spans and counters in a buffer of ``CAPACITY`` records."""

    def __init__(self):
        self.on = False
        self.capacity = CAPACITY
        self.records: List[Any] = []
        self.tallies: Dict[str, int] = {}
        self.n_dropped = 0
        self.ids = itertools.count(1)
        self.lock = threading.Lock()
        self.local = threading.local()

    def active(self) -> bool:
        return self.on or _profiling()

    def stack(self) -> List[int]:
        """The ids of this thread's open spans."""
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def keep(self, rec) -> None:
        with self.lock:
            if len(self.records) < self.capacity:
                self.records.append(rec)
            else:
                self.n_dropped += 1


class _Off:
    """The span while tracing is off: one shared object, no work."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def input(self, x):
        return x

    def output(self, y):
        return y

    def node(self, y):
        return y


_OFF = _Off()


class _On:
    """An open span, recorded when it closes. As a context manager it
    is a ``forward`` or ``recompute`` span; ``input``/``output`` or
    ``node`` give it a ``backward`` part, a span of its own that the
    autograd engine opens and closes."""

    __slots__ = ("tracer", "name", "attrs", "phase", "id", "parent",
                 "thread", "start", "range", "part", "marked")

    def __init__(self, tracer: Tracer, name: str, attrs: dict, phase: str):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.phase = phase
        self.part: Optional[_On] = None      # the backward part, while open
        self.marked = False

    def open(self, profiling: bool) -> "_On":
        stack = self.tracer.stack()
        self.id = next(self.tracer.ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.thread = threading.get_ident()
        self.range = None
        if profiling:                      # a range in the profiler's trace
            self.range = torch._C._profiler._RecordFunctionFast(
                PREFIX + self.name + (".backward" if self.phase == "backward"
                                      else ""))
            self.range.__enter__()
        self.start = time.time_ns()
        return self

    def close(self) -> None:
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        stack = self.tracer.stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        elif self.id in stack:             # backward parts need not nest
            stack.remove(self.id)
        self.tracer.keep((self.id, self.name, self.phase, self.attrs,
                          self.parent, self.thread, self.start, end))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # the backward part ------------------------------------------------
    def begin(self, *_) -> None:
        if self.part is None and self.tracer.active():
            self.part = _On(self.tracer, self.name, self.attrs,
                            "backward").open(_profiling())

    def end(self, *_) -> None:
        if self.part is not None:
            self.part.close()
            self.part = None

    def marks(self, t: torch.Tensor) -> bool:
        return self.phase == "forward" and t.requires_grad \
            and torch.is_grad_enabled()

    def input(self, x):
        """``x``, the region's input that carries the gradient, behind an
        identity node whose backward ends the backward part."""
        if not self.marks(x):
            return x
        self.marked = True
        return _Marker.apply(x, self.end)

    def output(self, y):
        """``y``, the region's result, behind an identity node whose
        backward begins the backward part (after ``input``)."""
        if not self.marked or not y.requires_grad:
            return y
        return _Marker.apply(y, self.begin)

    def node(self, y):
        """``y``, the region's one op's result: the backward part is its
        autograd node's run."""
        if self.marks(y) and y.grad_fn is not None:
            y.grad_fn.register_prehook(self.begin)
            y.grad_fn.register_hook(self.end)
        return y


class _Marker(torch.autograd.Function):
    """The identity; its backward calls ``at()`` (``_On.begin`` behind a
    region's result, ``_On.end`` behind its input)."""

    @staticmethod
    def forward(ctx, x, at):
        ctx.at = at
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.at()
        return g, None


TRACER = Tracer()


def span(name: str, **attrs):
    """A context manager around one region of the program: a span in
    the record and a profiler range while tracing is on, nothing else
    while it is off."""
    profiling = _profiling()
    if not (TRACER.on or profiling):
        return _OFF
    return _On(TRACER, name, attrs,
               "recompute" if _in_backward() else "forward").open(profiling)


def count(name: str, value, **attrs) -> None:
    """Records ``value`` (a host int, or a tensor already computed, kept
    by reference) under ``name`` while tracing is on."""
    if not TRACER.active():
        return
    TRACER.keep(Count(name, value, attrs,
                      "recompute" if _in_backward() else "forward",
                      time.time_ns()))


def tally(name: str) -> None:
    """Adds one to the host int ``name``, whether tracing is on or off."""
    TRACER.tallies[name] = TRACER.tallies.get(name, 0) + 1


def tallies() -> Dict[str, int]:
    """The tallies since the last reset, by name."""
    return dict(TRACER.tallies)


def enabled() -> bool:
    """Whether spans record now: after ``enable()`` or while a profiler
    records."""
    return TRACER.active()


def enable() -> None:
    TRACER.on = True


def disable() -> None:
    TRACER.on = False


def spans() -> List[Span]:
    """The finished spans, in the order they closed."""
    with TRACER.lock:
        recs = [r for r in TRACER.records if isinstance(r, tuple)]
    return [Span(*r) for r in recs]


def counters() -> List[Count]:
    """The counters in the order recorded, each value read to the host
    (a tensor's as a list of its values)."""
    with TRACER.lock:
        recs = [r for r in TRACER.records if isinstance(r, Count)]
    return [dataclasses.replace(
        c, value=c.value.tolist() if isinstance(c.value, torch.Tensor)
        else c.value) for c in recs]


def dropped() -> int:
    """The records that did not fit in the buffer since the last reset."""
    return TRACER.n_dropped


def reset() -> None:
    """Forgets every record and zeroes the tallies."""
    with TRACER.lock:
        TRACER.records = []
        TRACER.n_dropped = 0
        TRACER.tallies = {}
