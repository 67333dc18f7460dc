"""What a traced run records, and its reduction to what the per-layer
readers read.

The benchmark's own spans (``portbench.step``, ``portbench.prefill``,
``portbench.decode``) are ``torch.profiler.record_function`` ranges
around its calls into the program; the program's operations are the
profiler's events of its custom ops (``repro_torch::*``), with their
input shapes and types. Each device activity is tied to the host op
that launched it by the profiler's linked correlation id, and to one of
the program's ops by that host op's time on its thread: so an op's
device time is that of every kernel launched under it, whatever those
kernels are named.
"""
from __future__ import annotations

import bisect
import dataclasses
import re
from typing import Dict, List, Optional, Tuple

SPANS = ("portbench.step", "portbench.prefill", "portbench.decode")
_LAUNCH = re.compile(r"^cu(da)?[A-Z]")        # CUDA API calls (cuda*, cu*)
_NOT_KERNELS = re.compile(r"^(Memcpy|Memset|memcpy|memset)")

ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8,
            "int": 4, "long int": 8, "c10::Float8_e4m3fn": 1}
DTYPE_NAMES = {"float": "float32", "c10::BFloat16": "bfloat16",
               "c10::Half": "float16", "double": "float64"}


@dataclasses.dataclass
class Activity:
    start_ns: int
    end_ns: int
    name: str
    thread: int           # the launching host thread
    launch_ns: int        # when the host launched it
    kernel: bool          # a kernel (not a copy or a fill)
    inferred: bool = False   # launch not correlated in the trace


@dataclasses.dataclass
class OpCall:
    name: str
    shapes: list
    dtypes: list
    thread: int
    start_ns: int
    end_ns: int
    device_ns: int = 0


@dataclasses.dataclass
class Trace:
    activities: List[Activity]          # device work, by start
    ops: List[OpCall]                   # the program's custom ops
    spans: Dict[str, List[Tuple[int, int, int]]]   # name -> (start, end, thread)
    host: List[Tuple[int, int, str, int]]          # every host op: start, end, name, thread

    def window(self) -> Tuple[int, int]:
        """From the first span's start to the last span's end."""
        all_spans = [s for v in self.spans.values() for s in v]
        return (min(s[0] for s in all_spans), max(s[1] for s in all_spans))

    def calls(self, op: str) -> List[OpCall]:
        return [c for c in self.ops if c.name == op]

    def in_spans(self, name: str) -> List[Activity]:
        """The device activities that start inside a span ``name`` (each
        span ends after its work is done on the device)."""
        spans = sorted(self.spans.get(name, []))
        starts = [s[0] for s in spans]
        out = []
        for a in self.activities:
            i = bisect.bisect_right(starts, a.start_ns) - 1
            if i >= 0 and a.start_ns <= spans[i][1]:
                out.append(a)
        return out


def union_ns(intervals, lo: int, hi: int) -> int:
    """The length of the union of ``intervals`` clipped to [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def timeline(prof, spans: Dict[str, List[Tuple[int, int]]]) -> Trace:
    """The device work of a finished CUDA-only ``torch.profiler.profile``
    (no host ops recorded, so the host runs at nearly its own speed), with
    the benchmark's spans taken by the host's clock (``time.time_ns``, the
    profiler's time base)."""
    from torch.autograd import DeviceType
    acts = [Activity(e.start_ns(), e.end_ns(), e.name(), -1, -1,
                     not _NOT_KERNELS.match(e.name()))
            for e in prof.profiler.kineto_results.events()
            if e.device_type() != DeviceType.CPU and not e.is_user_annotation()]
    acts.sort(key=lambda a: a.start_ns)
    return Trace(acts, [], {k: [(s, e, -1) for s, e in v]
                            for k, v in spans.items()}, [])


def parse(prof) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile`` that
    recorded the host's ops with their shapes."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    host, device, launches = [], [], {}
    annotations = set()
    for e in events:
        if e.device_type() == DeviceType.CPU:
            host.append(e)
            if e.is_user_annotation():
                annotations.add(e.name())
            if not _LAUNCH.match(e.name()):
                launches[e.correlation_id()] = e     # the op that launched
        else:
            device.append(e)
    acts = []
    for e in device:
        if e.is_user_annotation() or e.name() in annotations:
            continue
        launch = launches.get(e.linked_correlation_id()) \
            if e.linked_correlation_id() > 0 else None
        thread = launch.start_thread_id() if launch is not None else -1
        at = launch.start_ns() if launch is not None else -1
        acts.append(Activity(e.start_ns(), e.end_ns(), e.name(), thread, at,
                             not _NOT_KERNELS.match(e.name())))
    acts.sort(key=lambda a: a.start_ns)
    spans: Dict[str, list] = {}
    ops: List[OpCall] = []
    for e in host:
        if e.name() in SPANS:
            spans.setdefault(e.name(), []).append(
                (e.start_ns(), e.end_ns(), e.start_thread_id()))
        elif e.name().startswith("repro_torch::"):
            ops.append(OpCall(e.name(), e.shapes(), e.dtypes(),
                              e.start_thread_id(), e.start_ns(), e.end_ns()))
    ops = _outermost(ops)
    _infer_launches(acts, ops)
    _attribute(ops, acts)
    host_ops = sorted((e.start_ns(), e.end_ns(), e.name(), e.start_thread_id())
                      for e in host if not _LAUNCH.match(e.name()))
    return Trace(acts, ops, spans, host_ops)


def _infer_launches(acts: List[Activity], ops: List["OpCall"]) -> None:
    """Device work whose launch the trace does not correlate (kernels
    launched through the CUDA runtime linked into the program's own
    libraries) runs in launch order on its stream, so it was launched
    after the work before it and before the work after it, by the thread
    that launched the work before it. Where one of the program's ops
    began on that thread between those two launches, the work is that
    op's; else it takes the midpoint."""
    known = [i for i, a in enumerate(acts) if a.launch_ns >= 0]
    by_thread: Dict[int, List["OpCall"]] = {}
    for c in sorted(ops, key=lambda c: c.start_ns):
        by_thread.setdefault(c.thread, []).append(c)
    starts = {t: [c.start_ns for c in v] for t, v in by_thread.items()}
    k = 0
    for i, a in enumerate(acts):
        if a.launch_ns >= 0:
            continue
        while k + 1 < len(known) and known[k + 1] < i:
            k += 1
        if not known or known[k] > i:
            continue
        prev = acts[known[k]]
        nxt = acts[known[k + 1]] if k + 1 < len(known) else None
        lo = prev.launch_ns
        hi = nxt.launch_ns if nxt is not None else lo + 1
        a.thread = prev.thread
        th, calls = starts.get(a.thread, []), by_thread.get(a.thread, [])
        j = bisect.bisect_right(th, lo)
        if j > 0 and calls[j - 1].end_ns >= lo:      # inside an op already
            a.launch_ns = lo + 1
        elif j < len(th) and th[j] < hi:             # an op began after
            a.launch_ns = th[j] + 1
        else:
            a.launch_ns = (lo + hi) // 2
        a.inferred = True


def _outermost(ops: List[OpCall]) -> List[OpCall]:
    """One event per call: an op event inside another of the same name on
    the same thread (the dispatcher's nested records) is dropped."""
    ops.sort(key=lambda c: (c.thread, c.start_ns, -c.end_ns))
    out: List[OpCall] = []
    for c in ops:
        if out and out[-1].thread == c.thread and out[-1].name == c.name \
                and c.end_ns <= out[-1].end_ns:
            continue
        out.append(c)
    return out


def _attribute(ops: List[OpCall], acts: List[Activity]) -> None:
    by_thread: Dict[int, List[OpCall]] = {}
    for c in ops:
        by_thread.setdefault(c.thread, []).append(c)
    starts = {t: [c.start_ns for c in v] for t, v in by_thread.items()}
    for a in acts:
        calls = by_thread.get(a.thread)
        if not calls:
            continue
        i = bisect.bisect_right(starts[a.thread], a.launch_ns) - 1
        if i >= 0 and calls[i].start_ns <= a.launch_ns <= calls[i].end_ns:
            calls[i].device_ns += a.end_ns - a.start_ns


def host_activities(trace: Trace, times: List[int], thread: int) -> List[str]:
    """The innermost host op running on ``thread`` at each of ``times``
    (sorted), or "host idle": one sweep over the thread's ops, which
    nest."""
    ops = [h for h in trace.host if h[3] == thread]
    out, stack, k = [], [], 0
    for t in times:
        while k < len(ops) and ops[k][0] <= t:
            while stack and stack[-1][1] < ops[k][0]:
                stack.pop()
            stack.append(ops[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host idle")
    return out


def breakdown(tl: Trace, ops: Optional[Trace], lo: int, hi: int) -> dict:
    """The ten device operations that took most time in the timeline's
    [lo, hi]; and, from the ops part, the device's idle time summed by
    what the host's main thread (the one that ran the first span) was
    doing when each gap began, its ten largest."""
    per_op: Dict[str, float] = {}
    for a in tl.activities:
        if a.start_ns >= lo and a.end_ns <= hi:
            per_op[a.name] = per_op.get(a.name, 0.0) + (a.end_ns - a.start_ns) / 1e9
    gaps: Dict[str, float] = {}
    if ops is not None and ops.spans:
        main = min((s for v in ops.spans.values() for s in v))[2]
        olo, ohi = ops.window()
        starts, lengths, busy_until = [], [], olo
        for a in ops.activities:
            if a.end_ns <= olo or a.start_ns >= ohi:
                continue
            if a.start_ns > busy_until:
                starts.append(busy_until)
                lengths.append(a.start_ns - busy_until)
            busy_until = max(busy_until, a.end_ns)
        if ohi > busy_until:
            starts.append(busy_until)
            lengths.append(ohi - busy_until)
        for name, n in zip(host_activities(ops, starts, main), lengths):
            gaps[name] = gaps.get(name, 0.0) + n / 1e9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(per_op), "idle_gaps": top(gaps)}
