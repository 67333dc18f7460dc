"""What the readers of the program's own spans share.

While a profiler records, ``repro_torch.tracing`` mirrors each of the
program's spans into the trace as a range ``repro_torch.<name>`` (the
backward part of a span ``repro_torch.<name>.backward``), on the thread
that ran it: the host ops of the ``ops`` part (``Trace.host``). A device
activity belongs to the innermost program range open on its thread when
the host launched it, and to the ranges around that one out to the
first backward part that holds a range of the forward phase: under
remat a layer runs again (its recompute ranges, named as in the
forward) inside the backward part of whichever op's saved tensors
autograd unpacked first, and that work is the recomputed ranges', not
the backward part's. An activity counts once, however many of the
ranges asked for it belongs to. A share's base, the step's device
seconds, is the device time of every activity launched, on any thread,
inside the benchmark's ``portbench.step`` spans.

The program also keeps its spans and counters in memory, by
``time.time_ns``, the clock of the harness's spans. They are read from
the program's ``repro_torch.tracing`` as the adapter
(``harness/program.py``) loaded it with the program: this module
imports nothing of the program, and a program without that module (one
older than its spans) gives None, as does a trace without the ranges
asked for.
"""
from __future__ import annotations

import bisect
import sys
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from portbench.harness.trace import Activity, Trace, union_ns

PREFIX = "repro_torch."
BACKWARD = ".backward"
STEP = "portbench.step"
PROGRAM_RECORD = "repro_torch.tracing"

Ranges = Dict[int, List[Tuple[int, int]]]        # thread -> (start, end)


def _merged(iv: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def program_ranges(trace: Trace) -> Dict[int, List[Tuple[int, int, str]]]:
    """The program's ranges per thread, as (start, end, name less the
    prefix), each before the ranges inside it."""
    by_thread: Dict[int, List[Tuple[int, int, str]]] = {}
    for s, e, name, thread in trace.host:
        if name.startswith(PREFIX):
            by_thread.setdefault(thread, []).append(
                (s, e, name[len(PREFIX):]))
    for v in by_thread.values():
        v.sort(key=lambda r: (r[0], -r[1]))
    return by_thread


def open_at(trace: Trace, acts: Iterable[Activity]
            ) -> Iterator[Tuple[Activity, List[str]]]:
    """Each activity with the names of the program's ranges open on its
    thread at its launch, innermost first: one sweep a thread."""
    ranges = program_ranges(trace)
    by_thread: Dict[int, List[Activity]] = {}
    for a in acts:
        by_thread.setdefault(a.thread, []).append(a)
    for thread, mine in by_thread.items():
        rs, i, live = ranges.get(thread, []), 0, []
        for a in sorted(mine, key=lambda a: a.launch_ns):
            while i < len(rs) and rs[i][0] <= a.launch_ns:
                live.append(rs[i])
                i += 1
            live = [r for r in live if r[1] >= a.launch_ns]
            yield a, [r[2] for r in reversed(live)]


def belongs(chain: List[str], names: Set[str]) -> bool:
    """Whether an activity launched inside the program's ranges
    ``chain`` (innermost first) belongs to one of the spans ``names``,
    in any phase: walking outwards, one of them comes before a backward
    part that holds a range of the forward phase (a recompute)."""
    inner_forward = False
    for name in chain:
        backward = name.endswith(BACKWARD)
        if backward and inner_forward:
            return False
        if (name[:-len(BACKWARD)] if backward else name) in names:
            return True
        inner_forward = not backward
    return False


def op_ranges(trace: Trace, prefix: str) -> Ranges:
    """The calls of the program's ops whose name starts with ``prefix``,
    per thread."""
    by_thread: Ranges = {}
    for c in trace.ops:
        if c.name.startswith(prefix):
            by_thread.setdefault(c.thread, []).append((c.start_ns, c.end_ns))
    return {t: _merged(v) for t, v in by_thread.items()}


def _inside(r: Ranges, thread: int, at: int) -> bool:
    iv = r.get(thread)
    if not iv:
        return False
    i = bisect.bisect_right(iv, (at, float("inf"))) - 1
    return i >= 0 and iv[i][0] <= at <= iv[i][1]


def in_steps(trace: Trace) -> List[Activity]:
    """The activities launched, on any thread, inside a ``portbench.step``
    span."""
    steps = _merged((s, e) for s, e, _ in trace.spans.get(STEP, []))
    starts = [s for s, _ in steps]
    out = []
    for a in trace.activities:
        if a.launch_ns < 0:
            continue
        i = bisect.bisect_right(starts, a.launch_ns) - 1
        if i >= 0 and a.launch_ns <= steps[i][1]:
            out.append(a)
    return out


def device_s(acts: Iterable[Activity]) -> float:
    return sum(a.end_ns - a.start_ns for a in acts) / 1e9


def step_share(trace: Optional[Trace], names: Iterable[str],
               minus_ops: Optional[str] = None) -> Optional[float]:
    """The device seconds that belong to the program's spans ``names``
    (less those launched inside the program's ops whose name starts
    with ``minus_ops``), in % of the step's device seconds; None without
    a trace, its steps or those ranges."""
    if trace is None:
        return None
    names = set(names)
    want = {PREFIX + n + part for n in names for part in ("", BACKWARD)}
    step = in_steps(trace)
    total = device_s(step)
    if total <= 0 or not any(h[2] in want for h in trace.host):
        return None
    acts = [a for a, chain in open_at(trace, step) if belongs(chain, names)]
    if minus_ops is not None:
        skip = op_ranges(trace, minus_ops)
        acts = [a for a in acts if not _inside(skip, a.thread, a.launch_ns)]
    return 100.0 * device_s(acts) / total


def program_record():
    """The program's ``repro_torch.tracing`` as loaded with the program,
    or None."""
    # Read from sys.modules for now, so that the adapter stays the one
    # module of the benchmark that imports the program (as
    # test_portbench_imports.py holds); a plain import waits for a
    # benchmark change that names this module there as well.
    return sys.modules.get(PROGRAM_RECORD)


def counters_in(run, name: str, span: str = STEP) -> list:
    """The program's counters ``name`` recorded inside the harness's
    ``span``s of either traced part."""
    rec = program_record()
    if rec is None:
        return []
    windows = [(s, e) for t in (run.ops, run.timeline) if t is not None
               for s, e, _ in t.spans.get(span, [])]
    return [c for c in rec.counters() if c.name == name
            and any(lo <= c.at_ns <= hi for lo, hi in windows)]


def host_share(run, name: str, window: str, caller: str) -> Optional[float]:
    """The share, in %, of the timeline part's ``window`` spans during
    which the thread that ran the program's ``caller`` spans inside them
    was inside the program's ``name`` spans (the in-memory record)."""
    rec, t = program_record(), run.timeline
    if rec is None or t is None or not t.spans.get(window):
        return None
    windows = [(s, e) for s, e, _ in t.spans[window]]
    spans = rec.spans()
    threads = {s.thread for s in spans if s.name == caller and any(
        lo <= s.start_ns and s.end_ns <= hi for lo, hi in windows)}
    iv = [(s.start_ns, s.end_ns) for s in spans
          if s.name == name and s.thread in threads]
    if not iv:
        return None
    inside = sum(union_ns(iv, lo, hi) for lo, hi in windows)
    return 100.0 * inside / sum(hi - lo for lo, hi in windows)
