"""What the per-layer readers (``portbench/metrics/<name>.py``) share:
the record of a traced run, the model's FLOPs from the configuration's
frozen counts, an op's share of its roofline and the device's idle
share. A reader that finds nothing to read returns None, and the
metric is left out of the result's line."""
from __future__ import annotations

import dataclasses
import importlib
import statistics
from typing import List, Optional, Tuple

from portbench.harness import peaks
from portbench.harness.trace import DTYPE_NAMES, Trace, union_ns


@dataclasses.dataclass
class Run:
    """A traced run: its configuration and traffic; ``ops``, the trace of
    the part of the window whose host ops were recorded with their shapes
    (for the ops' device time and counts); ``timeline``, the CUDA-only
    trace of another part, with the benchmark's spans by the host's clock
    (for launches and idle time, the host near its own speed); and the
    host-clock seconds of the untraced part: train steps, prefills (each
    to its first token on the host)."""
    cfg: dict
    traffic: dict
    ops: Optional[Trace] = None
    timeline: Optional[Trace] = None
    steps: List[float] = dataclasses.field(default_factory=list)
    prefills: List[Tuple[int, int, float]] = dataclasses.field(
        default_factory=list)       # (batch, prompt_len, seconds)


def forward_flops(cfg: dict, batch: int, seq: int, logit_rows: int) -> float:
    """The model's operations in a forward over ``batch`` sequences of
    ``seq`` positions with logits at ``logit_rows`` positions each: two
    per weight a token multiplies (the configuration's frozen
    ``projection_params``; the experts a token is routed to, not those
    it could be), two per unembedding weight at each logit row, and the
    sequence mixing (the SSD recurrence's 4·N·P·H a token, or attention's
    4·d·H a causal pair) in every layer."""
    f = cfg["model_flops"]
    total = 2 * f["projection_params"] * batch * seq
    total += 2 * f["logits_params"] * batch * logit_rows
    if "ssd_per_token" in f:
        total += f["ssd_per_token"] * cfg["n_layers"] * batch * seq
    if "attention_per_pair" in f:
        pairs = seq * (seq + 1) // 2
        total += f["attention_per_pair"] * cfg["n_layers"] * batch * pairs
    return float(total)


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Forward and backward (three forwards' work), recomputation not
    counted."""
    return 3 * forward_flops(cfg, batch, seq, seq)


def _counts(op: str):
    return importlib.import_module(f"portbench.counts.{op.split('::')[1]}")


def op_roofline(run: Run, op: str) -> Optional[float]:
    """The op's least time over its measured device time, summed over its
    calls in the trace, in %: the least time of a call is the larger of
    its operations at the peak of its type and its bytes at the memory's
    peak (``portbench/counts/<op>.py``); its device time is that of every
    kernel launched under it."""
    if run.ops is None:
        return None
    calls = run.ops.calls(op)
    device_s = sum(c.device_ns for c in calls) / 1e9
    if not calls or device_s <= 0:
        return None
    counts = _counts(op)
    least = sum(peaks.least_seconds(counts.flops(c.shapes),
                                    counts.nbytes(c.shapes, c.dtypes),
                                    DTYPE_NAMES.get(c.dtypes[0], "bfloat16"))
                for c in calls)
    return 100.0 * least / device_s


def idle_share(run: Run, span: str) -> Optional[float]:
    """The device's idle share in % inside the ``span``s alone."""
    t = run.timeline
    if t is None or not t.spans.get(span):
        return None
    spans = t.spans[span]
    iv = [(a.start_ns, a.end_ns) for a in t.activities]
    if not iv:
        return None
    busy = sum(union_ns(iv, s, e) for s, e, _ in spans)
    return 100.0 * (1 - busy / sum(e - s for s, e, _ in spans))


def step_idle_share(run: Run, span: str) -> Optional[float]:
    """The device's idle share in % of an untraced step: 1 - the device's
    busy time a traced ``span`` (the union of its work inside each span,
    the mean over the spans) over the median untraced step's host
    seconds. The busy time is the device's own; the profiler slows the
    host inside the traced spans, so their length is not the step's."""
    t = run.timeline
    if t is None or not t.spans.get(span) or not run.steps:
        return None
    iv = [(a.start_ns, a.end_ns) for a in t.activities]
    if not iv:
        return None
    spans = t.spans[span]
    busy_s = sum(union_ns(iv, s, e) for s, e, _ in spans) / len(spans) / 1e9
    return 100.0 * (1 - busy_s / statistics.median(run.steps))
