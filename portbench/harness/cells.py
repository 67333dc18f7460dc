"""One run of one cell: set-up, the measured window, the comparison.

Set-up makes the weights and the inputs from the seed, builds the
program's model and step, and warms every shape the cell's traffic uses
(training: the first three steps, which the comparison also reads;
serving: a prefill and a decode step at each prompt length). The window
then runs for ``seconds``; with ``trace`` a fixed part of it runs under
``torch.profiler`` and the rest gives the host-clock spans the per-layer
readers need. After the window the peak memory is read, the program's
state is freed, and the reference runs.

``wrap`` (tests and the control script only) wraps the program's train
step or its (prefill, decode) pair: the timed path broken underneath.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import random
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.harness import compare, program
from portbench.harness import stats as S
from portbench.harness import traffic as T
from portbench.harness import weights as W
from portbench.harness.manifest import Cell
from portbench.harness.readers import Run
from portbench.harness.trace import parse, timeline


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    setup_s: float
    end_to_end: dict            # name -> value (untraced runs)
    readings: dict              # compared numbers
    run: Optional[Run] = None   # traced runs: what the readers read
    memory_peak_bytes: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """The traced parts of a window: an ``ops`` part, whose host ops are
    recorded with their shapes (the program's ops' device time and
    counts), and a ``timeline`` part, traced on the device alone with the
    benchmark's spans by the host's clock (launches, busy and idle time at
    nearly the host's own speed)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.profs: dict = {}
        self.stopped: set = set()
        self.spans: dict = {}

    def start(self, part: str) -> None:
        cuda = self.device.type == "cuda"
        if part == "ops":
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if cuda else [])
            prof = profile(activities=acts, record_shapes=True)
        else:
            prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                       else ProfilerActivity.CPU])
        prof.start()
        self.profs[part] = prof

    def stop(self, part: Optional[str]) -> None:
        if part in self.profs and part not in self.stopped:
            self.profs[part].stop()
            self.stopped.add(part)

    def span(self, name: str, part: Optional[str]):
        """A context around one call: a profiler range in the ops part, a
        host-clock span in the timeline part, nothing elsewhere."""
        if part == "ops":
            return record_function(name)
        if part == "timeline":
            return _Span(self.spans.setdefault(name, []))
        return contextlib.nullcontext()

    def run(self, cfg: dict, traffic: dict, **spans) -> Run:
        ops = self.profs.get("ops")
        tl = self.profs.get("timeline")
        return Run(cfg, traffic, parse(ops) if ops is not None else None,
                   timeline(tl, self.spans) if tl is not None else None,
                   **spans)


class _Span:
    def __init__(self, into: list):
        self.into = into

    def __enter__(self):
        self.t = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.into.append((self.t, time.time_ns()))
        return False


def _free(device: torch.device) -> int:
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return peak


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------
def first_steps(cell: Cell, seed: int, device: torch.device,
                wrap: Optional[Callable] = None):
    """The program's model and step from the seed, driven through the
    first three steps by the window's own call on the window's own
    batches -> (step function, state, the readings of those steps)."""
    cfg, tr = cell.config, cell.traffic
    a = program.arch(cfg)
    mdl = program.model(a, W.make(compare.family(cfg).param_spec(cfg), seed,
                                  device), device)
    step, state = program.trainer(a, tr, mdl)
    if wrap is not None:
        step = wrap(step)
    order = compare.names(cfg)
    got = {"loss": []}
    for i in range(compare.FIRST_STEPS):
        state, m = step(state, T.train_batch(tr, cfg, seed, i, device))
        got["loss"].append(float(m["loss"]))
        if i == 0:
            mu, b1 = program.first_moments(state), tr["optimizer"]["b1"]
            g = {n: mu[n].double() / (1 - b1) for n in order}
            got["grad"] = torch.stack([g[n].norm() for n in order]).cpu()
            got["sketch"] = compare.sketch(g, order, seed, device)
            del g
    got["change"] = compare.change_norms(cfg, program.parameters(state),
                                         seed, device)
    return step, state, got


def train(cell: Cell, seed: int, seconds: float, trace: bool,
          device: torch.device, t_start: float,
          wrap: Optional[Callable] = None) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    step, state, got = first_steps(cell, seed, device, wrap)
    _sync(device)
    setup_s = time.perf_counter() - t_start

    tc = tr["trace"]
    parts = {}                        # window step -> traced part
    if trace:
        parts.update({1 + j: "ops" for j in range(tc["op_steps"])})
        parts.update({1 + tc["op_steps"] + j: "timeline"
                      for j in range(tc["timeline_steps"])})
    last = max(parts, default=-1)
    tracer, untraced, attempted, failed = Tracer(device), [], 0, 0
    i, t0 = compare.FIRST_STEPS, time.perf_counter()
    while True:
        k = i - compare.FIRST_STEPS
        part = parts.get(k)
        if part is not None and parts.get(k - 1) != part:
            tracer.start(part)
        s = time.perf_counter()
        with tracer.span("portbench.step", part):
            state, m = step(state, T.train_batch(tr, cfg, seed, i, device))
            loss = float(m["loss"])        # the host waits for the step
        e = time.perf_counter()
        if part is not None and parts.get(k + 1) != part:
            tracer.stop(part)
        if part is None:
            untraced.append(e - s)
        attempted += 1
        failed += not math.isfinite(loss)
        i += 1
        if e - t0 >= seconds and k >= last:
            break
    window_s = time.perf_counter() - t0
    del state, step, m
    peak = _free(device)

    ref = compare.reference_train(cfg, tr, seed, device)
    out = Outcome(attempted, failed, setup_s,
                  {"train_tokens_per_s": S.rate(
                      attempted * tr["batch"] * tr["seq"], window_s)},
                  compare.train_readings(got, ref), memory_peak_bytes=peak)
    if trace:
        out.run = tracer.run(cfg, tr, steps=untraced)
    _free(device)
    return out


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Served:
    req: T.Request
    wait_s: float                 # from its arrival to its prefill's start
    ttft_s: float                 # from its arrival to its first token
    gaps_s: List[float]
    tokens: np.ndarray            # [batch, output_tokens]
    done_s: float                 # from the window's start to its last token


def serve_setup(cell: Cell, seed: int, device: torch.device,
                wrap: Optional[Callable] = None):
    """The program's model from the seed's weights and its (prefill,
    decode) pair for each prompt length of the traffic, each length
    warmed by a prefill and a decode step -> (model, {length: pair})."""
    cfg, tr = cell.config, cell.traffic
    n_out = tr["output_tokens"]
    a = program.arch(cfg)
    mdl = program.model(a, W.make(compare.family(cfg).param_spec(cfg), seed,
                                  device), device)
    steps = {L: program.server(a, tr, L + n_out) for L in T.lengths(tr)}
    if wrap is not None:
        steps = {L: wrap(*pd) for L, pd in steps.items()}
    for L, (prefill, decode) in steps.items():
        p = torch.randint(0, cfg["vocab_size"], (tr["batch"], L),
                          generator=W.generator(device, seed, "warm", L),
                          device=device)
        logits, cache = prefill(mdl, {"tokens": p})
        tok = logits.argmax(-1)[:, None]
        logits, cache = decode(mdl, cache, tok, L)
        logits.argmax(-1).cpu()
        del cache
    _sync(device)
    return mdl, steps


def serve_window(cell: Cell, mdl, steps, reqs: List[T.Request], prompts,
                 device: torch.device, trace: bool):
    """Sends ``reqs`` open-loop from now, each at its arrival, and serves
    them one after another: the prefill, then a decode step a token, each
    token read on the host. -> (served, the untraced prefills as (batch,
    prompt_len, seconds), the ``Tracer``)."""
    tr = cell.traffic
    n_out, tc = tr["output_tokens"], tr["trace"]
    parts = {}                     # request index -> (part, decode steps)
    if trace:
        for j in range(tc["timeline_requests"]):
            parts[j] = ("timeline", tc["timeline_decode_steps"])
        r1 = tc["timeline_requests"]
        for j in range(tc["op_requests"]):
            parts[r1 + j] = ("ops", tc["op_decode_steps"])
    tracer, served, prefills = Tracer(device), [], []
    t0 = time.perf_counter()
    for r in reqs:
        due = t0 + r.arrival_s
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        prefill, decode = steps[r.prompt_len]
        part, n_traced = parts.get(r.index, (None, 0))
        if part is not None:
            tracer.start(part)
        s = time.perf_counter()
        with tracer.span("portbench.prefill", part):
            logits, cache = prefill(mdl, {"tokens": prompts[r.index]})
            tok = logits.argmax(-1)[:, None]
            host = [tok.cpu()]
        times = [time.perf_counter()]
        if part is None:
            prefills.append((tr["batch"], r.prompt_len, times[0] - s))
        for j in range(n_out - 1):
            if j == n_traced:
                tracer.stop(part)
            on = part if j < n_traced else None
            with tracer.span("portbench.decode", on):
                logits, cache = decode(mdl, cache, tok, r.prompt_len + j)
                tok = logits.argmax(-1)[:, None]
                host.append(tok.cpu())
            times.append(time.perf_counter())
        tracer.stop(part)
        del cache, logits
        served.append(Served(r, s - due, times[0] - due,
                             list(np.diff(times)),
                             torch.cat(host, dim=1).numpy(), times[-1] - t0))
    return served, prefills, tracer


def serve(cell: Cell, seed: int, seconds: float, trace: bool,
          device: torch.device, t_start: float,
          wrap: Optional[Callable] = None,
          controls: Sequence[str] = ()) -> Outcome:
    cfg, tr = cell.config, cell.traffic
    mdl, steps = serve_setup(cell, seed, device, wrap)
    reqs = T.requests(tr, seed, seconds)
    prompts = {r.index: T.prompt(tr, cfg, seed, r, device) for r in reqs}
    _sync(device)
    setup_s = time.perf_counter() - t_start
    served, prefills, tracer = serve_window(cell, mdl, steps, reqs,
                                            prompts, device, trace)
    del mdl, steps
    peak = _free(device)

    sample = _sample(served, tr["check"]["requests"], seed)
    ref = compare.reference_logit_gaps(cfg, tr, seed, device,
                                       [(x.req, x.tokens) for x in sample],
                                       controls)
    gaps = [g for x in served for g in x.gaps_s]
    e2e = {"ttft_ms_p95": 1e3 * S.percentile([x.ttft_s for x in served], 95),
           "itl_ms_p95": 1e3 * S.percentile(gaps, 95)}
    out = Outcome(len(reqs), len(reqs) - len(served), setup_s, e2e,
                  {k: v for k, v in ref.items() if k != "tokens"},
                  memory_peak_bytes=peak)
    if trace:
        out.run = tracer.run(cfg, tr, prefills=prefills)
    _free(device)
    return out


def _sample(served: List[Served], n: int, seed: int) -> List[Served]:
    """``n`` finished requests drawn from the seed, the one with the
    longest prompt among them."""
    longest = max(served, key=lambda x: (x.req.prompt_len, -x.req.index))
    rest = [x for x in served if x is not longest]
    rng = random.Random(W.sub_seed(seed, "check"))
    return [longest] + rng.sample(rest, min(n - 1, len(rest)))
