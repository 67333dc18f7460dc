"""The statistics of a run: a rate over the whole window, and quantiles
over every sample, as Python's ``statistics.quantiles`` gives them."""
from __future__ import annotations

import statistics
from typing import Sequence


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window: all the work completed in
    it over all of its time, stalls included."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return work / seconds


def median(samples: Sequence[float]) -> float:
    if not samples:
        raise ValueError("no samples")
    return statistics.median(samples)


def percentile(samples: Sequence[float], q: int) -> float:
    """The q-th percentile (1 <= q <= 99) over all samples, by
    ``statistics.quantiles(n=100)`` (the exclusive method); a single
    sample is its own percentile."""
    if not samples:
        raise ValueError("no samples")
    if len(samples) == 1:
        return float(samples[0])
    return statistics.quantiles(samples, n=100)[q - 1]
