"""Statistics over all samples of a window, and the harness's host spans."""
from __future__ import annotations

import contextlib
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile over every sample (linear between the two nearest
    ranks, numpy's default); None for no samples."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals, overlaps counted once."""
    total = 0.0
    end = None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out = []
    t = lo
    for a, b in sorted(intervals):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


class Spans:
    """Host spans (name, start, end) around the harness's calls into the
    program, on the monotonic host clock. Every call ends in a pull from the
    device, so a span holds the call's device work."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        yield
        self.items.append((name, t0, time.perf_counter()))

    def durations(self, name: str, lo: float = float("-inf"),
                  hi: float = float("inf")) -> List[float]:
        """Seconds of each `name` span that lies inside [lo, hi]."""
        return [b - a for n, a, b in self.items if n == name and a >= lo and b <= hi]
