"""The benchmark's arithmetic: percentiles and interval unions."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by the nearest rank: the smallest sample
    with at least q% of the samples at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def beyond(values, q: float) -> int:
    """How many samples lie above the q-th percentile."""
    p = percentile(values, q)
    return sum(1 for x in values if x > p)


def union(intervals):
    """Merge (start, end) intervals; returns the sorted disjoint list."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return [tuple(x) for x in out]


def covered(intervals, lo: float, hi: float) -> float:
    """Length of the union of `intervals` clipped to [lo, hi]."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in union(intervals))


def gaps(intervals, lo: float, hi: float):
    """The parts of [lo, hi] that no interval covers, as (start, end)."""
    out, at = [], lo
    for s, e in union(intervals):
        if e <= lo or s >= hi:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out
