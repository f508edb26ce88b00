"""Plain arithmetic the benchmark reports with: percentiles and the union
of time intervals."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of `values`, linear between the
    two nearest ranks (numpy's default "linear" method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    if not 0 <= q <= 100:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge_intervals(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint (start, end) intervals covering the same points as
    `intervals`; empty and reversed ones are dropped."""
    out: list[list[float]] = []
    for s, e in sorted((s, e) for s, e in intervals if e > s):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals, lo: float | None = None,
                 hi: float | None = None) -> float:
    """Length of the union of `intervals`, clipped to [lo, hi] when given:
    overlapping intervals count once."""
    total = 0.0
    for s, e in merge_intervals(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        total += max(0.0, e - s)
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers, in order."""
    out, cur = [], lo
    for s, e in merge_intervals(intervals):
        if e <= lo or s >= hi:
            continue
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out
