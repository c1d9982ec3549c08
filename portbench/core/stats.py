"""Arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of ``values`` by linear interpolation between
    the closest ranks (numpy's default), over all of them."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def intervals_from_marks(marks_ms: Sequence[float]) -> List[float]:
    """Consecutive differences of increasing time marks: the mark before the
    first step, then one at the end of each step."""
    return [b - a for a, b in zip(marks_ms, marks_ms[1:])]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def rate(units: float, seconds: float) -> float:
    """Units of work per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return units / seconds
