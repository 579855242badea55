"""Percentiles and window rates (stdlib only).

A percentile is linearly interpolated between the two nearest ranks
(numpy's default, Hyndman-Fan type 7).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Tuple


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The q-th percentile (0 <= q <= 100) of `values`, interpolated
    between the nearest ranks; None for no values. +inf sorts last."""
    xs = sorted(values)
    if not xs:
        return None
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile {q} outside [0, 100]")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    if frac == 0.0 or xs[lo] == xs[hi]:
        return xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * frac


def rate_in_window(events: Iterable[Tuple[float, float]], t0: float,
                   t1: float) -> float:
    """Sum of the amounts of (time, amount) events with t0 <= time <= t1,
    over the window's seconds."""
    if t1 <= t0:
        raise ValueError("empty window")
    return sum(n for t, n in events if t0 <= t <= t1) / (t1 - t0)


def first_last(frames: Sequence[Tuple[float, int]], t_end: float
               ) -> Tuple[Optional[float], Optional[float], int]:
    """(time of the first frame, time of the last frame, tokens) over a
    request's frames that arrived by t_end."""
    inside = [(t, n) for t, n in frames if t <= t_end]
    if not inside:
        return None, None, 0
    return inside[0][0], inside[-1][0], sum(n for _, n in inside)


def per_token_gap(t_first: Optional[float], t_last: Optional[float],
                  tokens: int) -> Optional[float]:
    """(last token - first token) / (tokens - 1), or None under 2 tokens."""
    if t_first is None or tokens < 2:
        return None
    return (t_last - t_first) / (tokens - 1)


def sorted_desc(pairs: Iterable[Tuple[str, float]], n: int) -> List[list]:
    """The n largest (name, value) pairs, largest first, as lists."""
    return [[k, v] for k, v in sorted(pairs, key=lambda kv: -kv[1])[:n]]
