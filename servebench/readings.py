"""The arithmetic the metric readers share (stdlib only). Times are the
host's monotonic clock, as the load generator and the engine read it.

A request's time to first token runs from when it was due (not when it
was sent) to its first streamed token. One with no token by the window's
close counts its wait so far; a failed one counts as the worst wait the
window allows, its whole length.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

from servebench import counts, stats


def ttft_ms(run, reqs: Iterable[dict]) -> List[float]:
    worst = run.seconds * 1e3
    out = []
    for q in reqs:
        if q["error"]:
            out.append(worst)
            continue
        first, _, _ = stats.first_last(q["frames"], run.t1)
        t = first if first is not None else run.t1
        out.append((t - q["due_at"]) * 1e3)
    return out


def tpot_ms(run, reqs: Iterable[dict]) -> List[float]:
    """(last - first token) / (tokens - 1) over what each request streamed
    by the close; a failed request counts as the window's length."""
    out = []
    for q in reqs:
        if q["error"]:
            out.append(run.seconds * 1e3)
            continue
        gap = stats.per_token_gap(*stats.first_last(q["frames"], run.t1))
        if gap is not None:
            out.append(gap * 1e3)
    return out


def p95(values: List[float]) -> Optional[float]:
    return stats.percentile(values, 95.0)


def queue_wait_ms(run, users: Optional[set] = None) -> List[float]:
    """The engine's RequestStats: from enqueue to the start of the
    request's prefill (or the close, when it had not started), for every
    request enqueued inside the window."""
    out = []
    for r in run.engine_requests or []:
        if not run.t0 <= r["enqueued_at"] <= run.t1:
            continue
        if users is not None and r["user"] not in users:
            continue
        start = r["prefill_started_at"] or run.t1
        out.append((min(start, run.t1) - r["enqueued_at"]) * 1e3)
    return out


def window_flops(run) -> Tuple[float, float]:
    """(prefill FLOPs, decode FLOPs) of the work the window completed: the
    prompts whose first token streamed by the close, and every later token
    streamed by then (token k of a reply is computed from position
    P + k - 1 over a context of P + k)."""
    a = run.arch
    layer = 2.0 * a["L"] * counts.layer_active_params(a)
    attn = 4.0 * a["L"] * a["H"] * a["hd"]
    head = 2.0 * a["V"] * a["D"]
    pre = dec = 0.0
    for q in run.requests:
        first, _, n = stats.first_last(q["frames"], run.t1)
        if first is None:
            continue
        P = q["prompt_tokens"]
        pre += counts.prefill_flops(a, P)
        m = n - 1  # decoded tokens after the first
        if m > 0:
            # sum over k = 1..m of the context P + k
            dec += m * (layer + head) + attn * (m * P + m * (m + 1) / 2.0)
    return pre, dec


def share_of_peak(run, flops: float) -> Optional[float]:
    """FLOPs over the window's seconds x the card's bf16 peak, in %."""
    if not run.peaks:
        return None
    return 100.0 * flops / (run.seconds * run.peaks[0] * run.cell.chips)


def roofline(run, range_name: str, calls) -> Optional[float]:
    """The least time the slice's attention calls of one kind need, over
    the device time of the kernels launched inside them, in %. `calls`
    gives (FLOPs, bytes) per recorded dispatch and the number of calls
    (one per layer and step) it made. None when the slice holds no such
    call, or its calls and the trace's ranges do not pair up."""
    tr = run.trace
    if not tr or not run.peaks or not calls:
        return None
    n_calls = sum(n for _, _, n in calls)
    device_s = tr["by_range"].get(range_name, 0.0)
    if n_calls == 0 or device_s <= 0 or tr["range_counts"].get(range_name) != n_calls:
        return None
    least = sum(counts.least_seconds(f, b, *run.peaks) * n for f, b, n in calls)
    return 100.0 * least / device_s
