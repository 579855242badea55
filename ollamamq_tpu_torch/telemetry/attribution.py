"""Per-request latency attribution: where did this request's time go?

Builds phase timelines from the lifecycle span events the engine already
drops into each request's Trace (telemetry/tracing.py). Consecutive
events define contiguous spans — gapless by construction — so summing
the spans opened by each phase's events reconstructs the wall-clock
end-to-end latency EXACTLY (the /debug/requests/{id} contract: phases
sum to e2e within tolerance; the tolerance only absorbs float noise).

The phase vocabulary is deliberately small and closed: every event name
the engine emits maps to one of PHASES, and scripts/check_metrics_docs.py
pins this module's PHASES against the README phase table the same way it
pins the metric registry — no silently undocumented phase.

Stdlib-only, like the rest of telemetry: imported by the doc checker and
by worker hosts with no jax.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ollamamq_tpu_torch.telemetry import schema as tm

# Canonical attribution phases, in lifecycle order. "other" catches spans
# opened by event names this table does not know — a nonzero "other" in a
# timeline means an engine event was added without updating EVENT_PHASE
# (and the doc gate makes that loud).
PHASES = (
    "queue",         # fair-share queue wait: enqueue/requeue -> admit
    "admission",     # scheduler placement + runtime pending queue
    "prefix_cache",  # prefix-cache lookup/pin on a cache-hit admission
    "prefill",       # prompt forward(s): batched, chunked, or sp
    "decode",        # token generation: first token -> finish
    "stream",        # stream-write stall: consumer not draining tokens
    "other",
)

# Event name -> phase of the span that event OPENS (the span lasts until
# the next event). Terminal events open no span.
EVENT_PHASE = {
    "enqueue": "queue",
    "requeue": "queue",
    "admit": "admission",
    "place": "admission",
    "prefix_hit": "prefix_cache",
    "prefill": "prefill",
    "prefill_chunk": "prefill",
    "embed_batch": "prefill",
    "first_token": "decode",
    "decode": "decode",
    "stream_stall": "stream",
    "stream_resume": "decode",
    # Graceful degradation: a preempted request heads back to the queue
    # (its recompute wait is queue time), a retry waits out its backoff
    # in the queue, and a page-starved slot holding its reservation is
    # still inside generation.
    "preempt": "queue",
    "retry": "queue",
    "kv_stall": "decode",
    # Fleet-router spans (tracing.ROUTER_EVENTS): a failover opens the
    # recompute-replay wait (queue time until the re-dispatch lands); an
    # overflow span is the cross-tier placement decision; a migration or
    # regroup evacuation happens mid-decode — the stream keeps decoding
    # on the target, so those spans stay in the decode phase.
    "failover": "queue",
    "overflow": "admission",
    "migrate": "decode",
    "regroup": "decode",
}

TERMINAL_EVENTS = ("stop", "length", "cancelled", "error",
                   "kv_exhausted", "deadline")


def phase_of(event_name: str) -> str:
    return EVENT_PHASE.get(event_name, "other")


def phase_totals(events: List[tuple], now: Optional[float] = None) -> Dict[str, float]:
    """Per-phase milliseconds from a trace's (name, t, args) event list.

    The span opened by event i is attributed to phase_of(events[i]) and
    closed by events[i+1]; for an unfinished trace the last event's span
    runs to `now`. Terminal events close the chain and open nothing, so
    sum(phase_totals.values()) == (end - events[0].t) exactly.
    """
    out: Dict[str, float] = {}
    if not events:
        return out
    for i, (name, t, _args) in enumerate(events):
        if name in TERMINAL_EVENTS:
            break
        if i + 1 < len(events):
            end = events[i + 1][1]
        elif now is not None:
            end = max(now, t)
        else:
            break  # unfinished trace and no "now": last span unknowable
        dur = (end - t) * 1e3
        if dur <= 0:
            continue
        ph = phase_of(name)
        out[ph] = out.get(ph, 0.0) + dur
    return out


def observe_phases(model: str, events: List[tuple]) -> None:
    """Fold a finished trace's phase totals into the
    ollamamq_request_phase_ms histogram (called by Tracer._finished)."""
    for phase, ms in phase_totals(events).items():
        tm.REQUEST_PHASE_MS.labels(model=model or "?", phase=phase).observe(ms)


def _outcome(events: List[tuple]) -> Optional[str]:
    if events and events[-1][0] in TERMINAL_EVENTS:
        return events[-1][0]
    return None


def timeline(trace, now: Optional[float] = None,
             include_events: bool = True) -> dict:
    """Full JSON-able timeline for one request (/debug/requests/{id}).

    `trace` is a telemetry.tracing.Trace; its events list is copied (the
    engine thread may still be appending). Timestamps are reported
    relative to the request's enqueue event, in milliseconds.
    """
    if now is None:
        now = time.monotonic()
    events = list(trace.events)
    outcome = _outcome(events)
    t0 = events[0][1] if events else now
    end = events[-1][1] if outcome is not None else now
    phases = phase_totals(events, now=now)
    out = {
        "req_id": trace.req_id,
        "user": trace.user,
        "model": trace.model,
        "kind": trace.kind,
        "state": outcome or "inflight",
        "e2e_ms": round((end - t0) * 1e3, 3),
        "phases_ms": {p: round(phases[p], 3) for p in PHASES if p in phases},
        "dropped_events": trace.dropped,
    }
    if outcome is None and events:
        last_name, last_t, _ = events[-1]
        out["current_phase"] = phase_of(last_name)
        out["phase_age_ms"] = round((now - last_t) * 1e3, 3)
    if include_events:
        out["events"] = [
            {"name": name, "t_ms": round((t - t0) * 1e3, 3),
             **({"args": args} if args else {})}
            for name, t, args in events
        ]
    return out


def summarize(tracer, recent: int = 50) -> dict:
    """Compact listing for GET /debug/requests: every in-flight request
    plus the most recent `recent` finished traces, newest first."""
    now = time.monotonic()
    inflight, finished = [], []
    for tr in tracer.traces():
        row = timeline(tr, now=now, include_events=False)
        (finished if tr.finished else inflight).append(row)
    finished.sort(key=lambda r: r["req_id"], reverse=True)
    return {"inflight": inflight, "recent": finished[:max(0, recent)]}
