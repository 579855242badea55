"""Request-lifecycle tracing: span events per request, bounded ring.

Every request the engine accepts carries a Trace; the engine drops span
events at each lifecycle boundary (enqueue -> admit -> place -> prefill
[per chunk] -> first_token -> decode [sampled] -> stop/cancelled/error).
Consecutive events define contiguous phase spans — gapless by
construction — so a wedged or slow request reads straight off the
timeline in chrome://tracing / Perfetto via GET /debug/trace.

Finished traces live in a bounded ring (oldest evicted); in-flight
traces are exported too — those are exactly the ones an operator
debugging a wedge needs to see.

Fleet-wide distributed tracing: the ROUTER mints a fleet-stable trace
context (a `traceparent`-style id) at admission and propagates it to
every member attempt — in-process for LocalMember, as the TRACEPARENT
header for HttpMember — so each process's spans carry the same ctx and
`GET /debug/trace/{rid}` on the router can stitch them into ONE
timeline under the client's stable rid. Cross-process timestamps rebase
through each process's wall clock (same-host fleets share it; skew on a
multi-host fleet shows up as span overlap, never a lost span).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional

from ollamamq_tpu_torch.telemetry import attribution
from ollamamq_tpu_torch.telemetry import schema as tm

# Per-trace event cap: a 100k-token generation must not grow its trace
# unboundedly. Terminal events always land (the chain must end).
MAX_EVENTS = 256
# Sample cadence for decode-progress events after the first token.
DECODE_EVENT_EVERY = 16

# Propagation header for HttpMember requests (W3C traceparent shape:
# version-traceid-spanid-flags). The member's enqueue path adopts it so
# its spans stitch under the router's fleet-stable context.
TRACEPARENT_HEADER = "traceparent"

# The CLOSED vocabulary of span events the FLEET ROUTER drops into a
# request's trace (members keep the engine's phase vocabulary —
# prefill/first_token/decode/... — pinned by the attribution table).
# scripts/check_metrics_docs.py pins this tuple against the README
# router-span table the same way it pins phases: a router decision site
# that emits an undocumented span name fails tier-1 CI.
ROUTER_EVENTS = (
    "enqueue",      # admitted into the router's fair-share queue
    "admit",        # popped for placement
    "requeue",      # returned to the queue front (unplaceable/failover)
    "place",        # member chosen (carries the placement overhead_ms)
    "first_token",  # first client-visible token forwarded
    "overflow",     # placed cross-tier (per-tier SLO burn / empty tier)
    "failover",     # re-dispatched after a member death (recompute replay)
    "migrate",      # KV state shipped to another member (zero recompute)
    "regroup",      # evacuated off a member that is changing tiers
)


def mint_ctx() -> str:
    """Fleet-stable trace context, traceparent-shaped:
    00-<32hex trace id>-<16hex span id>-01."""
    return f"00-{os.urandom(16).hex()}-{os.urandom(8).hex()}-01"


def valid_ctx(ctx) -> bool:
    if not isinstance(ctx, str):
        return False
    parts = ctx.split("-")
    return (len(parts) == 4 and len(parts[1]) == 32
            and len(parts[2]) == 16
            and all(all(c in "0123456789abcdef" for c in p)
                    for p in parts))


class Trace:
    __slots__ = ("req_id", "user", "model", "kind", "events", "dropped",
                 "finished", "outcome", "ctx", "origin", "metered",
                 "_tracer")

    def __init__(self, tracer: "Tracer", req_id: int, user: str, model: str,
                 kind: str, ctx: Optional[str] = None, metered: bool = True):
        self._tracer = tracer
        self.req_id = req_id
        self.user = user
        self.model = model
        self.kind = kind
        # Fleet trace context: adopted from the router/client when
        # propagated, minted fresh at the root otherwise — the key the
        # cross-process stitcher matches member spans on.
        self.ctx = ctx if valid_ctx(ctx) else mint_ctx()
        self.origin = tracer.origin
        # False for a LocalMember attempt sharing the router's process:
        # the router's root trace already counts this stream into
        # requests_inflight/total and the phase histogram — the member
        # copy must not double it.
        self.metered = metered
        self.events: List[tuple] = []  # (name, t_monotonic, args|None)
        self.dropped = 0
        self.finished = False
        self.outcome: Optional[str] = None

    def event(self, name: str, _force: bool = False, **args) -> None:
        if self.finished:
            return
        if len(self.events) >= MAX_EVENTS and not _force:
            self.dropped += 1
            return
        self.events.append((name, time.monotonic(), args or None))

    def finish(self, outcome: str) -> None:
        """Terminal event + hand the trace to the ring. Idempotent — the
        cancel and finish paths can race to it."""
        if self.finished:
            return
        self.event(outcome, _force=True)
        self.finished = True
        self.outcome = outcome
        self._tracer._finished(self, outcome)


class Tracer:
    """Owner of the live-trace table and the finished-trace ring."""

    def __init__(self, capacity: int = 512, origin: str = "engine"):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=max(1, capacity))
        self._live: Dict[int, Trace] = {}
        self.epoch = time.monotonic()
        # Which process/role this tracer's spans belong to in a stitched
        # fleet timeline ("router", a member name, or "engine").
        self.origin = origin
        # Monotonic finish instants of recent requests: the observed
        # completion rate behind load-shedding Retry-After estimates.
        self.finish_times: collections.deque = collections.deque(maxlen=256)

    def begin(self, req_id: int, user: str, model: str,
              kind: str = "generate", ctx: Optional[str] = None,
              metered: bool = True) -> Trace:
        tr = Trace(self, req_id, user, model, kind, ctx=ctx, metered=metered)
        tr.event("enqueue")
        with self._lock:
            self._live[id(tr)] = tr
        if metered:
            tm.REQUESTS_INFLIGHT.inc()
        return tr

    def _finished(self, tr: Trace, outcome: str) -> None:
        with self._lock:
            self._live.pop(id(tr), None)
            self._ring.append(tr)
            self.finish_times.append(time.monotonic())
        if not tr.metered:
            return
        tm.REQUESTS_INFLIGHT.dec()
        tm.REQUESTS_TOTAL.labels(model=tr.model or "?", outcome=outcome).inc()
        # Latency attribution: fold the finished timeline's per-phase
        # totals into ollamamq_request_phase_ms.
        attribution.observe_phases(tr.model, list(tr.events))

    def traces(self) -> List[Trace]:
        with self._lock:
            return list(self._ring) + list(self._live.values())

    def find(self, req_id: int) -> Optional[Trace]:
        """Latest trace for a request id: the in-flight table first, then
        the finished ring newest-first (ids can recur across requeues —
        the newest holder is the one an operator is asking about)."""
        with self._lock:
            for tr in self._live.values():
                if tr.req_id == req_id:
                    return tr
            for tr in reversed(self._ring):
                if tr.req_id == req_id:
                    return tr
        return None

    def find_ctx(self, ctx: str) -> List[Trace]:
        """Every trace carrying this fleet context, oldest first — one
        stream's member attempts (requeues/failovers/migrations each
        begin a fresh member-side trace under the SAME ctx)."""
        with self._lock:
            out = [tr for tr in self._ring if tr.ctx == ctx]
            out += [tr for tr in self._live.values() if tr.ctx == ctx]
        return out

    def export_spans(self, traces: List[Trace]) -> List[dict]:
        """JSON-able span export for cross-process stitching: event
        timestamps rebased onto the WALL clock (the only axis two
        processes share), one dict per trace."""
        offset = time.time() - time.monotonic()
        out = []
        for tr in traces:
            evs = list(tr.events)  # engine thread may still append; copy
            out.append({
                "req_id": tr.req_id, "user": tr.user, "model": tr.model,
                "kind": tr.kind, "ctx": tr.ctx, "origin": tr.origin,
                "outcome": tr.outcome, "finished": tr.finished,
                "dropped": tr.dropped,
                "events": [[name, t + offset, args]
                           for name, t, args in evs],
            })
        return out

    def export_chrome(self) -> dict:
        """Chrome trace-event JSON (the chrome://tracing 'JSON Array
        Format' wrapped in an object): consecutive events of a request
        become complete ("X") spans named after the phase they open; the
        terminal event is an instant ("i") mark. tid = req_id, so each
        request renders as its own row."""
        events: List[dict] = []
        for tr in self.traces():
            evs = list(tr.events)  # engine thread may still append; copy
            tid = tr.req_id
            events.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                "args": {"name": f"req {tr.req_id} {tr.user} "
                                 f"{tr.model or '?'} [{tr.kind}]"},
            })
            for i, (name, t, args) in enumerate(evs):
                ts = (t - self.epoch) * 1e6  # Chrome wants microseconds
                ev = {"name": name, "pid": 1, "tid": tid, "ts": ts,
                      "cat": tr.kind}
                if args:
                    ev["args"] = args
                if i + 1 < len(evs):
                    ev["ph"] = "X"
                    ev["dur"] = (evs[i + 1][1] - t) * 1e6
                else:
                    ev["ph"] = "i"
                    ev["s"] = "t"
                events.append(ev)
            if tr.dropped:
                events.append({
                    "name": f"{tr.dropped} events dropped", "ph": "i",
                    "s": "t", "pid": 1, "tid": tid,
                    "ts": (evs[-1][1] - self.epoch) * 1e6 if evs else 0,
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Fleet stitching: merge one stream's spans from every process into ONE
# timeline under the client's stable rid (GET /debug/trace/{rid}).
# ---------------------------------------------------------------------------

def stitch_events(spans: List[dict], root_origin: str) -> List[tuple]:
    """One contiguous (name, t_wall, args) event list from a stream's
    exported spans. The ROOT span (the router's, under the client rid)
    contributes everything including its terminal; member spans
    contribute their lifecycle events but NOT their terminals (a member
    attempt's `cancelled` is a routing ack — eviction, migration commit
    — not the client outcome) and not their `enqueue` duplicates. The
    result is sorted with the root terminal pinned last, so
    attribution.phase_totals over it sums EXACTLY to the client-observed
    end-to-end wall clock: the fleet-wide attribution invariant,
    handoffs included."""
    root_events: List[tuple] = []
    member_events: List[tuple] = []
    for span in spans:
        is_root = span.get("origin") == root_origin
        for name, t, args in span.get("events", ()):
            tagged = dict(args or {})
            tagged.setdefault("origin", span.get("origin", "?"))
            if is_root:
                root_events.append((name, t, tagged))
            elif name not in attribution.TERMINAL_EVENTS \
                    and name != "enqueue":
                member_events.append((name, t, tagged))
    if not root_events:
        # No root span (a member asked about its own rid): fall back to
        # the raw union so the timeline is still readable.
        merged = sorted(member_events, key=lambda e: e[1])
        return merged
    terminal = None
    if root_events and root_events[-1][0] in attribution.TERMINAL_EVENTS:
        terminal = root_events.pop()
    merged = sorted(root_events + member_events, key=lambda e: e[1])
    if terminal is not None:
        # The terminal closes the chain; clock skew must never let a
        # member event trail it (phase_totals stops at the terminal).
        t_end = max([terminal[1]] + [t for _, t, _ in merged])
        merged.append((terminal[0], t_end, terminal[2]))
    return merged


def merged_chrome(spans: List[dict], root_origin: str = "router") -> dict:
    """Chrome trace-event JSON over a stream's spans from EVERY process:
    one row (tid) per origin, plus a `stitched` summary whose phases_ms
    sum to the client-observed e2e (the fleet attribution invariant)."""
    origins = sorted({s.get("origin", "?") for s in spans},
                     key=lambda o: (o != root_origin, o))
    t0 = min((ev[1] for s in spans for ev in s.get("events", ())),
             default=0.0)
    events: List[dict] = []
    for s in spans:
        tid = origins.index(s.get("origin", "?")) + 1
        evs = s.get("events", ())
        events.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": f"{s.get('origin', '?')} req "
                             f"{s.get('req_id')} {s.get('user', '')}"},
        })
        for i, (name, t, args) in enumerate(evs):
            ev = {"name": name, "pid": 1, "tid": tid,
                  "ts": (t - t0) * 1e6, "cat": s.get("kind", "generate")}
            if args:
                ev["args"] = args
            if i + 1 < len(evs):
                ev["ph"] = "X"
                ev["dur"] = max(0.0, (evs[i + 1][1] - t) * 1e6)
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
    stitched_events = stitch_events(spans, root_origin)
    phases = attribution.phase_totals(stitched_events)
    outcome = None
    root = next((s for s in spans if s.get("origin") == root_origin), None)
    if root is not None:
        outcome = root.get("outcome")
    e2e_ms = ((stitched_events[-1][1] - stitched_events[0][1]) * 1e3
              if len(stitched_events) >= 2 else 0.0)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "stitched": {
            "ctx": spans[0].get("ctx") if spans else None,
            "origins": origins,
            "outcome": outcome,
            "e2e_ms": round(e2e_ms, 3),
            "phases_ms": {p: round(ms, 3) for p, ms in phases.items()},
            "phase_sum_ms": round(sum(phases.values()), 3),
            "events": [
                {"name": name, "t_ms": round((t - t0) * 1e3, 3),
                 **({"args": args} if args else {})}
                for name, t, args in stitched_events
            ],
        },
    }
