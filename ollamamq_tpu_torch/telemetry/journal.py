"""Engine flight recorder: the scheduler decision journal.

Every scheduler-visible decision the engine makes — admit, shed, batch
compose, preempt, requeue, retry, poison, deadline drop, page
alloc/free/evict, runtime rebuild — lands here as ONE typed record
carrying the decision's *inputs* (queue depths, free/cached page counts,
fair-share standing, deadline slack), so a bad scheduling episode
observed in production is explainable after the fact and, for
harness-driven runs, replayable (tools/journal replay).

Design constraints, in order:

  1. bounded — a deque ring of `capacity` records; memory is O(capacity)
     no matter how long the engine runs. An optional JSONL spill
     (--journal-file) keeps the full history on disk with size-based
     rotation so soak runs can't fill the volume.
  2. low overhead — nothing is recorded per decoded token; the hottest
     sites are one record per prefill batch / chunk / page-table growth.
     Schema validation is two frozenset subset checks.
  3. typed — EVENTS is a CLOSED vocabulary and every kind declares its
     required/optional fields (EVENT_FIELDS); a record of an unknown kind
     or with a missing or unknown field raises JournalError.

The vocabulary, the field sets, the replay signature and the invariant
checker are the JAX package's, record for record, so one analyzer reads
either package's journal and the two engines' decision streams compare
directly (the fleet, SPMD and compile kinds stay in the vocabulary for
that reason, though this package records none of them yet).

Stdlib-only, like the rest of telemetry: the offline analyzer
(tools/journal) imports this module without torch or an engine.
"""

from __future__ import annotations

import collections
import json
import os
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

from ollamamq_tpu_torch.telemetry import schema as tm

# Closed event vocabulary, lifecycle order (the README's "Flight
# recorder" table documents every kind).
EVENTS = (
    "enqueue",        # arrival accepted into the fair-share queue
    "admit",          # scheduler popped the request for placement
    "sched",          # scheduling policy applied an ordering decision
    #                   (admission window / preemption victim) + inputs
    "place",          # placed onto a runtime (replica chosen)
    "shed",           # refused/dropped instead of served, by reason
    "batch",          # prefill batch composed (slots/bucket/occupancy)
    "chunk",          # one chunked-prefill piece dispatched
    "install",        # slot activated: request entered the decode batch
    "speculate",      # drafts composed into a verify span for a slot
    "spec_verify",    # verify outcome: drafts proposed vs accepted
    "spec_rollback",  # rejected drafts' KV page claim released
    "preempt",        # victim evicted for recompute under KV pressure
    "kv_stall",       # page growth failed; slot holds a reservation
    "requeue",        # returned to the FRONT of its user's queue
    "retry",          # fault-implicated request re-dispatched
    "poison",         # retry budget spent; request errored on purpose
    "deadline_drop",  # per-request deadline expired before completion
    "finish",         # slot/stream finished, by reason
    "page_alloc",     # KV pages allocated (admission or decode growth)
    "page_free",      # KV pages returned to the free list
    "page_evict",     # cached prefix pages reclaimed under pressure
    "broadcast",      # SPMD primary shipped a step plan to worker hosts
    "rebuild",        # failed runtime replaced (weights reloaded)
    # Fleet router (fleet/router.py): dispatcher-over-engines decisions.
    "replica_eject",     # replica removed from rotation (health-driven)
    "replica_failover",  # victim stream re-dispatched to another replica
    "replica_drain",     # replica quiesced: no new placements, in-flight
    #                      streams run to completion
    "replica_join",      # replica (re)entered rotation, by reason
    # Tiered fleet (fleet/tiering.py): SLO-aware replica tiers with
    # adaptive regrouping.
    "tier_place",        # placement matched a request class to a tier
    "tier_overflow",     # a stream placed cross-tier (per-tier SLO burn,
    #                      an empty tier, or a failover with no in-tier
    #                      capacity) — never silently
    "tier_regroup",      # a member changed tiers (drain -> migrate ->
    #                      restart at the tier's TP width -> rejoin),
    #                      by phase: start / done / aborted
    # KV page migration (two-phase handoff; fleet/router.py + engine):
    "migrate_export",    # source snapshot taken, slot detached/parked
    "migrate_import",    # target installed the shipped state (the ack)
    "migrate_abort",     # transfer failed; source state released and the
    #                      stream falls back to recompute replay
    # Crash durability (durability/): the admission WAL + cold-restart
    # recovery.
    "wal_admit",         # request durably logged (fsynced) pre-ACK
    "recover_replay",    # WAL'd unfinished request re-admitted at start
    # Elastic fleet (fleet/autoscaler.py): SLO-burn-driven fleet sizing.
    "scale_up",          # scaler grew a tier, by phase: start (decision
    #                      made, provisioning began) / done (member
    #                      joined rotation) / aborted (spawn failed)
    "scale_down",        # a member retired (drain -> migrate-off ->
    #                      stop), by phase: start / done / aborted; also
    #                      records preemption-notice retires (why:
    #                      "preempt") and manual ones (why: "manual")
    "preempt_notice",    # a preemptible member was served a termination
    #                      notice; resolved by a scale_down for the same
    #                      member within the notice window
    # Router HA (fleet/ha.py): warm-standby sync, takeover, fencing.
    "standby_sync",      # standby (re)synced against the primary: cold
    #                      catch-up, snapshot reload after ring overrun,
    #                      or reconnect — NOT one record per batch
    "router_takeover",   # standby promoted to primary, by phase: begin
    #                      (primary declared dead / handover received) /
    #                      done (serving, streams re-admitted) / aborted
    "epoch_fence",       # a stale-epoch router call was rejected — the
    #                      zombie-primary split-brain guard firing
    # Engine performance plane (telemetry/stepprof.py).
    "compile",           # a jit cache filled and the first call paid an
    #                      XLA compile: which site/shape key, the wall
    #                      ms the dispatch path stalled, the cache size
    #                      after — exactly-once per ladder rung unless
    #                      something is thrashing (compile_storm)
)

# kind -> (required fields, optional fields) beyond the common header
# (seq, t, tick, kind, req_id, user, model). Validation is loud: an
# instrumentation site that forgets a decision input fails its test, not
# an operator's incident review.
EVENT_FIELDS: Dict[str, Tuple[tuple, tuple]] = {
    "enqueue": (("n_prompt", "queued"),
                ("kind_req", "max_tokens", "deadline_ms")),
    "admit": (("queued",), ()),
    # Policy ordering decisions carry their score inputs: which policy
    # chose, at which decision point ("admit" window / "victim" pick),
    # over how many candidates, and the chosen request's predicted
    # output length + effective (aged) score — the explainability
    # contract for "why did THIS request go first / lose its slot".
    "sched": (("policy", "point"), ("candidates", "score", "predicted")),
    # `overhead_ms` (fleet router only) = the router's own placement-
    # decision cost for THIS place, measured by the always-on
    # perf_counter_ns timer that feeds ollamamq_router_overhead_ms.
    "place": (("runtime",), ("overhead_ms",)),
    "shed": (("reason",),
             ("queued", "limit", "retry_after_s", "n_prompt", "max_tokens")),
    # `mode` tells the two batch shapes apart: "bucketed" records carry
    # the bucket they padded to; "ragged" records carry the granule-
    # padded stream total plus its prefill/decode row split. Both carry
    # real vs padded token counts, which batch_stats() below turns into
    # the padding-waste scoreboard.
    "batch": (("slots", "batch_size", "tokens", "occupancy"),
              ("reqs", "pending", "free_pages", "bucket", "mode",
               "padded_tokens", "n_prefill", "n_decode", "n_spec",
               "spec_tokens", "spec_accepted")),
    "chunk": (("slot", "pos"), ("tokens", "cached")),
    "install": (("slot",), ("n_prompt",)),
    # Speculation decisions carry their inputs/outcomes: `k` drafts from
    # `source` were composed (speculate); `accepted` of `proposed` drafts
    # survived greedy verification (spec_verify — accepted <= proposed is
    # a checked invariant); the rollback releases the rejected tail's
    # page claim with the allocator post-state, so page conservation
    # (free+used+cached==pool) stays checkable through speculation.
    "speculate": (("slot", "k"), ("source",)),
    "spec_verify": (("slot", "proposed", "accepted"), ("rolled_back",)),
    "spec_rollback": (("slot", "kv_before", "kv_after", "freed",
                       "free", "used", "cached", "pool"), ()),
    "preempt": (("slot", "why"),
                ("n", "free_pages", "victim_served", "vip")),
    "kv_stall": (("slot",), ("free_pages", "need")),
    "requeue": ((), ("why",)),
    "retry": (("n",), ("error",)),
    "poison": (("retries",), ("error",)),
    "deadline_drop": (("slack_ms",), ()),
    # `predicted_tokens` pairs the scheduler's output-length prediction
    # with the actual outcome (`tokens`) — per-policy predictor accuracy
    # is auditable straight off the journal.
    "finish": (("reason",), ("slot", "tokens", "predicted_tokens")),
    "page_alloc": (("n", "free", "used", "cached", "pool"), ("slot",)),
    "page_free": (("n", "free", "used", "cached", "pool"), ("slot",)),
    "page_evict": (("n", "free", "used", "cached", "pool"), ()),
    "broadcast": (("op",), ("wire_seq",)),
    "rebuild": ((), ()),
    # Fleet records carry the replica name plus the inputs that justified
    # the decision: why a member was ejected (and how stale its heartbeat
    # was), where a victim stream went and how many tokens its replay
    # carried, how much in-flight work a drain waited out.
    "replica_eject": (("replica", "why"),
                      ("victims", "heartbeat_age_s", "backoff_s")),
    "replica_failover": (("replica",), ("to_replica", "replayed_tokens")),
    "replica_drain": (("replica",), ("inflight", "timeout_s")),
    "replica_join": (("replica",), ("why",)),
    # Tier records carry the classification inputs: which request class
    # (vip/boost/deadline/default) mapped to which tier and which
    # replica won (tier_place); why a stream crossed tiers and how hot
    # the burn was (tier_overflow); a regroup's phase with the class-mix
    # EMA and TP widths that justified it (tier_regroup).
    "tier_place": (("tier", "cls"), ("replica", "overflow")),
    "tier_overflow": (("from_tier", "to_tier", "why"),
                      ("burn", "queued", "replica")),
    "tier_regroup": (("replica", "phase"),
                     ("from_tier", "to_tier", "why", "mix",
                      "tp_from", "tp_to")),
    # Migration records carry the shipped state's size (tokens already
    # generated = what recompute would have re-derived; pages/bytes =
    # what actually moved) and, router-side, the members involved.
    # `what` tells a stream handoff from a shipped prefix.
    # `overhead_ms` (router-side records) = the router's measured cost
    # of that handoff leg (export / import), per decision.
    "migrate_export": (("tokens",),
                       ("replica", "kv_len", "pages", "bytes",
                        "overhead_ms")),
    "migrate_import": ((),
                       ("replica", "to_replica", "tokens", "pages",
                        "bytes", "what", "overhead_ms")),
    "migrate_abort": (("why",), ("replica", "to_replica")),
    # WAL records carry the durability cost (how long the admission
    # waited on its covering fsync) and the recovery inputs (how many
    # already-emitted tokens the replay restored without recompute).
    "wal_admit": (("fsync_ms",), ("n_prompt",)),
    # `req_id` is the RE-ADMITTED id (what the rest of this journal's
    # records use); `wal_rid` is the pre-crash id the client still
    # holds — the resume endpoint aliases the two.
    "recover_replay": (("tokens",), ("outcome", "n_prompt", "wal_rid")),
    # Scale records carry the control-loop inputs that justified the
    # decision: which tier moved, the burn rate and queue backlog at
    # decision time, and the fleet size it moved toward. scale_up's
    # done-phase records the measured spawn cost (what a scaled-to-zero
    # tier's Retry-After must account for); scale_down's start-phase
    # records the in-flight work the drain must migrate off first.
    "scale_up": (("replica", "phase"),
                 ("tier", "why", "burn", "queued", "fleet", "spawn_ms")),
    "scale_down": (("replica", "phase"),
                   ("tier", "why", "burn", "queued", "fleet", "inflight")),
    "preempt_notice": (("replica",),
                       ("tier", "notice_s", "why", "inflight")),
    # HA records carry the replication position (seq = last applied
    # replication record, lag = primary head minus that) and, for
    # takeovers, the epochs involved plus the promotion outcome counts
    # (streams re-admitted, how many migrated vs recompute-replayed) —
    # the inputs tools/journal's takeover-pairing and epoch-monotonicity
    # audits check across spills.
    "standby_sync": (("seq", "lag"), ("records", "epoch", "why")),
    "router_takeover": (("phase", "why"),
                        ("epoch", "from_epoch", "streams", "migrated",
                         "replayed", "takeover_ms", "lag",
                         "members_claimed")),
    "epoch_fence": (("epoch", "stale_epoch"), ("path", "caller")),
    # Compile events carry the shape key that missed, the wall ms the
    # first call stalled compiling, and the cache size after the fill —
    # enough to reconstruct the whole ladder from a journal tail.
    "compile": (("site", "key", "wall_ms"), ("cache_size",)),
}
assert set(EVENT_FIELDS) == set(EVENTS)

_FIELD_SETS = {k: (frozenset(req), frozenset(req) | frozenset(opt))
               for k, (req, opt) in EVENT_FIELDS.items()}

# Kinds whose (kind, req_id, user, salient-fields) sequence defines THE
# decision stream for deterministic replay. Page events and dispatch
# bookkeeping (chunk/broadcast) carry device/layout detail that replay
# harnesses without real KV pools can't reproduce; everything
# scheduler-visible is in.
DECISION_KINDS = ("enqueue", "admit", "sched", "place", "shed", "batch",
                  "install", "preempt", "requeue", "retry", "poison",
                  "deadline_drop", "finish", "replica_eject",
                  "replica_failover", "replica_drain", "replica_join",
                  "tier_place", "tier_overflow", "tier_regroup",
                  "migrate_export", "migrate_import", "migrate_abort",
                  "recover_replay", "scale_up", "scale_down",
                  "preempt_notice", "standby_sync", "router_takeover",
                  "epoch_fence")

# High-rate bookkeeping kinds eligible for probabilistic sampling
# (--journal-sample < 1): each record is self-contained (page events
# carry their full post-state), so a sampled trace stays checkable —
# only the batch-ordinal starvation count loses meaning (tools/journal
# check skips it on sampled traces). Decision-critical kinds are never
# sampled out.
SAMPLED_KINDS = frozenset({"batch", "chunk", "page_alloc", "page_free",
                           "page_evict", "broadcast"})

# Per-kind fields folded into the replay signature (deterministic given
# the same arrivals; excludes timestamps, latencies, and page ids).
_SIG_FIELDS = {
    "enqueue": ("n_prompt", "queued"),
    "sched": ("policy", "point", "candidates"),
    "shed": ("reason",),
    "place": ("runtime",),
    "retry": ("n",),
    "poison": ("retries",),
    "finish": ("reason",),
    "preempt": ("why",),
    "tier_place": ("tier", "cls"),
    "tier_overflow": ("from_tier", "to_tier", "why"),
    "tier_regroup": ("replica", "phase", "from_tier", "to_tier"),
    "scale_up": ("replica", "phase", "tier"),
    "scale_down": ("replica", "phase", "why"),
    "preempt_notice": ("replica",),
}


class JournalError(ValueError):
    """A record violated the event schema (unknown kind / bad fields)."""


class Journal:
    """Bounded append-only decision journal with optional JSONL spill.

    Thread-safe: the engine loop appends while HTTP readers tail. The
    ring holds plain dicts (JSON-able as-is); `seq` is a monotonically
    increasing record index so consumers can detect ring evictions
    (size < seq means the oldest records fell off).
    """

    def __init__(self, capacity: int = 2048, path: Optional[str] = None,
                 rotate_bytes: int = 64_000_000, keep: int = 3,
                 meta: Optional[dict] = None, sample: float = 1.0):
        self.capacity = max(1, int(capacity))
        # Probabilistic sampling of SAMPLED_KINDS (--journal-sample):
        # seeded so two runs of the same trace sample identically.
        self.sample = min(1.0, max(0.0, float(sample)))
        self._sample_rng = random.Random(0)
        self.sampled_out = 0
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self.seq = 0
        # Engine-loop iteration counter; the synchronous replay harness
        # sets it explicitly so recorded arrivals carry a deterministic
        # virtual tick.
        self.tick = 0
        self.path = path or None
        self.rotate_bytes = max(0, int(rotate_bytes))
        self.keep = max(1, int(keep))
        self.meta = dict(meta or {})
        if self.sample < 1.0:
            # The spill must say it is sampled: the offline checker
            # reads this to skip batch-ordinal-dependent invariants.
            self.meta.setdefault("sample", self.sample)
        self._fh = None
        self._bytes = 0
        self._last_decision: Optional[dict] = None
        # Optional replication tap (fleet/ha.py): called with each
        # validated record AFTER it lands in the ring/spill, outside the
        # journal lock. Exceptions are contained — replication trouble
        # must not take recording (or serving) down.
        self.tap = None
        self._tm = {k: tm.JOURNAL_EVENTS_TOTAL.labels(kind=k)
                    for k in EVENTS}
        if self.path:
            self._open_file()

    # -- file spill --------------------------------------------------------
    def _open_file(self) -> None:
        # Line-buffered: each record reaches the OS as it is written, so
        # the spill is tail-able mid-incident and survives a crash — a
        # flight recorder that only flushes on clean shutdown records
        # nothing about the flights that matter.
        self._fh = open(self.path, "a", encoding="utf-8", buffering=1)
        self._bytes = self._fh.tell()
        if self._bytes == 0:
            head = {"journal_meta": {
                "version": 1, "opened_at": time.time(), **self.meta}}
            line = json.dumps(head, default=str) + "\n"
            self._fh.write(line)
            self._bytes += len(line)

    def _rotate(self) -> None:
        """path -> path.1 -> ... -> path.keep (oldest dropped): bounded
        disk no matter how long the soak runs."""
        self._fh.close()
        for i in range(self.keep - 1, 0, -1):
            src, dst = f"{self.path}.{i}", f"{self.path}.{i + 1}"
            if os.path.exists(src):
                os.replace(src, dst)
        os.replace(self.path, f"{self.path}.1")
        self._fh = None
        self._open_file()

    def _spill(self, rec: dict) -> None:
        line = json.dumps(rec, default=str) + "\n"
        self._fh.write(line)
        self._bytes += len(line)
        if self.rotate_bytes and self._bytes >= self.rotate_bytes:
            self._rotate()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None

    # -- recording ---------------------------------------------------------
    def record(self, kind: str, req=None, req_id: Optional[int] = None,
               user: Optional[str] = None, model: Optional[str] = None,
               dp_replica: int = 0, **fields) -> dict:
        """Append one validated record. `req` (duck-typed Request) fills
        req_id/user/model unless given explicitly. `dp_replica`: the
        data-parallel replica of `model` the record is about (kept only
        when not 0, so a one-replica journal is the reference's; the
        fleet kinds' `replica` field names a fleet member)."""
        sets = _FIELD_SETS.get(kind)
        if sets is None:
            raise JournalError(f"unknown journal event kind {kind!r} "
                               f"(vocabulary: {EVENTS})")
        if self.sample < 1.0 and kind in SAMPLED_KINDS:
            # Sampled journaling: high-rate bookkeeping kinds keep the
            # ring and spill alive at 100x event rates; the metric still
            # counts every event so rates stay readable off /metrics.
            with self._lock:
                keep = self._sample_rng.random() < self.sample
            if not keep:
                self.sampled_out += 1
                self._tm[kind].inc()
                return {}
        required, allowed = sets
        got = frozenset(fields)
        if not required <= got:
            raise JournalError(
                f"journal event {kind!r} missing required field(s) "
                f"{sorted(required - got)}")
        if not got <= allowed:
            raise JournalError(
                f"journal event {kind!r} got unknown field(s) "
                f"{sorted(got - allowed)} (allowed: {sorted(allowed)})")
        if req is not None:
            if req_id is None:
                req_id = getattr(req, "req_id", None)
            if user is None:
                user = getattr(req, "user", None)
            if model is None:
                model = getattr(req, "model", None)
        rec = {"seq": 0, "t": time.monotonic(), "tick": self.tick,
               "kind": kind}
        if req_id is not None:
            rec["req_id"] = int(req_id)
        if user is not None:
            rec["user"] = user
        if model:
            rec["model"] = model
        if dp_replica:
            rec["dp_replica"] = int(dp_replica)
        rec.update(fields)
        with self._lock:
            rec["seq"] = self.seq
            self.seq += 1
            self._ring.append(rec)
            if kind in DECISION_KINDS:
                self._last_decision = rec
            if self._fh is not None:
                try:
                    self._spill(rec)
                except OSError:
                    # Disk trouble must not take serving down; the ring
                    # keeps recording.
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                    self._fh = None
        self._tm[kind].inc()
        tap = self.tap
        if tap is not None:
            try:
                tap(rec)
            except Exception:  # noqa: BLE001
                pass
        return rec

    # -- reading -----------------------------------------------------------
    def tail(self, n: Optional[int] = 200, req_id: Optional[int] = None,
             user: Optional[str] = None,
             kind: Optional[str] = None) -> List[dict]:
        """Newest-last slice of the ring, optionally filtered. n=None (or
        <= 0) returns every retained record passing the filters."""
        with self._lock:
            recs = list(self._ring)
        if req_id is not None:
            recs = [r for r in recs if r.get("req_id") == req_id]
        if user is not None:
            recs = [r for r in recs if r.get("user") == user]
        if kind is not None:
            recs = [r for r in recs if r["kind"] == kind]
        if n is not None and n > 0:
            recs = recs[-n:]
        return recs

    def snapshot(self) -> dict:
        with self._lock:
            size = len(self._ring)
        out = {"capacity": self.capacity, "size": size, "seq": self.seq,
               "evicted": max(0, self.seq - size),
               "file": self.path, "tick": self.tick}
        if self.sample < 1.0:
            out["sample"] = self.sample
            out["sampled_out"] = self.sampled_out
        return out

    def last_summary(self) -> str:
        """One-line text of the most recent scheduler decision (the TUI
        last-decision line); "" before the first decision."""
        rec = self._last_decision
        return explain(rec) if rec is not None else ""


# ---------------------------------------------------------------------------
# Explanations: per-decision human text built from the recorded inputs.
# ---------------------------------------------------------------------------

def explain(rec: dict) -> str:
    """Human one-liner for one record: WHAT was decided and the inputs
    that justify it."""
    kind = rec.get("kind", "?")
    rid = rec.get("req_id")
    who = f"req {rid}" if rid is not None else rec.get("user", "?")
    if rec.get("user") and rid is not None:
        who += f" ({rec['user']})"
    if kind == "enqueue":
        return (f"{who} enqueued: {rec.get('n_prompt', '?')} prompt tokens, "
                f"queue depth {rec.get('queued', '?')}")
    if kind == "admit":
        return f"{who} admitted (queue depth {rec.get('queued', '?')})"
    if kind == "sched":
        verb = ("picked as preemption victim"
                if rec.get("point") == "victim" else "ordered first")
        s = f"{who} {verb} by policy {rec.get('policy', '?')}"
        if rec.get("candidates") is not None:
            s += f" among {rec['candidates']} candidate(s)"
        if rec.get("predicted") is not None:
            s += f" (predicted {rec['predicted']} token(s)"
            if rec.get("score") is not None:
                s += f", score {rec['score']}"
            s += ")"
        return s
    if kind == "place":
        return f"{who} placed on runtime {rec.get('runtime', '?')}"
    if kind == "shed":
        parts = [f"{who} shed ({rec.get('reason', '?')})"]
        if "queued" in rec and "limit" in rec:
            parts.append(f"queued {rec['queued']} >= cap {rec['limit']}")
        if "retry_after_s" in rec:
            parts.append(f"retry after ~{rec['retry_after_s']:.0f}s")
        return ": ".join([parts[0], ", ".join(parts[1:])]) if parts[1:] \
            else parts[0]
    if kind == "batch":
        if rec.get("mode") == "ragged" or "bucket" not in rec:
            return (f"ragged batch on {rec.get('model', '?')}: "
                    f"{rec.get('n_prefill', '?')} prefill span(s) + "
                    f"{rec.get('n_decode', '?')} decode row(s), "
                    f"{rec.get('tokens', '?')}/"
                    f"{rec.get('padded_tokens', '?')} real/padded tokens, "
                    f"occupancy {rec.get('occupancy', 0):.2f}")
        return (f"prefill batch on {rec.get('model', '?')}: "
                f"{len(rec.get('slots', []))} req(s) in bucket "
                f"{rec.get('bucket', '?')} (B={rec.get('batch_size', '?')}, "
                f"{rec.get('tokens', '?')} real tokens, occupancy "
                f"{rec.get('occupancy', 0):.2f})")
    if kind == "chunk":
        return (f"{who} prefill chunk at pos {rec.get('pos', '?')} "
                f"({rec.get('tokens', '?')} tokens, slot {rec.get('slot')})")
    if kind == "install":
        return f"{who} installed in slot {rec.get('slot', '?')}"
    if kind == "speculate":
        return (f"{who} speculating {rec.get('k', '?')} draft token(s) in "
                f"slot {rec.get('slot', '?')} "
                f"(source {rec.get('source', 'ngram')})")
    if kind == "spec_verify":
        return (f"{who} verified speculation in slot {rec.get('slot', '?')}"
                f": accepted {rec.get('accepted', '?')}/"
                f"{rec.get('proposed', '?')} draft(s)"
                + (f", rolled back {rec['rolled_back']}"
                   if rec.get("rolled_back") else ""))
    if kind == "spec_rollback":
        return (f"{who} speculative rollback in slot {rec.get('slot', '?')}"
                f": kv {rec.get('kv_before', '?')} -> "
                f"{rec.get('kv_after', '?')}, {rec.get('freed', '?')} "
                f"page(s) freed (free={rec.get('free')}, "
                f"used={rec.get('used')}, cached={rec.get('cached')}, "
                f"pool={rec.get('pool')})")
    if kind == "preempt":
        s = (f"{who} preempted from slot {rec.get('slot', '?')} "
             f"({rec.get('why', '?')}, n={rec.get('n', '?')})")
        if "free_pages" in rec:
            s += f": free_pages={rec['free_pages']}"
        if "victim_served" in rec:
            s += f", victim served {rec['victim_served']} lifetime requests"
        return s
    if kind == "kv_stall":
        return (f"{who} stalled holding slot {rec.get('slot', '?')} "
                f"(free_pages={rec.get('free_pages', '?')})")
    if kind == "requeue":
        return f"{who} requeued to queue front"
    if kind == "retry":
        return (f"{who} retry #{rec.get('n', '?')}"
                + (f": {rec['error']}" if rec.get("error") else ""))
    if kind == "poison":
        return (f"{who} poisoned after {rec.get('retries', '?')} retr"
                f"{'y' if rec.get('retries') == 1 else 'ies'}")
    if kind == "deadline_drop":
        return (f"{who} dropped: deadline expired "
                f"{rec.get('slack_ms', 0):.0f}ms ago")
    if kind == "finish":
        return (f"{who} finished ({rec.get('reason', '?')}"
                + (f", {rec['tokens']} tokens" if "tokens" in rec else "")
                + ")")
    if kind in ("page_alloc", "page_free", "page_evict"):
        verb = {"page_alloc": "allocated", "page_free": "freed",
                "page_evict": "evicted"}[kind]
        return (f"{rec.get('model', '?')}: {rec.get('n', '?')} page(s) "
                f"{verb} (free={rec.get('free')}, used={rec.get('used')}, "
                f"cached={rec.get('cached')}, pool={rec.get('pool')})")
    if kind == "broadcast":
        return (f"SPMD plan broadcast: {rec.get('op', '?')} "
                f"(wire seq {rec.get('wire_seq', '?')})")
    if kind == "rebuild":
        return f"runtime {rec.get('model', '?')} rebuilt (weights reloaded)"
    if kind == "replica_eject":
        s = (f"replica {rec.get('replica', '?')} ejected "
             f"({rec.get('why', '?')})")
        if rec.get("victims"):
            s += f", {rec['victims']} in-flight stream(s) to fail over"
        if rec.get("heartbeat_age_s") is not None:
            s += f", heartbeat {rec['heartbeat_age_s']:.1f}s stale"
        return s
    if kind == "replica_failover":
        return (f"{who} failed over from replica {rec.get('replica', '?')}"
                f" to {rec.get('to_replica', '?')}, replaying "
                f"{rec.get('replayed_tokens', 0)} already-emitted token(s)")
    if kind == "replica_drain":
        return (f"replica {rec.get('replica', '?')} draining: "
                f"{rec.get('inflight', 0)} in-flight stream(s) running to "
                "completion, no new placements")
    if kind == "replica_join":
        return (f"replica {rec.get('replica', '?')} joined rotation "
                f"({rec.get('why', 'start')})")
    if kind == "tier_place":
        s = (f"{who} (class {rec.get('cls', '?')}) placed in tier "
             f"{rec.get('tier', '?')}")
        if rec.get("replica"):
            s += f" on replica {rec['replica']}"
        if rec.get("overflow"):
            s += " via cross-tier overflow"
        return s
    if kind == "tier_overflow":
        s = (f"{who} overflowed {rec.get('from_tier', '?')} -> "
             f"{rec.get('to_tier', '?')} ({rec.get('why', '?')})")
        if rec.get("burn") is not None:
            s += f", burn {rec['burn']:.1f}x budget"
        if rec.get("replica"):
            s += f", landed on {rec['replica']}"
        return s
    if kind == "tier_regroup":
        phase = rec.get("phase", "?")
        s = (f"replica {rec.get('replica', '?')} regroup "
             f"{rec.get('from_tier', '?')} -> {rec.get('to_tier', '?')} "
             f"{phase}")
        if rec.get("why"):
            s += f" ({rec['why']})"
        if rec.get("mix") is not None:
            s += f", interactive mix EMA {rec['mix']:.2f}"
        if rec.get("tp_to") is not None:
            s += (f", tp {rec.get('tp_from', '?')} -> {rec['tp_to']}")
        if phase == "aborted":
            s += "; member keeps its ORIGINAL tier"
        return s
    if kind == "migrate_export":
        s = (f"{who} KV state exported for migration "
             f"({rec.get('tokens', '?')} generated token(s)")
        if rec.get("pages") is not None:
            s += f", {rec['pages']} page(s)"
        if rec.get("replica"):
            s += f", from replica {rec['replica']}"
        return s + ")"
    if kind == "migrate_import":
        if rec.get("what") == "prefix":
            return (f"cached prefix shipped "
                    f"{rec.get('replica', '?')} -> "
                    f"{rec.get('to_replica', '?')} "
                    f"({rec.get('pages', '?')} page(s), "
                    f"{rec.get('bytes', '?')} bytes)")
        s = f"{who} migrated"
        if rec.get("replica") or rec.get("to_replica"):
            s += (f" {rec.get('replica', '?')} -> "
                  f"{rec.get('to_replica', '?')}")
        s += f": resumed from shipped state at {rec.get('tokens', '?')} "
        s += "token(s), 0 recomputed"
        if rec.get("bytes") is not None:
            s += f" ({rec['bytes']} bytes moved)"
        return s
    if kind == "migrate_abort":
        s = f"{who} migration aborted ({rec.get('why', '?')})"
        if rec.get("replica"):
            s += f" on replica {rec['replica']}"
        return s + "; falling back to recompute replay"
    if kind == "wal_admit":
        return (f"{who} durably WAL'd pre-ACK "
                f"(fsync wait {rec.get('fsync_ms', '?')}ms, "
                f"{rec.get('n_prompt', '?')} prompt tokens)")
    if kind == "recover_replay":
        return (f"{who} recovered from the WAL at restart "
                f"({rec.get('outcome', 'replayed')}: "
                f"{rec.get('tokens', '?')} already-emitted token(s) "
                "restored without recompute)")
    if kind == "scale_up":
        phase = rec.get("phase", "?")
        s = (f"scaler growing tier {rec.get('tier', 'fleet')}: "
             f"member {rec.get('replica', '?')} {phase}")
        if rec.get("why"):
            s += f" ({rec['why']}"
            if rec.get("burn") is not None:
                s += f", burn {rec['burn']:.1f}x budget"
            if rec.get("queued") is not None:
                s += f", {rec['queued']} queued"
            s += ")"
        if phase == "done" and rec.get("spawn_ms") is not None:
            s += f", spawned in {rec['spawn_ms']:.0f}ms"
        if rec.get("fleet") is not None:
            s += f"; fleet -> {rec['fleet']}"
        return s
    if kind == "scale_down":
        phase = rec.get("phase", "?")
        s = (f"scaler retiring member {rec.get('replica', '?')} "
             f"from tier {rec.get('tier', 'fleet')} {phase}")
        if rec.get("why"):
            s += f" ({rec['why']})"
        if phase == "start" and rec.get("inflight") is not None:
            s += (f", {rec['inflight']} in-flight stream(s) migrating "
                  "off first")
        if phase == "aborted":
            s += "; member stays in rotation"
        if rec.get("fleet") is not None:
            s += f"; fleet -> {rec['fleet']}"
        return s
    if kind == "preempt_notice":
        s = (f"preemptible member {rec.get('replica', '?')} served a "
             f"termination notice")
        if rec.get("notice_s") is not None:
            s += f" ({rec['notice_s']:g}s window)"
        if rec.get("inflight") is not None:
            s += f", {rec['inflight']} in-flight stream(s) to migrate off"
        return s
    if kind == "standby_sync":
        s = (f"standby synced to replication seq {rec.get('seq', '?')} "
             f"(lag {rec.get('lag', '?')} record(s)")
        if rec.get("why"):
            s += f", {rec['why']}"
        if rec.get("epoch") is not None:
            s += f", primary epoch {rec['epoch']}"
        return s + ")"
    if kind == "router_takeover":
        phase = rec.get("phase", "?")
        s = f"router takeover {phase} ({rec.get('why', '?')})"
        if rec.get("from_epoch") is not None or rec.get("epoch") is not None:
            s += (f": epoch {rec.get('from_epoch', '?')} -> "
                  f"{rec.get('epoch', '?')}")
        if phase == "done":
            if rec.get("streams") is not None:
                s += (f", {rec['streams']} unfinished stream(s) re-admitted"
                      f" ({rec.get('migrated', 0)} migrated, "
                      f"{rec.get('replayed', 0)} replayed)")
            if rec.get("takeover_ms") is not None:
                s += f", took {rec['takeover_ms']:.0f}ms"
        return s
    if kind == "epoch_fence":
        s = (f"stale-epoch router call fenced: caller epoch "
             f"{rec.get('stale_epoch', '?')} < current "
             f"{rec.get('epoch', '?')}")
        if rec.get("path"):
            s += f" ({rec['path']})"
        return s
    return f"{kind} {who}"


# ---------------------------------------------------------------------------
# Replay signature: the normalized decision stream two runs must agree on.
# ---------------------------------------------------------------------------

def decision_signature(records: List[dict]) -> List[tuple]:
    out = []
    for r in records:
        kind = r.get("kind")
        if kind not in DECISION_KINDS:
            continue
        salient = tuple(r.get(f) for f in _SIG_FIELDS.get(kind, ()))
        out.append((kind, r.get("req_id"), r.get("user"), salient))
    return out


# ---------------------------------------------------------------------------
# Invariant checker: turns any journal (live ring tail, JSONL file, chaos
# run artifact) into a checked artifact. Tolerant of partial windows: a
# ring that evicted its head must not fabricate violations.
# ---------------------------------------------------------------------------

# An admitted request must reach a slot (install) or a terminal decision
# within this many subsequent prefill batches, or it is starving.
STARVATION_BATCHES = 50


def check_invariants(records: List[dict],
                     starve_after: Optional[int] = STARVATION_BATCHES
                     ) -> List[str]:
    """Returns violation strings (empty = clean). Checked invariants:

      1. pages conserved — every page event's post-state satisfies
         free + used + cached == pool (speculative rollbacks included:
         rejected-draft page releases must balance too);
      2. no slot double-assignment — an install on a slot whose observed
         holder never finished/preempted is a scheduler bug;
      3. preempt victim is never the VIP;
      4. shed only when bounds exceeded — a queue_full/user_queue_full
         shed whose recorded depth is below the recorded cap lied;
      5. no admitted request starves past `starve_after` prefill batches
         without progress (install/finish/requeue/retry/shed/preempt);
      6. speculation never accepts more than it proposed — a spec_verify
         with accepted > proposed fabricated tokens;
      7. tier decisions are well-formed — a tier_overflow whose from and
         to tiers are the same lied about crossing tiers, and a
         tier_regroup outside the start/done/aborted phase vocabulary is
         an instrumentation bug (tools/journal check additionally pairs
         every regroup start with its done/aborted, end-of-run).

    `starve_after=None` skips check 5 — sampled journals
    (--journal-sample < 1) drop a fraction of `batch` records, so the
    batch-ordinal starvation clock under-counts and cannot be trusted;
    every other check reads self-contained records and stays valid.
    """
    bad: List[str] = []
    # (model, replica, slot) -> req_id currently observed holding it
    # (data-parallel replicas of one model each number their slots).
    held: Dict[tuple, int] = {}
    # req_id -> batch ordinal at admit time (starvation tracking).
    admitted: Dict[int, int] = {}
    batches = 0
    progress = ("install", "finish", "requeue", "retry", "shed",
                "preempt", "deadline_drop", "poison")
    for r in records:
        kind = r.get("kind")
        seq = r.get("seq", "?")
        rid = r.get("req_id")
        if kind in ("page_alloc", "page_free", "page_evict",
                    "spec_rollback"):
            free, used = r.get("free"), r.get("used")
            cached, pool = r.get("cached"), r.get("pool")
            if None not in (free, used, cached, pool) \
                    and free + used + cached != pool:
                bad.append(
                    f"seq {seq}: pages not conserved after {kind}: "
                    f"free {free} + used {used} + cached {cached} "
                    f"!= pool {pool}")
        elif kind == "spec_verify":
            prop, acc = r.get("proposed"), r.get("accepted")
            if None not in (prop, acc) and acc > prop:
                bad.append(
                    f"seq {seq}: speculation accepted {acc} > proposed "
                    f"{prop} draft(s) for req {rid}")
        elif kind == "install" and (r.get("slot") or 0) >= 0:
            # slot -1 = an unslotted runtime (FakeRuntime): nothing to
            # double-assign.
            key = (r.get("model"), r.get("dp_replica", 0), r.get("slot"))
            holder = held.get(key)
            if holder is not None and holder != rid:
                where = f" (replica {key[1]})" if key[1] else ""
                bad.append(
                    f"seq {seq}: slot double-assignment: slot {key[2]} of "
                    f"{key[0]}{where} installed for req {rid} while held by "
                    f"req {holder}")
            held[key] = rid
        elif kind in ("finish", "preempt"):
            slot = r.get("slot")
            if slot is not None and slot >= 0:
                held.pop((r.get("model"), r.get("dp_replica", 0), slot), None)
        if kind == "preempt":
            vip = r.get("vip")
            if vip is not None and r.get("user") is not None \
                    and r.get("user") == vip:
                bad.append(
                    f"seq {seq}: preempt victim req {rid} IS the VIP "
                    f"({vip})")
        if kind == "tier_overflow":
            ft, tt = r.get("from_tier"), r.get("to_tier")
            if ft is not None and ft == tt:
                bad.append(
                    f"seq {seq}: tier_overflow from and to the same tier "
                    f"({ft}) for req {rid}")
        if kind == "tier_regroup" \
                and r.get("phase") not in ("start", "done", "aborted"):
            bad.append(
                f"seq {seq}: tier_regroup phase {r.get('phase')!r} not in "
                "start/done/aborted")
        if kind == "shed" and r.get("reason") in ("queue_full",
                                                  "user_queue_full"):
            queued, limit = r.get("queued"), r.get("limit")
            if queued is not None and limit is not None and queued < limit:
                bad.append(
                    f"seq {seq}: shed ({r['reason']}) below bound: "
                    f"queued {queued} < cap {limit}")
        if kind == "batch":
            batches += 1
        if kind == "admit" and rid is not None:
            admitted[rid] = batches
        elif kind in progress and rid is not None:
            admitted.pop(rid, None)
    if starve_after is None:
        return bad
    for rid, at_batch in admitted.items():
        if batches - at_batch >= starve_after:
            bad.append(
                f"req {rid} starved: admitted at batch {at_batch} with no "
                f"progress through batch {batches} "
                f"(>= {starve_after} cycles)")
    return bad


# ---------------------------------------------------------------------------
# Batch stats: occupancy / padding-waste from the composed-batch records.
# ---------------------------------------------------------------------------

def _padded_of(rec: dict) -> int:
    """Dispatched token positions of one batch record: the explicit
    padded total (ragged + new bucketed records) or bucket x rows
    (records spilled before the field existed)."""
    if rec.get("padded_tokens") is not None:
        return int(rec["padded_tokens"])
    return int(rec.get("bucket", 0)) * int(rec.get("batch_size", 0))


def batch_stats(records: List[dict]) -> dict:
    """Occupancy and padding-waste summary over `batch` records.

    padding_waste = fraction of dispatched token positions that were
    padding — power-of-two bucket rows on the bucketed path, the granule
    tail on the ragged path: the compute burned for shape stability.
    Per-mode rows break the two shapes apart when a journal holds both."""
    batches = [r for r in records if r.get("kind") == "batch"]
    if not batches:
        return {"batches": 0, "mean_occupancy": 0.0,
                "padding_waste": 0.0, "real_tokens": 0, "padded_tokens": 0}
    occ = sum(r.get("occupancy", 0.0) for r in batches) / len(batches)
    real = sum(int(r.get("tokens", 0)) for r in batches)
    padded = sum(_padded_of(r) for r in batches)
    out = {
        "batches": len(batches),
        "mean_occupancy": round(occ, 4),
        "padding_waste": round(1.0 - real / padded, 4) if padded else 0.0,
        "real_tokens": real,
        "padded_tokens": padded,
    }
    modes = sorted({r.get("mode", "bucketed") for r in batches})
    if len(modes) > 1:
        out["modes"] = {}
        for mode in modes:
            ms = [r for r in batches if r.get("mode", "bucketed") == mode]
            mreal = sum(int(r.get("tokens", 0)) for r in ms)
            mpad = sum(_padded_of(r) for r in ms)
            out["modes"][mode] = {
                "batches": len(ms),
                "padding_waste": (round(1.0 - mreal / mpad, 4)
                                  if mpad else 0.0),
            }
    return out


def fair_share_audit(records: List[dict]) -> dict:
    """Per-user decision accounting: enqueued/admitted/shed/preempted/
    finished counts — the offline answer to "who was the scheduler
    actually serving, and at whose expense"."""
    users: Dict[str, Dict[str, int]] = {}
    for r in records:
        u = r.get("user")
        if u is None:
            continue
        row = users.setdefault(u, {"enqueued": 0, "admitted": 0, "shed": 0,
                                   "preempted": 0, "finished": 0,
                                   "deadline_dropped": 0})
        k = r["kind"]
        if k == "enqueue":
            row["enqueued"] += 1
        elif k == "admit":
            row["admitted"] += 1
        elif k == "shed":
            row["shed"] += 1
        elif k == "preempt":
            row["preempted"] += 1
        elif k == "finish":
            row["finished"] += 1
        elif k == "deadline_drop":
            row["deadline_dropped"] += 1
    return users


def load_jsonl(path: str) -> Tuple[dict, List[dict]]:
    """Read a spilled journal file: (meta, records). Lines without a
    "kind" key (the header) feed meta; malformed lines are skipped with
    a count in meta["parse_errors"]."""
    meta: dict = {}
    records: List[dict] = []
    errors = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                errors += 1
                continue
            if "kind" in obj:
                records.append(obj)
            elif "journal_meta" in obj:
                meta = obj["journal_meta"]
    if errors:
        meta["parse_errors"] = errors
    return meta, records
