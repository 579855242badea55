"""Durability manager: WAL wiring, cold-restart recovery, resumable
streams.

One manager per serving front-end (TorchEngine or FakeEngine, which own
admission). It owns three pieces:

  RequestWAL       the durable admission log (durability/wal.py);
  StreamRegistry   per-stream frame log fed by a TokenStream tap: every
                   (token_id, text) item a client stream carried, plus
                   its terminal — what `GET /api/stream/{rid}?from=N`
                   replays byte-identical;
  recovery pass    at start(): read the previous generation's WAL,
                   re-admit every unfinished request token-exact through
                   the front-end's own enqueue path (`context` replay —
                   generated_ids pre-filled, max_tokens re-based so the
                   total budget is unchanged), journal `recover_replay`,
                   and compact the surviving state into a fresh WAL
                   generation.

Recovered streams have no client attached; a drainer thread consumes
their TokenStreams (the tap already captured every item) so generation
proceeds, and a reattaching client replays from the registry. Stream
identity is the rid the client saw on its NDJSON frames — recovery keys
the registry under the OLD rid (aliased to the new one), so the handle
printed before the crash still resolves after it.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from ollamamq_tpu_torch.durability.wal import RequestWAL
from ollamamq_tpu_torch.telemetry import schema as tm

log = logging.getLogger("ollamamq.torch.durability")

# Finished streams kept replayable for late resume; live streams are
# never evicted.
ARCHIVE_STREAMS = 512


class StreamEntry:
    """One stream's replayable history: (token_id, text) frames in emit
    order plus the terminal. Indexing for ?from=N counts frames whose
    token_id >= 0 (held-back/flush text rides id -1 frames)."""

    __slots__ = ("rid", "frames", "terminal", "lock", "recovered")

    def __init__(self, rid: int, recovered: bool = False):
        self.rid = rid
        self.frames: List[Tuple[int, str]] = []
        self.terminal: Optional[dict] = None
        self.lock = threading.Lock()
        self.recovered = recovered

    def append(self, token_id: int, text: str) -> None:
        with self.lock:
            if self.terminal is None:
                self.frames.append((int(token_id), text))

    def finish(self, reason: str, error: str = "") -> None:
        with self.lock:
            if self.terminal is None:
                self.terminal = {"reason": reason, "error": error}

    def snapshot(self, start: int) -> Tuple[List[Tuple[int, str]],
                                            Optional[dict]]:
        with self.lock:
            return self.frames[start:], self.terminal

    def token_count(self) -> int:
        with self.lock:
            return sum(1 for tid, _ in self.frames if tid >= 0)


class StreamRegistry:
    """rid -> StreamEntry, with aliasing (a recovered stream's new rid
    points at its original entry) and bounded archival of finished
    entries."""

    def __init__(self, max_entries: int = ARCHIVE_STREAMS):
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: Dict[int, StreamEntry] = {}
        self._order: List[int] = []  # insertion order, eviction candidates

    def create(self, rid: int, recovered: bool = False) -> StreamEntry:
        ent = StreamEntry(rid, recovered=recovered)
        with self._lock:
            self._entries[rid] = ent
            self._order.append(rid)
            self._evict_locked()
        return ent

    def alias(self, rid: int, entry: StreamEntry) -> None:
        with self._lock:
            self._entries[rid] = entry

    def find(self, rid: int) -> Optional[StreamEntry]:
        with self._lock:
            return self._entries.get(rid)

    def _evict_locked(self) -> None:
        # Evict oldest FINISHED entries past the cap; live streams stay.
        while len(self._order) > self.max_entries:
            for i, rid in enumerate(self._order):
                ent = self._entries.get(rid)
                if ent is None or ent.terminal is not None:
                    self._order.pop(i)
                    if ent is not None:
                        self._entries = {k: v for k, v
                                         in self._entries.items()
                                         if v is not ent}
                    break
            else:
                return  # everything live: let it grow (bounded by slots)


def _sampling_state(s) -> dict:
    return {
        "temperature": s.temperature, "top_k": s.top_k, "top_p": s.top_p,
        "repeat_penalty": s.repeat_penalty,
        "presence_penalty": s.presence_penalty,
        "frequency_penalty": s.frequency_penalty,
        "seed": s.seed, "max_tokens": s.max_tokens,
        "stop": list(s.stop), "deadline_ms": s.deadline_ms,
    }


def _sampling_from_state(state: dict, max_tokens: int):
    """Rebuild SamplingParams with fields set RAW (the stored seed is
    already folded — running __post_init__ on it would re-fold and fork
    the sampled stream; same convention as request_from_migration_state)."""
    from ollamamq_tpu_torch.ops.sampling import SamplingParams

    sp = SamplingParams()
    for key, val in (state or {}).items():
        setattr(sp, key, val)
    sp.stop = tuple(sp.stop or ())
    sp.max_tokens = max_tokens
    return sp


class DurabilityManager:
    """See module docstring. Attached as `engine.durability` when
    EngineConfig.wal_dir is set; None otherwise (zero overhead)."""

    def __init__(self, ecfg, journal=None, alerts=None, fault_plan=None):
        self.ecfg = ecfg
        self.journal = journal
        self.alerts = alerts
        self.registry = StreamRegistry()
        self.wal = RequestWAL(ecfg.wal_dir, fsync_ms=ecfg.wal_fsync_ms,
                              fault_plan=fault_plan,
                              on_degrade=self._on_degrade)
        self.recovering = False
        self.recovered_streams = 0
        self._started = False
        self._recover_key: Optional[int] = None  # set around re-admission
        self._orphans: Dict[int, object] = {}    # entry-rid -> Request
        self._orphan_lock = threading.Lock()
        self._stop = threading.Event()
        self._drainer: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self, engine) -> None:
        """Recovery + WAL begin. Called from the front-end's start()
        AFTER its loop thread is up (re-admission needs a live engine).
        Idempotent across hot-restarts: recovery runs once per manager."""
        if self._started:
            if self.wal._fh is None and not self.wal.dead:
                self.wal.begin()  # re-opened after a close()
            self._ensure_drainer()
            return
        self._started = True
        self.recovering = True
        try:
            prev, torn = self.wal.read_existing()
            live = self._recover(engine, prev)
            if torn:
                log.warning("WAL recovery skipped %d torn line(s)", torn)
        finally:
            self.recovering = False
        self.wal.begin(initial=live)
        self._ensure_drainer()

    def _ensure_drainer(self) -> None:
        """Start the drainer only while recovered streams lack a client:
        orphans come from recovery alone, so a process that recovered
        nothing runs no drainer and pays no idle wake-ups."""
        with self._orphan_lock:
            if not self._orphans:
                return
        if self._drainer is None or not self._drainer.is_alive():
            self._stop.clear()
            self._drainer = threading.Thread(target=self._drain_loop,
                                             name="wal-drainer",
                                             daemon=True)
            self._drainer.start()

    def close(self) -> None:
        """Graceful shutdown: final flush + fsync of the WAL."""
        self._stop.set()
        t = self._drainer
        if t is not None:
            t.join(timeout=5.0)
            self._drainer = None
        self.wal.close()

    def wal_snapshot(self, mark=None) -> List[str]:
        """(HA) The current WAL generation's raw lines after a forced
        flush, the standby's cold catch-up payload. `mark` runs at the
        snapshot edge (see RequestWAL.snapshot_lines)."""
        return self.wal.snapshot_lines(mark=mark)

    def _on_degrade(self, msg: str) -> None:
        if self.alerts is not None:
            try:
                self.alerts.fire("wal_degraded", "error",
                                 f"admission WAL degraded: {msg}",
                                 source="durability")
            except Exception:  # noqa: BLE001
                log.exception("wal_degraded alert failed")

    # -- admission ---------------------------------------------------------
    def admit(self, req, prompt_tokens=None) -> None:
        """Durably record one accepted generation request BEFORE the
        enqueue ACK returns, and start capturing its stream. `prompt_tokens`
        is the PRISTINE client prompt (before any context fold — the
        caller has it in hand; recovery re-folds explicitly)."""
        self.commit(req, self.capture(req, prompt_tokens))

    def capture(self, req, prompt_tokens=None):
        """The first half of admit(): install the stream tap and queue the
        admission record, without waiting on the disk. A front-end calls
        this while it still holds the lock that makes `req` visible to its
        loop, so no token can be emitted before the tap is in place (a
        request the loop served before its tap went in would reach its
        terminal with the registry and the WAL never told). Returns the
        ticket commit() takes."""
        if req.kind != "generate":
            return None  # embeds recompute cheaply and carry no stream
        key = self._recover_key
        if key is not None:
            # Recovery re-admission: the WAL entry (old rid, folded
            # state) is written by the compaction in begin(); here we
            # only rewire the live capture under the ORIGINAL identity.
            entry = self.registry.find(key)
            if entry is not None:
                self.registry.alias(req.req_id, entry)
                self._install_tap(req, entry, key)
                return None
        rid = int(req.req_id)
        pristine = [int(t) for t in (prompt_tokens
                                     if prompt_tokens is not None
                                     else req.prompt_tokens)]
        rec = {
            "k": "admit", "rid": rid, "t": time.time(),
            "user": req.user, "model": req.model, "kind": req.kind,
            "raw_prompt": req.raw_prompt,
            "prompt": pristine,
            "ctx": [int(t) for t in req.generated_ids],
            "sampling": _sampling_state(req.sampling),
            "max_tokens_total": int(req.sampling.max_tokens),
        }
        entry = self.registry.create(rid)
        # The admission line is buffered before the tap can buffer any
        # token line of this request.
        target = self.wal.buffer_admit(rec)
        self._install_tap(req, entry, rid)
        return (target, time.monotonic(), len(pristine))

    def commit(self, req, ticket) -> None:
        """The second half of admit(): wait for the fsync covering the
        admission (the enqueue ACK gate) and journal it."""
        if ticket is None:
            return
        target, t0, n_prompt = ticket
        self.wal.wait_synced(target)
        if self.journal is not None:
            self.journal.record("wal_admit", req=req,
                                fsync_ms=round((time.monotonic() - t0)
                                               * 1e3, 3),
                                n_prompt=n_prompt)

    def _install_tap(self, req, entry: StreamEntry, wal_rid: int) -> None:
        wal = self.wal

        def tap(item) -> None:
            if item.kind == "token":
                entry.append(item.token_id, item.text)
                wal.append_tokens(
                    wal_rid, [[int(item.token_id), item.text]])
            else:
                reason = (item.finish_reason.value
                          if item.finish_reason is not None
                          else ("error" if item.kind == "error" else "stop"))
                entry.finish(reason, error=item.error)
                wal.finish(wal_rid, reason)

        req.stream.tap = tap

    # -- recovery ----------------------------------------------------------
    def _recover(self, engine, prev: Dict[int, dict]) -> Dict[int, dict]:
        """Re-admit every unfinished WAL'd request token-exact; returns
        the live state the fresh WAL generation is compacted from."""
        live: Dict[int, dict] = {}
        if prev:
            # Pre-crash clients still hold their old rids (the resume
            # handles their NDJSON frames carried): advance the id
            # counter past them so this generation's fresh requests can
            # never collide in the stream registry or on the wire.
            reserve = getattr(getattr(engine, "core", None),
                              "reserve_req_ids", None)
            if reserve is not None:
                reserve(max(prev) + 1)
        for rid in sorted(prev):
            ent = prev[rid]
            if ent["finished"] is not None:
                # Finished before the crash: nothing to re-admit, but a
                # client cut off mid-read can still replay the archive
                # through the resume endpoint.
                entry = self.registry.create(rid, recovered=True)
                for tid, text in ent["toks"]:
                    entry.append(tid, text)
                entry.finish(ent["finished"])
                continue
            admit = ent["admit"]
            toks = ent["toks"]
            gen = ([int(t) for t in admit.get("ctx") or []]
                   + [int(i) for i, _ in toks])
            total = int(admit.get("max_tokens_total") or 0)
            entry = self.registry.create(rid, recovered=True)
            for tid, text in toks:
                entry.append(tid, text)
            remaining = total - len(gen)
            if remaining <= 0:
                # The budget was already spent when the process died:
                # nothing to regenerate — surface the terminal the crash
                # swallowed so a resuming client gets its done frame.
                entry.finish("length")
                self.wal.finish(rid, "length")  # buffered until begin()
                self._note_recovered(rid, admit, len(gen),
                                     outcome="finished")
                live[rid] = ent
                continue
            sp = _sampling_from_state(admit.get("sampling"),
                                      max_tokens=remaining)
            self._recover_key = rid
            try:
                req = engine.enqueue_request(
                    admit.get("user", "anonymous"), "",
                    admit.get("model", ""),
                    prompt_tokens=[int(t) for t in admit.get("prompt", [])],
                    sampling=sp, kind="generate",
                    raw_prompt=admit.get("raw_prompt", ""),
                    context_ids=gen or None)
            except Exception as e:  # noqa: BLE001 — one bad entry must
                # not sink the rest of the recovery pass
                log.exception("WAL recovery of req %d failed", rid)
                entry.finish("error", error=f"recovery failed: {e}")
                self._note_recovered(rid, admit, len(gen),
                                     outcome="failed")
                continue
            finally:
                self._recover_key = None
            with self._orphan_lock:
                self._orphans[rid] = req
            self._note_recovered(req.req_id, admit, len(gen),
                                 outcome="replayed", wal_rid=rid)
            self.recovered_streams += 1
            live[rid] = ent
        return live

    def _note_recovered(self, rid: int, admit: dict, tokens: int,
                        outcome: str,
                        wal_rid: Optional[int] = None) -> None:
        tm.RECOVERED_STREAMS_TOTAL.labels(outcome=outcome).inc()
        if self.journal is not None:
            # req_id = the RE-ADMITTED id (the one this journal's later
            # finish record will carry), so the exactly-one-terminal
            # audit pairs them; wal_rid = the pre-crash client handle.
            self.journal.record(
                "recover_replay", req_id=rid,
                user=admit.get("user"), model=admit.get("model") or None,
                tokens=tokens, outcome=outcome,
                n_prompt=len(admit.get("prompt") or ()),
                wal_rid=wal_rid)
        log.warning("WAL recovery: req %d %s (%d token(s) restored)",
                    rid, outcome, tokens)

    def _drain_loop(self) -> None:
        """Consume recovered (client-less) streams so generation
        proceeds; the tap already captured every item, so drained items
        are discarded. A reattaching client replays from the registry.
        Exits once every orphan reached its terminal."""
        while not self._stop.wait(0.02):
            with self._orphan_lock:
                items = list(self._orphans.items())
            if not items:
                return
            for rid, req in items:
                done = False
                while (item := req.stream.get_nowait()) is not None:
                    if item.kind in ("done", "error"):
                        done = True
                if done:
                    with self._orphan_lock:
                        self._orphans.pop(rid, None)

    # -- introspection -----------------------------------------------------
    def status(self) -> dict:
        with self._orphan_lock:
            orphans = len(self._orphans)
        return {
            "enabled": True,
            "recovering": self.recovering,
            "recovered_streams": self.recovered_streams,
            "orphan_streams": orphans,
            "wal": self.wal.status(),
        }
