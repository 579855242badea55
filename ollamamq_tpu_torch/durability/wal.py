"""Durable admission WAL: the disk half of crash-safe serving.

One JSONL file (`<wal-dir>/wal.jsonl`) of three record kinds:

    {"k": "admit", "rid": R, "user": ..., "model": ..., "kind": ...,
     "raw_prompt": ..., "prompt": [ids...], "ctx": [ids...],
     "sampling": {...}, "max_tokens_total": S, "t": wall}
    {"k": "tok", "rid": R, "items": [[token_id, text], ...]}
    {"k": "fin", "rid": R, "reason": "stop"}

`admit` is the durability contract: the writer BLOCKS until the record
reaches disk (group commit — one fsync covers every admit that arrived
in the same --wal-fsync-ms window), so an ACKed enqueue survives
`kill -9`. `tok`/`fin` records are appended from the engine thread's
stream tap and flushed on the same fsync cadence: a crash loses at most
one window of progress, never an admitted request — greedy decoding
regenerates the lost tail identically on recovery. The write and fsync
run outside the buffer's lock, so the engine thread's appends never
wait on the disk.

Crash tolerance on the read side: a torn final line (the crash landed
mid-write) is skipped, not fatal; every complete prefix of the file is
a consistent recovery state. Compaction happens at recovery: live
requests are rewritten into a fresh file (admit + one folded tok line)
via write-new-then-rename, so the old generation only retires after the
new one durably holds the same state.

Disk trouble must not take serving down: any OSError (or an injected
fault at site "wal") degrades the WAL loudly — an alert fires, appends
become no-ops, serving continues un-journaled.

The record keys and value types are the JAX package's, line for line,
so either package recovers the other's WAL.

Router HA (fleet/ha.py) taps the WAL twice: `mirror` sees every record
as it is buffered (the replication ring), and `snapshot_lines(mark=)`
hands a cold standby the whole file. Lock order is `_io_lock`, then
`_lock`, then the coordinator's lock: the mirror runs under `_lock`, and
the snapshot holds `_io_lock` from its flush through its file read and
calls `mark` in the same `_lock` section that swaps the buffer out, so
the mark is exactly the snapshot's edge (every record at or below it is
in the lines, every one past it is not).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ollamamq_tpu_torch.telemetry import schema as tm

log = logging.getLogger("ollamamq.torch.wal")

WAL_NAME = "wal.jsonl"


def load_wal_records(path: str) -> Tuple[Dict[int, dict], int]:
    """Parse one WAL file into per-request live state.

    Returns ({rid: {"admit": dict, "toks": [[id, text], ...],
                    "finished": reason|None}}, torn_lines).
    Malformed/torn lines are counted and skipped — a crash mid-write
    must leave every complete prefix loadable."""
    out: Dict[int, dict] = {}
    torn = 0
    if not os.path.exists(path):
        return out, torn
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                k = rec["k"]
                rid = int(rec["rid"])
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                torn += 1
                continue
            if k == "admit":
                out[rid] = {"admit": rec, "toks": [], "finished": None}
            elif k == "tok":
                ent = out.get(rid)
                if ent is not None:
                    try:
                        ent["toks"].extend(
                            [int(i), str(t)] for i, t in rec["items"])
                    except (KeyError, TypeError, ValueError):
                        torn += 1
            elif k == "fin":
                ent = out.get(rid)
                if ent is not None:
                    ent["finished"] = rec.get("reason", "stop")
    return out, torn


class RequestWAL:
    """Append-only request log with group-commit fsync.

    Writers append JSON lines into an in-memory buffer under a lock and
    wake the flusher thread, which drains the buffer, `flush()` +
    `os.fsync()` at most once every `fsync_ms`, and signals waiters.
    `admit()` waits for the sync that covers its record (the durability
    ACK); `append_tokens()`/`finish()` are fire-and-forget (progress,
    not admission)."""

    def __init__(self, wal_dir: str, fsync_ms: float = 20.0,
                 fault_plan=None, on_degrade=None):
        self.dir = wal_dir
        self.path = os.path.join(wal_dir, WAL_NAME)
        self.fsync_ms = max(0.0, float(fsync_ms))
        self.fault_plan = fault_plan
        self.on_degrade = on_degrade
        self.dead = False
        self._fh = None
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._io_lock = threading.Lock()
        self._buf: List[str] = []
        self._appended = 0   # lines handed to the WAL
        self._synced = 0     # lines known durable
        self._stop = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        self.bytes_written = 0
        self.fsyncs = 0
        # Optional replication mirror (fleet/ha.py): called under `_lock`
        # with each record dict as it is buffered, so a warm standby's
        # replica tracks this WAL within a sync batch. Exceptions are
        # contained: replication trouble must not break the ACK path.
        self.mirror = None

    def _mirrored(self, rec: dict) -> dict:
        m = self.mirror
        if m is not None:
            try:
                m(rec)
            except Exception:  # noqa: BLE001
                pass
        return rec

    # -- lifecycle ---------------------------------------------------------
    def read_existing(self) -> Tuple[Dict[int, dict], int]:
        """The previous process generation's live state (recovery input).
        Call BEFORE begin() — begin() starts a fresh file."""
        return load_wal_records(self.path)

    def begin(self, initial: Optional[Dict[int, dict]] = None) -> None:
        """Open a fresh WAL generation. `initial` (the recovery pass's
        surviving live state) is compacted into it — admit + one folded
        tok line per request — via write-new-then-rename, so the old
        generation retires only once the new one is durable. The old
        file is kept one generation back (`wal.jsonl.1`) for forensics."""
        os.makedirs(self.dir, exist_ok=True)
        tmp = self.path + ".new"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                for rid, ent in (initial or {}).items():
                    f.write(json.dumps(ent["admit"]) + "\n")
                    if ent["toks"]:
                        f.write(json.dumps(
                            {"k": "tok", "rid": rid,
                             "items": ent["toks"]}) + "\n")
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(self.path):
                os.replace(self.path, self.path + ".1")
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")
            self.bytes_written = self._fh.tell()
        except OSError as e:
            self._degrade(f"WAL open failed: {e}")
            return
        self._stop.clear()
        self._flusher = threading.Thread(target=self._flush_loop,
                                         name="wal-flusher", daemon=True)
        self._flusher.start()

    def close(self) -> None:
        """Final flush + fsync (graceful shutdown)."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        t = self._flusher
        if t is not None:
            t.join(timeout=5.0)
            self._flusher = None
        self._flush()
        with self._io_lock, self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    # -- appends -----------------------------------------------------------
    def admit(self, rec: dict) -> float:
        """Durably record one admission; BLOCKS until the covering fsync
        lands (the enqueue ACK gate). Returns the wait in ms."""
        t0 = time.monotonic()
        self.wait_synced(self.buffer_admit(rec))
        return (time.monotonic() - t0) * 1e3

    def buffer_admit(self, rec: dict) -> Optional[int]:
        """The non-blocking half of admit(): queue the record ahead of
        any token line of its request and return the append ordinal that
        wait_synced() waits for (None when nothing will be waited on)."""
        if self.dead:
            return None
        with self._cond:
            self._buf.append(json.dumps(self._mirrored(rec)))
            self._appended += 1
            if self._fh is None:
                # Not begun yet (recovery in flight): the record rides
                # the compaction fsync in begin(); don't park the caller.
                return None
            if self.fsync_ms > 0:
                self._cond.notify_all()  # wake the flusher early
            return self._appended

    def wait_synced(self, target: Optional[int]) -> None:
        """Block until the fsync covering append ordinal `target` lands."""
        if target is None:
            return
        if self.fsync_ms <= 0:
            self._flush()
        with self._cond:
            while self._synced < target and not self.dead:
                if not self._cond.wait(timeout=5.0):
                    break  # wedged disk: degrade-by-timeout, serve on

    def append_tokens(self, rid: int, items: List[list]) -> None:
        """Buffer emitted-token progress ([id, text] pairs); the flusher
        makes it durable within one fsync window."""
        if self.dead or not items:
            return
        with self._lock:
            self._buf.append(json.dumps(self._mirrored(
                {"k": "tok", "rid": rid, "items": items})))
            self._appended += 1
            self._cond.notify()  # wake an idle flusher

    def finish(self, rid: int, reason: str) -> None:
        if self.dead:
            return
        with self._lock:
            self._buf.append(json.dumps(self._mirrored(
                {"k": "fin", "rid": rid, "reason": reason})))
            self._appended += 1
            self._cond.notify()

    def snapshot_lines(self, mark=None) -> List[str]:
        """(HA cold catch-up) Flush everything buffered, then return the
        current generation's raw JSONL lines. `_io_lock` is held from the
        flush to the end of the read, so no other flush lands lines past
        the edge in between; `mark` (optional callback) runs under
        `_lock` in the section that swaps the buffer out, where mirror
        calls also run: a replication head captured there is exactly the
        snapshot's edge. Records at or before it are in these lines,
        records after it are in the ring, never both."""
        with self._io_lock:
            self._flush_io(mark)
            lines: List[str] = []
            try:
                if os.path.exists(self.path):
                    with open(self.path, encoding="utf-8") as f:
                        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
            except OSError:
                lines = []
            return lines

    # -- flusher -----------------------------------------------------------
    def _flush(self) -> None:
        """Write + fsync everything buffered. The buffer lock is held only
        to take the lines and to publish the sync, never across the disk
        write: the engine thread's token appends never wait on an fsync
        (`_io_lock` keeps writers in order)."""
        with self._io_lock:
            self._flush_io()

    def _flush_io(self, mark=None) -> None:
        """(`_io_lock` held) The body of _flush. `mark` runs under `_lock`
        in the section that takes the buffer (snapshot_lines)."""
        with self._cond:
            if mark is not None:
                mark()
            if self._fh is None or self.dead:
                self._synced = self._appended
                self._cond.notify_all()
                return
            if not self._buf:
                return
            lines, self._buf = self._buf, []
            target = self._appended
        t0 = time.monotonic()
        try:
            if self.fault_plan is not None:
                self.fault_plan.check("wal")
            data = "\n".join(lines) + "\n"
            self._fh.write(data)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.bytes_written += len(data)
            self.fsyncs += 1
            tm.WAL_FSYNC_MS.observe((time.monotonic() - t0) * 1e3)
            err = None
        except Exception as e:  # noqa: BLE001 — disk trouble degrades
            err = e
        with self._cond:
            if err is not None:
                self._degrade(f"WAL write failed: {err}")
            self._synced = max(self._synced, target)
            self._cond.notify_all()

    def _flush_loop(self) -> None:
        """Sleep until a record is buffered, flush, then hold off one
        group-commit window so the records arriving in it share the next
        fsync. An idle WAL wakes nobody: on an H100 host a flusher that
        polled every 2 ms slowed the engine thread's eager dispatch by
        ~15% (scripts/torch_wal_ab.py, variant poll)."""
        period = max(0.001, self.fsync_ms / 1e3)
        while not self._stop.is_set():
            with self._cond:
                while not self._buf and not self._stop.is_set():
                    self._cond.wait()
            self._flush()
            if self._stop.wait(period):
                return

    def _degrade(self, msg: str) -> None:
        """Disk trouble must not take serving down: stop writing, tell
        the operator loudly, release every waiter."""
        if self.dead:
            return
        self.dead = True
        log.error("WAL degraded (serving continues WITHOUT crash "
                  "durability): %s", msg)
        fh, self._fh = self._fh, None
        if fh is not None:
            try:
                fh.close()
            except OSError:
                pass
        self._synced = self._appended
        try:
            self._cond.notify_all()  # only valid if lock held; best-effort
        except RuntimeError:
            pass
        cb = self.on_degrade
        if cb is not None:
            try:
                cb(msg)
            except Exception:  # noqa: BLE001
                log.exception("WAL degrade callback failed")

    def status(self) -> dict:
        return {"path": self.path, "fsync_ms": self.fsync_ms,
                "dead": self.dead, "fsyncs": self.fsyncs,
                "bytes": self.bytes_written}
