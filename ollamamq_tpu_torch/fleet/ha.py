"""Router HA: warm-standby router with replayed takeover + epoch fencing.

The fleet router is the one process the rest of the fleet cannot route
around: members are interchangeable (eject, migrate, failover)
but the router that places them is a single point of failure. This
module closes that hole with a PRIMARY/STANDBY pair:

  - the PRIMARY (--ha) exposes its replicated state over
    GET /admin/ha/sync: every WAL record (admit/tok/fin — the durability
    contract) and every decision-journal record, sequence-numbered into
    a bounded ring, plus a shadow-state blob (member roster, tiers,
    in-flight stream table, fleet size). The standby's poll cursor IS
    the ack: lag = head - last_acked;
  - the STANDBY (--standby-of URL) tails that stream into replica files
    in its own --wal-dir: `wal.jsonl` (byte-compatible with the WAL the
    recovery path reads — fsynced per batch, so promotion inherits the
    primary's fsync continuity) and `primary-journal.jsonl` (a
    spill-compatible journal replica the offline audits accept). Cold
    catch-up and ring overrun ship a whole-file WAL snapshot instead of
    records — compaction lines written by begin() bypass the mirror, so
    a record-only catch-up from seq 0 would silently miss them;
  - the standby detects primary death by heartbeat loss (polls failing
    for longer than --takeover-grace-s) and PROMOTES: bump a monotonic
    epoch (persisted in ha_state.json, so a revived standby never
    reuses one), re-register every member under the new epoch, re-admit
    every unfinished replica-WAL stream through the existing recovery
    path (byte-identical greedy replay — never drop), then serve. A
    promoted standby constructs its own HACoordinator, so chained HA
    (a standby of the promoted router) works;
  - epoch fencing: every member-facing call carries X-Router-Epoch;
    members ADOPT a higher epoch and REJECT (409) a lower one — a
    zombie primary that revives after takeover is fenced out of the
    fleet, not split-braining it;
  - graceful handover: SIGTERM on an HA primary flips the sync stream's
    handover flag; the standby then CATCHES UP — it keeps polling and
    applying until its cursor reaches the primary's head (covering
    records past the last routine poll: quiesce-drain tok/fin and any
    backlog beyond one batch) and only then sends a confirm poll
    (`confirm=1`). The primary's SIGTERM wait releases on that confirm
    alone — never on a routine poll, which at lag 0 would let the
    primary exit before the standby even started catching up — and the
    standby promotes with why="handover". The fleet changes routers
    without draining the world, and nothing durably ACKed is left out
    of the replica.

Fault site "router" (testing/faults.py) is drawn once per sync poll:
"exception" fails the poll as if the primary crashed, "slow" stalls the
observed heartbeat past the grace, "device_loss" keeps polls failing
until heal_after_s — the revive-and-fence chaos case.

Lock order is the WAL's `_io_lock`, then its `_lock`, then the
coordinator's `_lock`, everywhere: the WAL mirror calls _on_wal_record
while holding the WAL's `_lock`; the snapshot holds `_io_lock` from its
flush through its file read and runs the head-mark callback under the
WAL's `_lock` in the section that takes the buffer — the coordinator
never touches the WAL while holding its own lock.

The JAX package's fleet/ha.py on the port's stdlib server and threads.
A handler thread writes the sync replies; the caught-up confirm poll's
reply is written before the SIGTERM'd primary's handover returns
(request_handover waits on sync_reply_sent, which the server calls once
that reply is on the socket).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
import urllib.request
from typing import List, Optional

from ollamamq_tpu_torch.durability.wal import WAL_NAME, load_wal_records
from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.telemetry.journal import DECISION_KINDS

log = logging.getLogger("ollamamq.torch.ha")

# Replication ring: bounded memory on the primary no matter how far a
# standby falls behind — past this, catch-up degrades to a WAL snapshot.
SYNC_RING_CAPACITY = 8192
SYNC_MAX_RECORDS = 512       # records per sync batch
POLL_FLOOR_S = 0.05          # standby poll cadence floor (grace/4 above)
# How long a released handover waits for the confirm reply to reach its
# socket before the primary exits anyway.
CONFIRM_REPLY_WAIT_S = 2.0
HA_STATE_NAME = "ha_state.json"
JOURNAL_REPLICA_NAME = "primary-journal.jsonl"


def load_ha_state(wal_dir: str) -> dict:
    """Persisted HA state (epoch + takeover-cost EMA) from a wal-dir.
    Missing/corrupt file reads as empty — first boot starts at epoch 1."""
    try:
        with open(os.path.join(wal_dir, HA_STATE_NAME),
                  encoding="utf-8") as f:
            d = json.load(f)
        return d if isinstance(d, dict) else {}
    except (OSError, json.JSONDecodeError):
        return {}


def save_ha_state(wal_dir: str, epoch: int,
                  takeover_ms_ema: Optional[float] = None) -> None:
    """Durably persist the epoch (write-new-then-rename + fsync): a
    promoted router must never come back up claiming an older epoch —
    that would un-fence the zombie it just fenced."""
    path = os.path.join(wal_dir, HA_STATE_NAME)
    tmp = path + ".new"
    try:
        # The coordinator persists its epoch at ROUTER construction,
        # before the WAL has opened (created) the directory.
        os.makedirs(wal_dir, exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"epoch": int(epoch),
                       "takeover_ms_ema": takeover_ms_ema}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        log.exception("HA state persist failed (epoch %d)", epoch)


class HACoordinator:
    """Primary-side half: taps the WAL and the decision journal into a
    sequence-numbered replication ring served over /admin/ha/sync."""

    def __init__(self, router):
        if router.durability is None:
            raise ValueError("--ha requires --wal-dir: the replication "
                             "stream ships WAL records")
        self.router = router
        self.ecfg = router.ecfg
        self.wal_dir = router.ecfg.wal_dir
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=SYNC_RING_CAPACITY)
        self.head = 0         # last sequence number assigned
        self.last_acked = 0   # highest from_seq any standby poll carried
        self._last_poll: Optional[float] = None  # monotonic, last sync poll
        self.handover = False
        self._handover_target = 0
        self._handover_acked = threading.Event()
        # The reply dict of the confirm poll that released the handover,
        # and the event its handler sets once that reply is written.
        self._releasing: Optional[dict] = None
        self._release_written = threading.Event()
        st = load_ha_state(self.wal_dir)
        self.epoch = max(1, int(st.get("epoch") or 1))
        save_ha_state(self.wal_dir, self.epoch, st.get("takeover_ms_ema"))
        router.epoch = self.epoch
        # Replication taps. The WAL mirror runs under the WAL lock; the
        # journal tap runs outside the journal lock (journal.py contains
        # tap exceptions). Both just stamp a seq and append to the ring.
        router.durability.wal.mirror = self._on_wal_record
        router.journal.tap = self._on_journal_record

    # -- taps (primary's hot paths; must stay cheap) -----------------------
    def _push(self, kind: str, rec: dict) -> None:
        with self._lock:
            self.head += 1
            self._ring.append((self.head, kind, rec))

    def _on_wal_record(self, rec: dict) -> None:
        self._push("wal", rec)

    def _on_journal_record(self, rec: dict) -> None:
        # Decision records only: the standby's shadow state and the
        # offline audits need placements/failovers/takeovers, not every
        # per-token scheduler record.
        if rec.get("kind") in DECISION_KINDS:
            self._push("journal", rec)

    # -- member registration ----------------------------------------------
    def on_router_start(self) -> None:
        """Stamp every member with this router's epoch (members adopt it
        and fence anything older). Down members adopt lazily: every
        member-facing call carries the epoch header anyway."""
        for m in self.router.members:
            m.register(self.epoch)

    # -- the sync endpoint's engine half -----------------------------------
    def sync_batch(self, from_seq: int,
                   max_records: int = SYNC_MAX_RECORDS, *,
                   want_snapshot: bool = False,
                   confirm_handover: bool = False) -> dict:
        """One standby poll: ack `from_seq`, return records past it (or
        a whole-file WAL snapshot on cold start / ring overrun) plus the
        shadow-state blob. The poll cursor is the ack — no second
        round-trip. `want_snapshot` is the standby's explicit one-time
        initial-snapshot request (it sends it until a snapshot lands).
        `confirm_handover` is the standby's caught-up handover confirm:
        only it releases the SIGTERM wait — a routine poll at lag 0
        would otherwise release the primary before the standby had even
        begun catching up, and the primary would exit under it."""
        from_seq = max(0, int(from_seq))
        now = time.monotonic()
        resp = {"role": "primary", "epoch": self.epoch}
        with self._lock:
            self.last_acked = max(self.last_acked,
                                  min(from_seq, self.head))
            self._last_poll = now
            oldest = self._ring[0][0] if self._ring else self.head + 1
            # Cold catch-up ALWAYS snapshots: begin()'s compaction lines
            # bypass the mirror, so seq-0 record replay would miss them.
            # head == 0 (idle/fresh primary) only snapshots when the
            # standby asks — otherwise every poll would re-ship and
            # re-fsync the whole replica until the first record lands.
            need_snapshot = (want_snapshot or from_seq + 1 < oldest
                             or (from_seq <= 0 < self.head))
            if (self.handover and confirm_handover
                    and from_seq >= self._handover_target):
                self._releasing = resp
                self._handover_acked.set()
        resp.update(handover=self.handover, state=self._state_blob())
        if need_snapshot:
            marker = {}

            def _mark():
                # Runs under the WAL's _lock: mirror pushes hold that
                # lock too, so this head is exactly the snapshot's edge
                # — every record <= it is in the file, every one past it
                # will be in the ring. (Lock order wal -> ha.)
                with self._lock:
                    marker["head"] = self.head

            lines = self.router.durability.wal.snapshot_lines(mark=_mark)
            snap_head = marker.get("head", self.head)
            resp.update(snapshot=lines, snapshot_head=snap_head,
                        head=snap_head, records=[])
            tm.HA_SYNC_LAG_RECORDS.set(0)
            return resp
        recs: List[dict] = []
        with self._lock:
            for seq, kind, rec in self._ring:
                if seq <= from_seq:
                    continue
                if len(recs) >= max_records:
                    break
                recs.append({"seq": seq, "kind": kind, "rec": rec})
            head = self.head
            lag = max(0, head - self.last_acked)
        for r in recs:
            tm.HA_SYNC_RECORDS_TOTAL.labels(kind=r["kind"]).inc()
        tm.HA_SYNC_LAG_RECORDS.set(lag)
        resp.update(head=head, records=recs)
        return resp

    def _state_blob(self) -> dict:
        """Shadow placement state: enough for the standby's /health and
        TUI to describe the fleet it would inherit. Authoritative
        recovery state is the WAL replica, not this."""
        r = self.router
        mems = []
        for m in r.members:
            mems.append({"name": m.name,
                         "url": getattr(m, "url", None),
                         "state": getattr(m, "state", None),
                         "tier": getattr(m, "tier", None)})
        inflight = []
        for fl in list(r.flights):  # loop-thread appends; snapshot read
            if not fl.done and fl.member is not None:
                inflight.append([fl.rid0, fl.member.name])
        return {"members": mems, "fleet": len(mems),
                "placement": r.placement, "inflight": inflight,
                "tiered": r.tiers is not None,
                "autoscale": r.autoscaler is not None}

    def sync_reply_sent(self, resp: dict) -> None:
        """The server wrote `resp` (a sync reply) to its socket: when it
        is the reply that released the handover, the primary may exit."""
        if resp is self._releasing:
            self._release_written.set()

    # -- handover (graceful SIGTERM on the primary) ------------------------
    def request_handover(self, timeout_s: float = 10.0) -> bool:
        """Advertise handover on the sync stream and wait for a
        caught-up standby confirm poll acking everything up to the
        current head (its promotion follows immediately). False = no
        standby ever connected, or it never confirmed in time — the
        caller falls back to draining."""
        with self._lock:
            if self._last_poll is None:
                return False
            self.handover = True
            self._handover_target = self.head
            self._handover_acked.clear()
            self._releasing = None
            self._release_written.clear()
        log.warning("HA handover requested: waiting for standby to ack "
                    "seq %d", self._handover_target)
        ok = self._handover_acked.wait(timeout_s)
        if not ok:
            with self._lock:
                self.handover = False  # stop advertising; we drain instead
            log.error("HA handover timed out after %.1fs — falling back "
                      "to drain", timeout_s)
        elif not self._release_written.wait(CONFIRM_REPLY_WAIT_S):
            # The ack fires in sync_batch, before the handler thread
            # writes the confirm reply; the caller exits the process
            # next, which would cut that write. Past the wait the
            # standby's catch-up still reads a dead socket after an
            # answered confirm as the planned exit.
            log.warning("HA handover: the confirm reply was not written "
                        "within %.1fs; exiting anyway",
                        CONFIRM_REPLY_WAIT_S)
        return ok

    def promote_eta_s(self) -> Optional[float]:
        return None  # a serving primary never sheds for promotion

    def status(self) -> dict:
        now = time.monotonic()
        with self._lock:
            lag = max(0, self.head - self.last_acked)
            seen = self._last_poll
        grace = float(getattr(self.ecfg, "takeover_grace_s", 3.0) or 3.0)
        connected = seen is not None and (now - seen) < max(2.0, 2 * grace)
        return {"role": "primary", "epoch": self.epoch,
                "sync_lag_records": lag if seen is not None else None,
                "standby_connected": connected,
                "handover": self.handover}


class HAStandby:
    """Standby-side half: tails the primary's sync stream into replica
    files, watches its heartbeat, and promotes the (unstarted) local
    FleetRouter when the primary dies or hands over."""

    def __init__(self, router, primary_url: str, fault_plan=None):
        if router.durability is None:
            raise ValueError("--standby-of requires --wal-dir: promotion "
                             "replays the replica WAL")
        self.router = router
        self.primary_url = primary_url.rstrip("/")
        self.wal_dir = router.ecfg.wal_dir
        self.grace = float(
            getattr(router.ecfg, "takeover_grace_s", 3.0) or 3.0)
        self.poll_s = max(POLL_FLOOR_S, min(0.25, self.grace / 4.0))
        self.fault_plan = (fault_plan if fault_plan is not None
                           else router.fault_plan)
        self.role = "standby"
        self.applied = 0        # last replication seq durably applied
        self.head = 0           # primary's head as of the last good poll
        self.epoch_seen = max(1, int(load_ha_state(self.wal_dir)
                                     .get("epoch") or 1))
        self.state: dict = {}   # latest shadow blob from the primary
        self.synced = False     # a snapshot has landed since start
        self.takeover_count = 0
        self.takeover_ms_ema = load_ha_state(self.wal_dir) \
            .get("takeover_ms_ema")
        self.last_error: Optional[str] = None
        self._never_synced_logged: Optional[float] = None
        self.promoted = threading.Event()
        self._promote_begin: Optional[float] = None
        self._last_ok = time.monotonic()
        self._had_failure = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._wal_path = os.path.join(self.wal_dir, WAL_NAME)
        self._journal_path = os.path.join(self.wal_dir,
                                          JOURNAL_REPLICA_NAME)
        self._wal_fh = None
        self._journal_fh = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._open_replicas()
        self._last_ok = time.monotonic()
        self._thread = threading.Thread(target=self._loop,
                                        name="ha-standby", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        self._close_replicas()

    def _open_replicas(self) -> None:
        os.makedirs(self.wal_dir, exist_ok=True)
        self._wal_fh = open(self._wal_path, "a", encoding="utf-8")
        self._journal_fh = open(self._journal_path, "a", encoding="utf-8")
        if self._journal_fh.tell() == 0:
            # Spill-compatible header: load_jsonl / the offline audits
            # read this replica exactly like a primary journal file.
            self._journal_fh.write(json.dumps({"journal_meta": {
                "version": 1, "opened_at": time.time(),
                "replica_of": self.primary_url}}) + "\n")
            self._journal_fh.flush()

    def _close_replicas(self) -> None:
        for name in ("_wal_fh", "_journal_fh"):
            fh = getattr(self, name)
            if fh is not None:
                try:
                    fh.flush()
                    os.fsync(fh.fileno())
                    fh.close()
                except OSError:
                    pass
                setattr(self, name, None)

    # -- the heartbeat/sync loop -------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            failed = self._fault_round()
            handover = False
            if not failed:
                try:
                    resp = self._poll()
                    self._apply(resp)
                    self._last_ok = time.monotonic()
                    handover = bool(resp.get("handover")) and self.synced
                    if self._had_failure:
                        self._had_failure = False
                        self.router.journal.record(
                            "standby_sync", seq=self.applied,
                            lag=max(0, self.head - self.applied),
                            records=0, epoch=self.epoch_seen,
                            why="reconnect")
                except Exception as e:  # noqa: BLE001 — primary down is
                    self.last_error = str(e)  # the expected failure mode
                    self._had_failure = True
            if handover:
                # Catch up to the primary's head BEFORE taking over:
                # records past our last routine poll (quiesce-drain
                # tok/fin, any backlog beyond one batch) must be in the
                # replica, or a durably-ACKed admission could vanish at
                # takeover. A caught-up confirm poll — never a routine
                # one — releases the primary's SIGTERM wait.
                if self._handover_catchup():
                    if self.promote(why="handover"):
                        return
                # Catch-up failed (primary died mid-handover, or it
                # timed out waiting and fell back to draining): stay
                # standby — a dead primary still promotes below once
                # the grace expires.
            if time.monotonic() - self._last_ok > self.grace:
                if not self.synced:
                    # NEVER promote off an empty replica: a standby that
                    # has not synced once (booted before the primary,
                    # wrong --standby-of URL, partitioned) would fence a
                    # possibly-healthy primary out of its own fleet and
                    # serve nothing — an outage caused by HA itself.
                    self._alert_never_synced()
                elif self.promote(why="primary_dead"):
                    return
            if self._stop.wait(self.poll_s):
                return

    def _handover_catchup(self, timeout_s: float = 30.0) -> bool:
        """Drain the sync stream to the primary's head, then send a
        confirm poll (confirm=1) — only that releases the primary's
        SIGTERM wait, so it cannot exit before the replica holds
        everything it shipped. False = the primary died mid-handover
        or withdrew the offer (its wait timed out and it is draining
        instead): the caller must NOT promote off it."""
        deadline = time.monotonic() + timeout_s
        failures = 0
        confirmed = False  # a confirm poll the primary answered
        while not self._stop.is_set() and time.monotonic() < deadline:
            confirm = self.applied >= self.head
            try:
                resp = self._poll(confirm=confirm)
                self._apply(resp)
                self._last_ok = time.monotonic()
                failures = 0
            except Exception as e:  # noqa: BLE001
                self.last_error = str(e)
                self._had_failure = True
                if confirmed:
                    # The primary exits the moment an answered confirm
                    # lands; a dead socket past that point IS the
                    # planned exit — the replica already holds
                    # everything it shipped.
                    return True
                failures += 1
                if failures >= 3:
                    return False  # primary died before confirming
                time.sleep(min(0.2, self.poll_s))
                continue
            if not resp.get("handover"):
                return False  # withdrawn: the primary drains itself
            if confirm:
                confirmed = True
                if (not resp.get("records")
                        and resp.get("snapshot") is None):
                    # Confirmed at head with nothing new: the primary
                    # released on this very poll.
                    return True
            # Records still flowing (backlog or quiesce-drain tok/fin):
            # keep draining and re-confirm once caught up again.
        return False

    def _alert_never_synced(self) -> None:
        """Grace expired but no snapshot ever landed: alert + log
        (throttled), keep polling — promotion stays refused."""
        now = time.monotonic()
        if (self._never_synced_logged is None
                or now - self._never_synced_logged > max(5.0, self.grace)):
            self._never_synced_logged = now
            log.error(
                "primary %s unreachable for %.1fs but this standby has "
                "NEVER synced — refusing to promote an empty replica "
                "(wrong --standby-of URL, primary not up yet, or a "
                "partition); will keep polling",
                self.primary_url, now - self._last_ok)
        alerts = getattr(self.router, "alerts", None)
        if alerts is not None:
            alerts.fire(
                "standby_never_synced", "page",
                "takeover grace expired before the first successful "
                "sync: promotion refused (an unsynced standby would "
                "fence the primary and serve an empty fleet) — check "
                f"--standby-of {self.primary_url}", source="ha")

    def _fault_round(self) -> bool:
        """Draw the "router" fault site for this poll round. True = the
        round counts as failed (heartbeat not observed)."""
        plan = self.fault_plan
        if plan is None:
            return False
        failed = False
        for kind, rule in plan.draw("router"):
            failed = True
            if kind == "slow" and rule is not None:
                time.sleep(rule.delay_s)  # stalls the observed heartbeat
        if failed:
            self._had_failure = True
            self.last_error = "injected router fault"
        return failed

    def _poll(self, confirm: bool = False) -> dict:
        # snap=1 until the first snapshot lands: the initial catch-up
        # must be whole-file (compaction lines bypass the record
        # mirror), and asking explicitly lets an idle primary (head 0)
        # serve it once instead of re-shipping on every cold poll.
        # confirm=1 is the caught-up handover ack (_handover_catchup).
        url = f"{self.primary_url}/admin/ha/sync?seq={self.applied}"
        if not self.synced:
            url += "&snap=1"
        if confirm:
            url += "&confirm=1"
        req = urllib.request.Request(
            url, headers={"Accept": "application/json"})
        timeout = max(0.2, min(2.0, self.grace))
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read().decode("utf-8"))

    def _apply(self, resp: dict) -> None:
        self.epoch_seen = max(self.epoch_seen, int(resp.get("epoch") or 1))
        if resp.get("state"):
            self.state = resp["state"]
        self.head = max(int(resp.get("head") or 0), self.applied)
        if resp.get("snapshot") is not None:
            self._apply_snapshot(resp)
        else:
            self._apply_records(resp.get("records") or [])
        tm.HA_SYNC_LAG_RECORDS.set(max(0, self.head - self.applied))

    def _apply_snapshot(self, resp: dict) -> None:
        """Whole-file WAL catch-up: write-new-then-rename the replica so
        a crash mid-catch-up leaves the previous consistent replica."""
        lines = resp["snapshot"]
        tmp = self._wal_path + ".new"
        with open(tmp, "w", encoding="utf-8") as f:
            for ln in lines:
                f.write(ln + "\n")
            f.flush()
            os.fsync(f.fileno())
        if self._wal_fh is not None:
            try:
                self._wal_fh.close()
            except OSError:
                pass
        os.replace(tmp, self._wal_path)
        self._wal_fh = open(self._wal_path, "a", encoding="utf-8")
        self.applied = int(resp.get("snapshot_head") or 0)
        self.head = max(self.head, self.applied)
        self.synced = True
        alerts = getattr(self.router, "alerts", None)
        if alerts is not None:
            alerts.resolve("standby_never_synced")
        for _ in lines:
            tm.HA_SYNC_RECORDS_TOTAL.labels(kind="wal").inc()
        self.router.journal.record(
            "standby_sync", seq=self.applied,
            lag=max(0, self.head - self.applied), records=len(lines),
            epoch=self.epoch_seen, why="snapshot")

    def _apply_records(self, records: List[dict]) -> None:
        wrote_wal = wrote_journal = 0
        for r in records:
            seq = int(r["seq"])
            if seq <= self.applied:
                continue  # duplicate delivery after a half-applied poll
            if r["kind"] == "wal":
                self._wal_fh.write(json.dumps(r["rec"]) + "\n")
                wrote_wal += 1
            else:
                self._journal_fh.write(json.dumps(r["rec"]) + "\n")
                wrote_journal += 1
            tm.HA_SYNC_RECORDS_TOTAL.labels(kind=r["kind"]).inc()
            self.applied = seq
        # fsync per batch: promotion inherits the primary's durability
        # contract — an ACKed admit is on THIS disk too within one poll.
        if wrote_wal:
            self._wal_fh.flush()
            os.fsync(self._wal_fh.fileno())
        if wrote_journal:
            self._journal_fh.flush()
            os.fsync(self._journal_fh.fileno())

    # -- promotion ---------------------------------------------------------
    def promote(self, why: str) -> bool:
        """The takeover ladder: fence (epoch bump + member re-register)
        -> replay (recovery re-admits every unfinished replica stream)
        -> serve. Returns True once this process is the primary."""
        if self.promoted.is_set():
            return True
        r = self.router
        t0 = time.perf_counter()
        self.role = "promoting"
        self._promote_begin = time.monotonic()
        from_epoch = self.epoch_seen
        new_epoch = from_epoch + 1
        lag = max(0, self.head - self.applied)
        r.journal.record("router_takeover", phase="begin", why=why,
                         epoch=new_epoch, from_epoch=from_epoch, lag=lag)
        log.warning("PROMOTING to primary (why=%s epoch %d -> %d, sync "
                    "lag %d record(s))", why, from_epoch, new_epoch, lag)
        # Final fsync + close the replica files: the promoted router's
        # own DurabilityManager takes over wal.jsonl from here.
        self._close_replicas()
        # Persist the epoch BEFORE serving under it — a crash between
        # here and the first placement must not revive at the old epoch.
        save_ha_state(self.wal_dir, new_epoch, self.takeover_ms_ema)
        r.epoch = new_epoch
        for m in r.members:
            m.register(new_epoch)  # fences the zombie primary out
        # rid-space fence: reserve past every replica rid BEFORE opening
        # admissions, so neither recovery re-admits nor racing client
        # enqueues can collide with the dead primary's request ids.
        prev, _torn = load_wal_records(self._wal_path)
        if prev:
            reserve = getattr(r.core, "reserve_req_ids", None)
            if reserve is not None:
                reserve(max(prev) + 1)
        r.accepting = True
        try:
            # start() runs durability recovery: every unfinished replica
            # stream re-enters the queue and re-places across surviving
            # members (affinity lands it back on the member whose radix
            # tree still holds its prefix — the warm-pool fast path).
            r.start()
        except Exception:  # noqa: BLE001
            # The fence side effects are already out: members were
            # re-registered under new_epoch, which no router serves
            # until a promotion lands. Journal that fact, and adopt
            # new_epoch as seen so the RETRY claims a strictly higher
            # one (epoch monotonicity holds even across aborts).
            log.exception(
                "promotion ABORTED: router start failed; returning to "
                "standby. %d member(s) remain claimed at epoch %d (no "
                "router serves it — the old primary is fenced until a "
                "promotion lands or it re-registers above it)",
                len(r.members), new_epoch)
            r.journal.record("router_takeover", phase="aborted", why=why,
                             epoch=new_epoch, from_epoch=from_epoch,
                             members_claimed=len(r.members))
            alerts = getattr(r, "alerts", None)
            if alerts is not None:
                alerts.fire(
                    "takeover_aborted", "page",
                    f"promotion to epoch {new_epoch} aborted after "
                    f"members were claimed at it: no router serves that "
                    "epoch until a retry lands", source="ha")
            self.epoch_seen = new_epoch
            r.accepting = False
            self.role = "standby"
            self._last_ok = time.monotonic()
            self._open_replicas()
            return False
        streams = int(getattr(r.durability, "recovered_streams", 0) or 0)
        ms = (time.perf_counter() - t0) * 1e3
        self.takeover_ms_ema = (
            ms if self.takeover_ms_ema is None
            else 0.3 * ms + 0.7 * float(self.takeover_ms_ema))
        save_ha_state(self.wal_dir, new_epoch, self.takeover_ms_ema)
        # The promoted router is a full primary: its own coordinator
        # (reading the epoch just persisted) accepts the next standby.
        r.ha = HACoordinator(r)
        r.ha.on_router_start()
        self.role = "primary"
        self.takeover_count += 1
        alerts = getattr(r, "alerts", None)
        if alerts is not None:
            alerts.resolve("takeover_aborted")
        self.promoted.set()
        tm.HA_TAKEOVERS_TOTAL.labels(why=why).inc()
        tm.HA_TAKEOVER_DURATION_MS.observe(ms)
        # migrated=0 is honest: the dead primary's member connections
        # died with it, so there are no frozen pools to export — every
        # stream comes back through recompute-replay (affinity reuse of
        # the member's cached prefix is the de-facto migration).
        r.journal.record("router_takeover", phase="done", why=why,
                         epoch=new_epoch, from_epoch=from_epoch,
                         streams=streams, migrated=0, replayed=streams,
                         takeover_ms=round(ms, 3), lag=lag)
        log.warning("PROMOTED: epoch %d, %d stream(s) re-admitted in "
                    "%.0fms", new_epoch, streams, ms)
        return True

    def promote_eta_s(self) -> Optional[float]:
        """Expected seconds until this process serves — the Retry-After
        a shed client gets. Seeded from the takeover grace until a real
        takeover has been measured (the EMA persists across processes
        in ha_state.json, like the autoscaler's spawn-cost EMA)."""
        if self.role == "primary":
            return None
        expect = (float(self.takeover_ms_ema) / 1e3
                  if self.takeover_ms_ema else max(1.0, self.grace))
        if self.role == "promoting" and self._promote_begin is not None:
            return max(0.5, expect - (time.monotonic()
                                      - self._promote_begin))
        return max(0.5, expect)

    def status(self) -> dict:
        # The lag is unknown (None) until the first snapshot lands: a
        # standby that never synced is not caught up, whatever its
        # cursors read (the JAX package reports 0 there).
        s = {"role": self.role,
             "epoch": (self.router.epoch if self.role == "primary"
                       else self.epoch_seen),
             "sync_lag_records": (max(0, self.head - self.applied)
                                  if self.synced else None),
             "primary": self.primary_url,
             "synced": self.synced,
             "takeovers": self.takeover_count}
        if self.takeover_ms_ema is not None:
            s["takeover_ms_ema"] = round(float(self.takeover_ms_ema), 3)
        if self.role == "promoting" and self._promote_begin is not None:
            s["promote_elapsed_s"] = round(
                time.monotonic() - self._promote_begin, 3)
        if self.last_error:
            s["last_error"] = self.last_error
        return s
