"""Router HA of the port (ollamamq_tpu_torch/fleet/ha.py) against the
JAX package's, on the CPU: warm-standby replication over /admin/ha/sync,
epoch-fenced takeover, and zero-drop promotion.

The mirror of tests/test_router_ha.py (the same 20 tests under the same
names, over the port's FakeEngine, fleet router, stdlib server and CLI
subprocesses), then what the port adds:

  - the WAL snapshot edge over the port's two WAL locks, held against
    the JAX RequestWAL with the same test body;
  - the member-side fence under concurrent handler threads;
  - the sync wire across the packages: a port standby tails a JAX
    primary and a JAX standby tails a port primary, each promoting over
    one JAX member and one port member that both fence the zombie;
  - the kill -9 takeover over TorchEngine members on the CPU, whose
    resumed greedy ids equal an uninterrupted run's.

The contract under test: a standby tails the primary's WAL records and
journal decision events into shadow state; when the primary dies (or
hands over on SIGTERM) the standby bumps a monotonic epoch, re-registers
every member under it, re-admits the unfinished WAL streams through the
existing recovery path, and serves GET /api/stream/{rid}?from=N
byte-identical across the router swap — while members 409 every call
the revived zombie primary makes at its stale epoch (fenced, never
split-brained).
"""

import dataclasses
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from ollamamq_tpu.config import validate_ha as jax_validate_ha
from ollamamq_tpu.durability.wal import RequestWAL as JaxRequestWAL
from ollamamq_tpu.durability.wal import load_wal_records as jax_load_wal
from ollamamq_tpu_torch.config import EngineConfig, validate_ha
from ollamamq_tpu_torch.durability.wal import RequestWAL, load_wal_records
from ollamamq_tpu_torch.engine import health as health_mod
from ollamamq_tpu_torch.engine.fake import FakeEngine
from ollamamq_tpu_torch.engine.health import HealthMonitor
from ollamamq_tpu_torch.fleet import FleetRouter, LocalMember
from ollamamq_tpu_torch.fleet.ha import HAStandby, load_ha_state
from ollamamq_tpu_torch.fleet.members import HttpMember
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.app import OllamaServer, serve_in_thread, stop_server
from ollamamq_tpu_torch.telemetry.slo import AlertManager
from ollamamq_tpu_torch.testing.faults import FaultPlan
from ollamamq_tpu_torch.tools.journal import (check_epoch_monotonicity,
                                              check_files,
                                              check_takeover_pairing)
from testutil import collect, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The reference's TINY less prefill_buckets: the port's ragged step
# has no prefill buckets.
TINY = dict(model="test-tiny", max_slots=4, num_pages=64, page_size=8,
            max_pages_per_seq=8, decode_steps_per_iter=2)

FAST = dict(probe_period_s=0.05, eject_heartbeat_s=5.0,
            reprobe_backoff_s=0.1, evac_grace_s=1.0)


# ------------------------------------------------------- CLI fail-fast units
def test_validate_ha_fail_fast():
    """Every malformed --ha/--standby-of combination is rejected BEFORE
    any device work, with an error naming the offending flag."""
    # HA off entirely: nothing to validate.
    assert validate_ha(False, None, 3.0, None, None) is None
    # Valid shapes.
    assert validate_ha(True, None, 3.0, "/w", None) is None
    assert validate_ha(False, "http://p:1", 3.0, "/w", "http://m:2") is None
    # A process is the primary or the standby, never both.
    assert "mutually exclusive" in validate_ha(
        True, "http://p:1", 3.0, "/w", "http://m:2")
    assert "--takeover-grace-s" in validate_ha(True, None, 0.0, "/w", None)
    assert "--takeover-grace-s" in validate_ha(
        False, "http://p:1", -1.0, "/w", "http://m:2")
    # The replicated WAL is what a takeover recovers from.
    assert "--wal-dir" in validate_ha(True, None, 3.0, None, None)
    assert "--wal-dir" in validate_ha(
        False, "http://p:1", 3.0, None, "http://m:2")
    # The standby tails a URL and promotes over the SAME member fleet.
    assert "http(s)" in validate_ha(False, "ftp://p:1", 3.0, "/w", "u")
    assert "--replica-urls" in validate_ha(
        False, "http://p:1", 3.0, "/w", None)
    # Every message is the reference's, word for word.
    for case in [(True, "http://p:1", 3.0, "/w", "u"), (True, None, 0.0, "/w", None),
                 (True, None, 3.0, None, None), (False, "http://p:1", 3.0, None, "u"),
                 (False, "ftp://p:1", 3.0, "/w", "u"),
                 (False, "http://p:1", 3.0, "/w", None),
                 (False, None, 3.0, None, None), (True, None, 3.0, "/w", None)]:
        assert validate_ha(*case) == jax_validate_ha(*case)


def test_cli_rejects_bad_ha_args_exit_2(tmp_path):
    """`--ha --standby-of` together (and --ha without a WAL) kill the
    process with exit 2 at argument time — not at the first heartbeat."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    base = [sys.executable, "-m", "ollamamq_tpu_torch.cli", "--fake-engine",
            "--no-tui", "--models", "test-tiny",
            "--blocklist", str(tmp_path / "bl.json")]
    both = subprocess.run(
        base + ["--ha", "--standby-of", "http://127.0.0.1:1",
                "--wal-dir", str(tmp_path / "w")],
        env=env, capture_output=True, timeout=120)
    assert both.returncode == 2, both.stderr
    assert b"mutually exclusive" in both.stdout + both.stderr
    no_wal = subprocess.run(base + ["--ha"], env=env,
                            capture_output=True, timeout=120)
    assert no_wal.returncode == 2, no_wal.stderr
    assert b"--ha requires --wal-dir" in no_wal.stdout + no_wal.stderr
    # A primary without a fleet has no members for a standby to claim.
    no_fleet = subprocess.run(base + ["--ha", "--wal-dir", str(tmp_path / "w")],
                              env=env, capture_output=True, timeout=120)
    assert no_fleet.returncode == 2, no_fleet.stderr
    assert b"--ha needs a fleet" in no_fleet.stdout + no_fleet.stderr


# ------------------------------------------------------- journal audit units
def _tk(phase, seq, **kw):
    return dict(kind="router_takeover", phase=phase, seq=seq,
                why="primary_dead", **kw)


def test_takeover_pairing_audit():
    ok = [_tk("begin", 1), _tk("done", 2, epoch=2, from_epoch=1)]
    assert check_takeover_pairing(ok) == []
    # Aborted promotions resolve the pairing too.
    assert check_takeover_pairing(
        [_tk("begin", 1), _tk("aborted", 2)]) == []
    # A begin with no resolution = promotion crashed mid-ladder.
    bad = check_takeover_pairing([_tk("begin", 5)])
    assert len(bad) == 1 and "UNRESOLVED" in bad[0] and "seq 5" in bad[0]
    # Takeovers are serial: begin while another begin is open is a bug.
    twice = check_takeover_pairing([_tk("begin", 1), _tk("begin", 2),
                                    _tk("done", 3, epoch=2)])
    assert any("never resolved" in v for v in twice)
    # Ring tails: a done with no begin in the window is tolerated.
    assert check_takeover_pairing([_tk("done", 9, epoch=3)]) == []


def test_epoch_monotonicity_audit():
    clean = [
        _tk("done", 1, epoch=2, from_epoch=1),
        _tk("done", 2, epoch=3, from_epoch=2),
        dict(kind="epoch_fence", seq=3, epoch=3, stale_epoch=1,
             path="/api/generate", caller="placement"),
    ]
    assert check_epoch_monotonicity(clean) == []
    # A takeover that did not advance the epoch cannot fence anybody.
    bad = check_epoch_monotonicity([_tk("done", 1, epoch=1, from_epoch=1)])
    assert any("did not advance" in v for v in bad)
    # Successive takeovers must strictly increase.
    bad = check_epoch_monotonicity([_tk("done", 1, epoch=3, from_epoch=2),
                                    _tk("done", 2, epoch=3, from_epoch=2)])
    assert any("strictly monotonic" in v for v in bad)
    # A member may only fence STRICTLY older epochs.
    bad = check_epoch_monotonicity([
        dict(kind="epoch_fence", seq=1, epoch=2, stale_epoch=2,
             path="/api/generate", caller="placement")])
    assert any("strictly older" in v for v in bad)
    # A done without an epoch is unverifiable — flagged, not skipped.
    bad = check_epoch_monotonicity([_tk("done", 1)])
    assert any("no epoch" in v for v in bad)


def _spill(path, records, meta=None):
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps(
            {"journal_meta": dict({"version": 1}, **(meta or {}))}) + "\n")
        for r in records:
            f.write(json.dumps(r) + "\n")
    return str(path)


def test_check_files_cross_spill_duplicate_epoch(tmp_path):
    """The same epoch completed by TWO spills is split brain; the
    standby's primary-journal replica (journal_meta replica_of) is a
    byte copy and must NOT trip the duplicate check."""
    a = _spill(tmp_path / "a.jsonl",
               [_tk("begin", 1), _tk("done", 2, epoch=2, from_epoch=1)])
    b = _spill(tmp_path / "b.jsonl",
               [_tk("begin", 1), _tk("done", 2, epoch=2, from_epoch=1)])
    bad, _ = check_files([a, b])
    assert any("taken over TWICE" in v for v in bad)
    # Same duplicate in a replica spill: excluded by design.
    rep = _spill(tmp_path / "replica.jsonl",
                 [_tk("begin", 1), _tk("done", 2, epoch=2, from_epoch=1)],
                 meta={"replica_of": "http://primary:11434"})
    bad, _ = check_files([a, rep])
    assert not any("TWICE" in v for v in bad)
    # Distinct epochs across spills (a takeover chain): clean.
    c = _spill(tmp_path / "c.jsonl",
               [_tk("begin", 1), _tk("done", 2, epoch=3, from_epoch=2)])
    bad, _ = check_files([a, c])
    assert bad == []


# ------------------------------------------------------------- watchdog rules
class _HsEngine:
    """Health-monitor stub: just an alert table + an ha_status dict."""

    def __init__(self, hs):
        self.alerts = AlertManager()
        self._hs = hs

    def ha_status(self):
        return self._hs


def _names(am):
    return [a.name for a in am.active()]


def test_watchdog_standby_lag_fire_and_resolve(monkeypatch):
    monkeypatch.setattr(health_mod, "STANDBY_LAG_ALERT_RECORDS", 10)
    eng = _HsEngine({"role": "primary", "epoch": 1,
                     "sync_lag_records": 50, "standby_connected": True})
    mon = HealthMonitor(eng)
    mon._check_ha()
    assert "standby_lag" in _names(eng.alerts)
    # Catch-up resolves the alert.
    eng._hs = {"role": "primary", "epoch": 1, "sync_lag_records": 0,
               "standby_connected": True}
    mon._check_ha()
    assert "standby_lag" not in _names(eng.alerts)
    # A standby that stops polling fires even at lag 0.
    eng._hs = {"role": "primary", "epoch": 1, "sync_lag_records": 0,
               "standby_connected": False}
    mon._check_ha()
    assert "standby_lag" in _names(eng.alerts)
    # lag None = no standby has EVER polled: a config choice, no alert.
    eng2 = _HsEngine({"role": "primary", "epoch": 1,
                      "sync_lag_records": None})
    HealthMonitor(eng2)._check_ha()
    assert _names(eng2.alerts) == []


def test_watchdog_takeover_stuck_fire_and_resolve(monkeypatch):
    monkeypatch.setattr(health_mod, "TAKEOVER_STUCK_S", 1.0)
    eng = _HsEngine({"role": "promoting", "epoch": 2,
                     "sync_lag_records": 0, "promote_elapsed_s": 5.0})
    mon = HealthMonitor(eng)
    mon._check_ha()
    assert "takeover_stuck" in _names(eng.alerts)
    # Promotion lands → primary role → resolved.
    eng._hs = {"role": "primary", "epoch": 2, "sync_lag_records": None}
    mon._check_ha()
    assert "takeover_stuck" not in _names(eng.alerts)


# ------------------------------------------------- in-process primary side
def _ha_router(tmp_path, n=2):
    ecfg = EngineConfig(ha=True, wal_dir=str(tmp_path / "wal"),
                        wal_fsync_ms=2.0, **TINY)
    member_cfg = dataclasses.replace(ecfg, ha=False, wal_dir=None,
                                     max_queued=0, max_queued_per_user=0)
    members = [
        LocalMember(f"r{i}", FakeEngine(member_cfg, blocklist_path=None,
                                        token_latency_s=0.0))
        for i in range(n)
    ]
    router = FleetRouter(members, ecfg, blocklist_path=None, **FAST)
    router.start()
    return router


def test_coordinator_cold_snapshot_then_tail(tmp_path):
    """The replication stream's two regimes: a from-seq-0 poll ships a
    WAL snapshot (begin() compaction bypasses the mirror, so cold
    catch-up can never be record-by-record) plus the shadow placement
    state; subsequent polls tail sequence-numbered records, and the
    poll's seq doubles as the ack that drives the lag gauge."""
    router = _ha_router(tmp_path)
    try:
        ha = router.ha
        assert ha is not None and router.epoch == 1
        # Epoch persisted for crash-surviving fencing.
        assert load_ha_state(str(tmp_path / "wal"))["epoch"] == 1
        # Members registered under the epoch at start().
        assert all(m.router_epoch == 1 for m in router.members)

        req = router.enqueue_request(
            "u", "1.2.3.4", "test-tiny", prompt_tokens=[1, 2, 3],
            sampling=SamplingParams(max_tokens=4))
        items = collect(req)
        assert items[-1].kind == "done"

        resp = ha.sync_batch(0)
        assert resp["role"] == "primary" and resp["epoch"] == 1
        assert resp["records"] == []          # cold poll = snapshot
        snap = resp["snapshot"]
        assert any('"admit"' in ln or '"kind": "admit"' in ln
                   for ln in snap) or len(snap) >= 1
        names = [m["name"] for m in resp["state"]["members"]]
        assert names == ["r0", "r1"]
        head = resp["head"]
        assert resp["snapshot_head"] == head

        # Caught-up poll: no snapshot, no records, lag 0.
        resp2 = ha.sync_batch(head)
        assert "snapshot" not in resp2 and resp2["records"] == []
        st = ha.status()
        assert st["role"] == "primary" and st["sync_lag_records"] == 0
        assert st["standby_connected"]

        # New traffic tails as records, every seq above the ack.
        req2 = router.enqueue_request(
            "u", "1.2.3.4", "test-tiny", prompt_tokens=[4, 5],
            sampling=SamplingParams(max_tokens=3))
        collect(req2)
        resp3 = ha.sync_batch(head)
        kinds = {r["kind"] for r in resp3["records"]}
        assert resp3["records"] and kinds <= {"wal", "journal"}
        assert "wal" in kinds
        assert all(r["seq"] > head for r in resp3["records"])
        assert resp3["head"] >= max(r["seq"] for r in resp3["records"])
    finally:
        router.stop()


def test_standby_router_fault_site(tmp_path):
    """testing/faults.py "router" site drives the standby's poll loop:
    an injected fault marks the round failed (feeding the takeover
    grace clock) without touching the real primary."""
    ecfg = EngineConfig(wal_dir=str(tmp_path / "wal"), wal_fsync_ms=2.0,
                        **TINY)
    member_cfg = dataclasses.replace(ecfg, wal_dir=None)
    router = FleetRouter(
        [LocalMember("r0", FakeEngine(member_cfg, blocklist_path=None,
                                      token_latency_s=0.0))],
        ecfg, blocklist_path=None, **FAST)
    try:
        plan = FaultPlan([{"site": "router", "kind": "exception",
                           "at": [1]}], seed=3)
        sb = HAStandby(router, "http://127.0.0.1:1",
                       fault_plan=plan)
        assert sb._fault_round() is True          # injected: round fails
        assert sb.last_error == "injected router fault"
        assert sb._fault_round() is False         # one-shot rule spent
        # Pre-promotion ETA hint: at least the grace, never sub-second.
        eta = sb.promote_eta_s()
        assert eta is not None and eta >= 1.0
    finally:
        router.stop()


def _standby_router(tmp_path, grace=3.0):
    """Unstarted standby-side router + HAStandby pair (no sockets)."""
    ecfg = EngineConfig(wal_dir=str(tmp_path / "wal-s"), wal_fsync_ms=2.0,
                        takeover_grace_s=grace, **TINY)
    member_cfg = dataclasses.replace(ecfg, wal_dir=None)
    router = FleetRouter(
        [LocalMember("r0", FakeEngine(member_cfg, blocklist_path=None,
                                      token_latency_s=0.0))],
        ecfg, blocklist_path=None, **FAST)
    return router, HAStandby(router, "http://127.0.0.1:1")


def _alert_names(router):
    return [a.name for a in router.alerts.active()]


def test_sync_initial_snapshot_is_explicit_not_a_storm(tmp_path):
    """An idle primary (head 0 — e.g. freshly promoted, no traffic yet)
    must NOT re-ship + re-fsync the whole WAL replica on every cold
    poll: the standby asks for its one-time initial snapshot with
    snap=1, and plain from-seq-0 polls tail (empty) records."""
    router = _ha_router(tmp_path)
    try:
        ha = router.ha
        # Simulate the freshly-promoted idle case: nothing mirrored.
        with ha._lock:
            ha._ring.clear()
            ha.head = 0
        r1 = ha.sync_batch(0)
        assert "snapshot" not in r1 and r1["records"] == []
        # The explicit one-time request gets the whole file.
        r2 = ha.sync_batch(0, want_snapshot=True)
        assert r2.get("snapshot") is not None
        # Synced: back to (empty) record tailing, no re-snapshot.
        r3 = ha.sync_batch(r2["snapshot_head"])
        assert "snapshot" not in r3 and r3["records"] == []
        # With records past seq 0, a cold poll still snapshots (WAL
        # compaction lines bypass the mirror).
        req = router.enqueue_request(
            "u", "1.2.3.4", "test-tiny", prompt_tokens=[1, 2],
            sampling=SamplingParams(max_tokens=2))
        collect(req)
        r4 = ha.sync_batch(0)
        assert r4.get("snapshot") is not None
    finally:
        router.stop()


def test_handover_released_only_by_confirm_poll(tmp_path):
    """A routine poll at lag 0 must NOT release the primary's SIGTERM
    wait: at the instant SIGTERM lands, the standby's next routine poll
    already carries from_seq == head, and releasing on it would let the
    primary exit before the standby even learned of the handover. Only
    the explicit caught-up confirm poll releases."""
    router = _ha_router(tmp_path)
    try:
        ha = router.ha
        with ha._lock:
            ha.handover = True
            ha._handover_target = ha.head
            ha._handover_acked.clear()
        # Routine caught-up poll: advertises the handover, releases
        # nothing.
        resp = ha.sync_batch(ha.head)
        assert resp["handover"] is True
        assert not ha._handover_acked.is_set()
        # A confirm poll BELOW the target releases nothing either.
        if ha.head > 0:
            ha.sync_batch(ha.head - 1, confirm_handover=True)
            assert not ha._handover_acked.is_set()
        # The caught-up confirm poll is the release.
        ha.sync_batch(ha.head, confirm_handover=True)
        assert ha._handover_acked.is_set()
    finally:
        router.stop()


def test_handover_catchup_drains_backlog_before_promote(tmp_path):
    """The zero-drop handover contract: the standby applies EVERYTHING
    up to the primary's head — multi-batch backlog included — and only
    a caught-up poll carries confirm=1 (the ack that releases the
    primary's SIGTERM wait). A confirm poll's records are never
    discarded."""
    router, sb = _standby_router(tmp_path)
    try:
        sb._open_replicas()
        sb.synced = True

        def wal(seq):
            return {"seq": seq, "kind": "wal",
                    "rec": {"k": "admit", "rid": seq, "user": "u",
                            "model": "test-tiny", "kind": "generate",
                            "prompt": [1], "sampling": {}}}

        responses = [
            {"handover": True, "epoch": 1, "head": 4,
             "records": [wal(1), wal(2)], "state": {}},
            {"handover": True, "epoch": 1, "head": 4,
             "records": [wal(3), wal(4)], "state": {}},
        ]
        polls = []

        def poll(confirm=False):
            polls.append((sb.applied, confirm))
            if responses:
                return responses.pop(0)
            return {"handover": True, "epoch": 1, "head": 4,
                    "records": [], "state": {}}

        sb._poll = poll
        assert sb._handover_catchup() is True
        assert sb.applied == 4 and sb.head == 4
        # The releasing ack carried the full head AND the confirm flag;
        # the mid-backlog poll (applied 2 < head 4) confirmed nothing.
        assert polls[-1] == (4, True)
        assert (2, False) in polls
        # Both batches landed in the replica WAL (nothing discarded).
        prev, torn = load_wal_records(sb._wal_path)
        assert torn == 0 and sorted(prev) == [1, 2, 3, 4]
    finally:
        sb._close_replicas()
        router.stop()


def test_handover_withdrawn_or_dead_primary_aborts_catchup(tmp_path):
    """Catch-up must NOT confirm a handover the primary withdrew (its
    wait timed out; it is draining itself — promoting would fence a
    live, draining router), nor spin forever against a dead one."""
    router, sb = _standby_router(tmp_path)
    try:
        sb._open_replicas()
        sb.synced = True
        sb._poll = lambda confirm=False: {
            "handover": False, "epoch": 1, "head": 0,
            "records": [], "state": {}}
        assert sb._handover_catchup() is False

        def boom(confirm=False):
            raise OSError("connection refused")

        sb._poll = boom
        assert sb._handover_catchup() is False
        assert sb.role == "standby" and not sb.promoted.is_set()
    finally:
        sb._close_replicas()
        router.stop()


def test_never_synced_standby_refuses_promotion(tmp_path):
    """A standby that has NEVER completed a first sync (booted before
    the primary, wrong URL, partitioned) must not promote after the
    grace: it would fence a possibly-healthy primary out of its own
    fleet and serve an empty replica. It alerts and keeps polling."""
    router, sb = _standby_router(tmp_path, grace=0.3)
    try:
        sb.start()  # primary URL is unreachable: every poll fails
        time.sleep(1.2)  # several grace windows elapse
        assert sb.role == "standby" and not sb.promoted.is_set()
        assert not sb.synced
        assert "standby_never_synced" in _alert_names(router)
        assert not [r for r in router.journal.tail(None)
                    if r.get("kind") == "router_takeover"]
        sb.stop()
        # The first snapshot resolves the alert (and arms promotion).
        sb._apply_snapshot({"snapshot": [], "snapshot_head": 0})
        assert sb.synced
        assert "standby_never_synced" not in _alert_names(router)
    finally:
        sb.stop()
        router.stop()


def test_aborted_promotion_bumps_epoch_and_retries_clean(tmp_path):
    """An aborted promotion already re-registered the members at the
    new epoch: the abort journals that fact (+ alert), and the RETRY
    claims a strictly higher epoch over an idempotently-restartable
    router — monotonicity holds across the abort."""
    router, sb = _standby_router(tmp_path)
    try:
        sb._open_replicas()
        sb.synced = True
        real_start = router.start
        calls = {"n": 0}

        def flaky_start():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("recovery wedged")
            real_start()

        router.start = flaky_start
        assert sb.promote(why="primary_dead") is False
        assert sb.role == "standby" and not sb.promoted.is_set()
        assert sb.epoch_seen == 2  # claimed-but-unserved epoch adopted
        assert not router.accepting
        assert "takeover_aborted" in _alert_names(router)
        aborted = [r for r in router.journal.tail(None)
                   if r.get("kind") == "router_takeover"
                   and r.get("phase") == "aborted"]
        assert aborted and aborted[-1]["members_claimed"] == 1
        assert aborted[-1]["epoch"] == 2

        assert sb.promote(why="primary_dead") is True
        assert sb.role == "primary" and router.epoch == 3
        assert "takeover_aborted" not in _alert_names(router)
        recs = [r for r in router.journal.tail(None)
                if r.get("kind") == "router_takeover"]
        assert check_takeover_pairing(recs) == []
        assert check_epoch_monotonicity(recs) == []
        assert [r for r in recs if r.get("phase") == "done"][-1][
            "epoch"] == 3
    finally:
        router.stop()


def test_router_start_partial_failure_is_retryable(tmp_path):
    """A start() that raises partway (e.g. recovery wedged) must leave
    the router restartable — the HA promotion retry path depends on
    it — without double-starting members."""
    ecfg = EngineConfig(wal_dir=str(tmp_path / "wal"), wal_fsync_ms=2.0,
                        **TINY)
    member_cfg = dataclasses.replace(ecfg, wal_dir=None)
    router = FleetRouter(
        [LocalMember("r0", FakeEngine(member_cfg, blocklist_path=None,
                                      token_latency_s=0.0))],
        ecfg, blocklist_path=None, **FAST)
    real_dur_start = router.durability.start
    calls = {"n": 0}

    def flaky(engine):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("boom")
        real_dur_start(engine)

    router.durability.start = flaky
    try:
        with pytest.raises(RuntimeError):
            router.start()
        assert router._running is False
        router.start()  # retry actually re-runs the ladder
        assert router._running is True and calls["n"] == 2
        req = router.enqueue_request(
            "u", "1.2.3.4", "test-tiny", prompt_tokens=[1],
            sampling=SamplingParams(max_tokens=2))
        assert collect(req)[-1].kind == "done"
    finally:
        router.stop()


def _member_server(engine):
    """The port's stdlib server over `engine` (the fence state lives on
    the server object every handler thread shares), its socket closed at
    once: the reference's Server(engine)."""
    srv = OllamaServer(engine, "127.0.0.1", 0)
    srv.server_close()
    return srv


def test_member_epoch_persists_across_restart(tmp_path):
    """The member-side fence must survive a member restart: with a WAL
    dir the adopted epoch persists (member_epoch.json), so a fresh
    process revives AT the fence instead of at 0 — where the zombie
    ex-primary's retried calls would pass again."""
    ecfg = EngineConfig(wal_dir=str(tmp_path / "mw"), **TINY)
    eng = FakeEngine(ecfg, blocklist_path=None, token_latency_s=0.0)
    srv = _member_server(eng)
    assert srv._ha_epoch == 0
    srv._adopt_epoch(3)
    assert json.load(open(os.path.join(
        str(tmp_path / "mw"), "member_epoch.json")))["epoch"] == 3
    # "Restart": a fresh Server over the same state dir holds the fence.
    srv2 = _member_server(eng)
    assert srv2._ha_epoch == 3
    # WAL-less member: memory-only, as before (heartbeat repair covers
    # it — see test_http_member_heartbeat_repairs_regressed_epoch).
    eng2 = FakeEngine(dataclasses.replace(ecfg, wal_dir=None),
                      blocklist_path=None, token_latency_s=0.0)
    srv3 = _member_server(eng2)
    srv3._adopt_epoch(5)
    assert _member_server(eng2)._ha_epoch == 0


def test_http_member_heartbeat_repairs_regressed_epoch():
    """The router heartbeat re-registers a member whose /health reports
    an epoch below the fleet's (a restarted WAL-less member) — closing
    the window where the zombie's calls would pass its reset fence."""
    m = HttpMember("m0", "http://127.0.0.1:1")
    calls = []
    m.register = lambda e: calls.append(e) or True
    m._status = {"status": "ok"}  # no epoch reported
    m._repair_epoch()
    assert calls == []            # HA off: nothing to repair
    m.router_epoch = 2
    m._repair_epoch()
    assert calls == [2]           # regressed (0 < 2): re-register
    m._status = {"status": "ok", "epoch": 2}
    m._repair_epoch()
    assert calls == [2]           # caught up: no churn
    m._status = {"status": "ok", "epoch": 3}
    m._repair_epoch()
    assert calls == [2]           # a newer router owns it: leave it
    m._status = {"status": "ok", "epoch": 0}
    m.fenced = True
    m._repair_epoch()
    assert calls == [2]           # fenced members are not ours to claim


# ---------------------------------------------------- subprocess e2e helpers
def _spawn(tmp_path, argv, log_name, package="ollamamq_tpu_torch",
           fake=True):
    """The CLI of `package` (the port's unless asked) in a subprocess."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["FAKE_TOKEN_LATENCY_S"] = "0.05"
    # One compute thread per process: these tests run beside other test
    # files' processes, and test-tiny needs no more.
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    logf = open(str(tmp_path / log_name), "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{package}.cli",
         *(["--fake-engine"] if fake else []),
         "--no-tui", "--models", "test-tiny",
         "--blocklist", str(tmp_path / "bl.json"), *argv],
        stdout=logf, stderr=subprocess.STDOUT, env=env)
    proc._logf = logf
    return proc


def _health(port, timeout=2.0):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                timeout=timeout) as r:
        return json.loads(r.read())


def _wait_health(port, budget=90.0, ok=None):
    if ok is None:
        ok = lambda b: b.get("status") != "recovering"  # noqa: E731
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        try:
            body = _health(port)
            if ok(body):
                return body
        except Exception:  # noqa: BLE001
            pass
        time.sleep(0.1)
    raise TimeoutError(f"server :{port} never reached the wanted state")


def _read_ndjson(resp):
    rid, text, ids, done = None, "", [], None
    for raw in resp:
        obj = json.loads(raw)
        if obj.get("req_id") is not None:
            rid = int(obj["req_id"])
        ids.extend(int(t) for t in obj.get("token_ids") or ())
        text += obj.get("response", "")
        if obj.get("done"):
            done = obj.get("done_reason")
            break
    return rid, text, ids, done


def _gen_request(port, num_predict, user="ha"):
    body = json.dumps({"model": "test-tiny", "prompt": "x",
                       "stream": True,
                       "options": {"num_predict": num_predict}}).encode()
    return urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port}/api/generate", data=body,
        headers={"Content-Type": "application/json", "X-User-ID": user}),
        timeout=120)


def _fenced_total(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        text = r.read().decode()
    total = 0.0
    for line in text.splitlines():
        if line.startswith("ollamamq_ha_fenced_calls_total") \
                and " " in line:
            total += float(line.rsplit(" ", 1)[1])
    return total


# --------------------------------------------------------- subprocess e2e
def test_ha_kill9_promotion_and_zombie_fence_e2e(tmp_path):
    """THE headline e2e over real sockets: cold standby catch-up, the
    standby shedding (503 + Retry-After) while the primary serves,
    kill -9 of the primary mid-decode, promotion with a byte- AND
    token-identical resumed stream, and the revived zombie primary
    fenced by the members (zero stale-epoch placements accepted)."""
    ports = {k: free_port() for k in ("a", "b", "primary", "standby")}
    urls = (f"http://127.0.0.1:{ports['a']},"
            f"http://127.0.0.1:{ports['b']}")
    wal_p, wal_s = str(tmp_path / "wal-p"), str(tmp_path / "wal-s")
    procs = [
        _spawn(tmp_path, ["--port", str(ports["a"]), "--journal-file",
                          str(tmp_path / "ma.jsonl")], "ma.log"),
        _spawn(tmp_path, ["--port", str(ports["b"]), "--journal-file",
                          str(tmp_path / "mb.jsonl")], "mb.log"),
    ]

    def primary_argv(tag=""):
        return ["--port", str(ports["primary"]), "--replicas", "0",
                "--replica-urls", urls, "--ha",
                "--takeover-grace-s", "1.0", "--wal-dir", wal_p,
                "--wal-fsync-ms", "2", "--journal-file",
                str(tmp_path / f"primary{tag}.jsonl")]

    try:
        _wait_health(ports["a"])
        _wait_health(ports["b"])
        procs.append(_spawn(tmp_path, primary_argv(), "primary.log"))
        _wait_health(ports["primary"])

        # WAL has real traffic BEFORE the standby exists: catch-up must
        # go through the snapshot path, not record tailing.
        _rid, text0, ids0, done0 = _read_ndjson(
            _gen_request(ports["primary"], 6))
        assert done0 == "length" and len(ids0) == 6

        procs.append(_spawn(
            tmp_path,
            ["--port", str(ports["standby"]), "--replicas", "0",
             "--replica-urls", urls,
             "--standby-of", f"http://127.0.0.1:{ports['primary']}",
             "--takeover-grace-s", "1.0", "--wal-dir", wal_s,
             "--wal-fsync-ms", "2", "--journal-file",
             str(tmp_path / "standby.jsonl")], "standby.log"))
        standby = procs[-1]
        sb = _wait_health(
            ports["standby"],
            ok=lambda b: b.get("role") == "standby"
            and b.get("sync_lag_records") == 0)
        assert sb["status"] == "standby" and sb["epoch"] == 1
        # The snapshot really landed: the WAL replica holds the
        # pre-standby stream, finished.
        entries, _ = load_wal_records(os.path.join(wal_s, "wal.jsonl"))
        assert entries and all(e["finished"] is not None
                               for e in entries.values())
        # Primary-side view of the same link (the ack for a snapshot
        # rides the standby's NEXT poll, so converge rather than race).
        ph = _wait_health(ports["primary"], budget=30.0,
                          ok=lambda b: b.get("role") == "primary"
                          and b.get("sync_lag_records") == 0)
        assert ph["epoch"] == 1

        # A standby never serves: explicit shed with a takeover ETA.
        with pytest.raises(urllib.error.HTTPError) as e:
            _gen_request(ports["standby"], 2)
        assert e.value.code in (429, 503)
        assert e.value.headers.get("Retry-After") is not None

        # Mid-decode kill -9 of the primary.
        resp = _gen_request(ports["primary"], 12)
        rid, text, ids = None, "", []
        for raw in resp:
            obj = json.loads(raw)
            rid = obj.get("req_id", rid)
            ids.extend(int(t) for t in obj.get("token_ids") or ())
            text += obj.get("response", "")
            if len(ids) >= 5:
                break
        primary = procs[2]
        primary.kill()
        primary.wait(timeout=30)
        try:
            resp.close()
        except Exception:  # noqa: BLE001
            pass

        sb = _wait_health(
            ports["standby"], budget=60.0,
            ok=lambda b: b.get("role") == "primary"
            and b.get("status") != "recovering")
        assert sb["epoch"] == 2
        # Resume against the PROMOTED STANDBY: byte- and token-exact.
        _r, rtext, rids, done = _read_ndjson(urllib.request.urlopen(
            f"http://127.0.0.1:{ports['standby']}"
            f"/api/stream/{rid}?from={len(ids)}", timeout=120))
        assert done == "length"
        assert text + rtext == "".join(f"word{i} " for i in range(12))
        assert ids + rids == list(range(1, 13))

        # Revive the zombie on its old WAL dir: register + recovery
        # placements all carry the stale epoch — fenced, bounded (the
        # fence is terminal member-side, not a failover retry).
        procs.append(_spawn(tmp_path, primary_argv("-zombie"),
                            "zombie.log"))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if _fenced_total(ports["a"]) + _fenced_total(ports["b"]) >= 1:
                break
            time.sleep(0.2)
        fenced = _fenced_total(ports["a"]) + _fenced_total(ports["b"])
        assert fenced >= 1, "members never fenced the zombie"
        # The promoted router still owns the fleet.
        _r, ptext, pids, pdone = _read_ndjson(
            _gen_request(ports["standby"], 4))
        assert pdone == "length" and len(pids) == 4

        # Takeover pairing + epoch audit across the run's spills (the
        # zombie's spill is not part of the surviving run).
        standby.send_signal(signal.SIGTERM)
        standby.wait(timeout=60)
        spills = [p for p in
                  (str(tmp_path / "primary.jsonl"),
                   str(tmp_path / "standby.jsonl"),
                   os.path.join(wal_s, "primary-journal.jsonl"),
                   str(tmp_path / "ma.jsonl"),
                   str(tmp_path / "mb.jsonl"))
                  if os.path.exists(p)]
        assert len(spills) >= 4
        bad, total = check_files(spills)
        assert bad == [] and total > 0
        # The done record carries the measured promotion cost.
        with open(str(tmp_path / "standby.jsonl")) as f:
            recs = [json.loads(ln) for ln in f if '"kind"' in ln]
        done_recs = [r for r in recs if r.get("kind") == "router_takeover"
                     and r.get("phase") == "done"]
        assert done_recs and done_recs[-1]["epoch"] == 2
        assert done_recs[-1]["why"] == "primary_dead"
        assert done_recs[-1].get("takeover_ms") is not None
    finally:
        for p in procs:
            try:
                p.kill()
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001
                pass
            p._logf.close()


def test_ha_sigterm_handover_e2e(tmp_path):
    """Graceful SIGTERM on an HA primary HANDS OVER instead of
    draining: the primary waits for the standby's ack at its head seq,
    exits 0, and the standby promotes with why="handover" — zero
    client-visible downtime beyond the promotion window."""
    ports = {k: free_port() for k in ("a", "primary", "standby")}
    url = f"http://127.0.0.1:{ports['a']}"
    procs = [
        _spawn(tmp_path, ["--port", str(ports["a"]), "--journal-file",
                          str(tmp_path / "ma.jsonl")], "ma.log"),
    ]
    try:
        _wait_health(ports["a"])
        primary = _spawn(
            tmp_path,
            ["--port", str(ports["primary"]), "--replicas", "0",
             "--replica-urls", url, "--ha", "--takeover-grace-s", "1.0",
             "--wal-dir", str(tmp_path / "wal-p"), "--wal-fsync-ms", "2",
             "--journal-file", str(tmp_path / "primary.jsonl")],
            "primary.log")
        procs.append(primary)
        _wait_health(ports["primary"])
        procs.append(_spawn(
            tmp_path,
            ["--port", str(ports["standby"]), "--replicas", "0",
             "--replica-urls", url,
             "--standby-of", f"http://127.0.0.1:{ports['primary']}",
             "--takeover-grace-s", "1.0",
             "--wal-dir", str(tmp_path / "wal-s"), "--wal-fsync-ms", "2",
             "--journal-file", str(tmp_path / "standby.jsonl")],
            "standby.log"))
        _wait_health(ports["standby"],
                     ok=lambda b: b.get("role") == "standby"
                     and b.get("sync_lag_records") == 0)

        primary.send_signal(signal.SIGTERM)
        assert primary.wait(timeout=60) == 0
        _wait_health(ports["standby"], budget=60.0,
                     ok=lambda b: b.get("role") == "primary"
                     and b.get("status") != "recovering")

        # The handover is journaled as a takeover with why="handover".
        deadline = time.monotonic() + 30
        why = None
        while time.monotonic() < deadline and why != "handover":
            with open(str(tmp_path / "standby.jsonl")) as f:
                for ln in f:
                    if '"router_takeover"' in ln:
                        r = json.loads(ln)
                        if r.get("phase") == "done":
                            why = r.get("why")
            time.sleep(0.2)
        assert why == "handover"
        # The promoted router serves.
        _r, text, ids, done = _read_ndjson(
            _gen_request(ports["standby"], 5))
        assert done == "length" and len(ids) == 5
        assert text == "".join(f"word{i} " for i in range(5))
    finally:
        for p in procs:
            try:
                p.kill()
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001
                pass
            p._logf.close()


# ------------------------------------------- beyond the mirror: the port
def _edge_admit(rid):
    return {"k": "admit", "rid": rid, "user": "u", "model": "test-tiny",
            "kind": "generate", "prompt": [1], "sampling": {}}


@pytest.mark.parametrize("package", ["port", "jax"])
def test_wal_snapshot_edge_is_exact_under_appenders(tmp_path, package):
    """The snapshot's mark is its exact edge while appender threads run:
    a mirror numbers every record as the WAL buffers it, and for each
    snapshot every record numbered at or below the mark is in the lines
    (in order, nothing else), none past it is, and the lines plus the
    mirrored records past the mark rebuild the final file's state. The
    port splits its WAL over two locks (the disk write outside the
    buffer lock); the JAX RequestWAL, one lock, passes the same body."""
    wal_cls, load = ((RequestWAL, load_wal_records) if package == "port"
                     else (JaxRequestWAL, jax_load_wal))
    wal = wal_cls(str(tmp_path / "w"), fsync_ms=1.0)
    wal.begin()
    seq_lock = threading.Lock()
    mirrored = []  # the record lines in mirror order: seq = index + 1

    def mirror(rec):
        with seq_lock:
            mirrored.append(json.dumps(rec))

    wal.mirror = mirror
    for rid in (1, 2, 3):
        wal.admit(_edge_admit(rid))
    counter = iter(range(10 ** 9))
    counter_lock = threading.Lock()

    def tid():
        with counter_lock:
            return next(counter)

    def tokens(rid):
        for _ in range(1500):
            n = tid()
            wal.append_tokens(rid, [[n, f"t{n}"]])

    def admissions():
        for rid in range(100, 220):
            wal.admit(_edge_admit(rid))
            wal.append_tokens(rid, [[tid(), "x"]])
            wal.finish(rid, "stop")

    threads = ([threading.Thread(target=tokens, args=(r,)) for r in (1, 2, 3)]
               + [threading.Thread(target=admissions)])
    for t in threads:
        t.start()
    snaps = []
    rng = random.Random(7)
    while any(t.is_alive() for t in threads) or len(snaps) < 5:
        marker = {}

        def mark():
            with seq_lock:
                marker["head"] = len(mirrored)

        snaps.append((wal.snapshot_lines(mark=mark), marker["head"]))
        time.sleep(rng.uniform(0.0, 0.002))
    for t in threads:
        t.join()
    wal.close()
    final = load(wal.path)
    assert final[1] == 0 and len(final[0]) == 3 + 120
    moved = 0
    for i, (lines, head) in enumerate(snaps):
        upto, past = mirrored[:head], mirrored[head:]
        assert lines == upto, (
            f"snapshot {i}: mark {head}, {len(lines)} lines; first diff at "
            f"{next((k for k, (a, b) in enumerate(zip(lines, upto)) if a != b), min(len(lines), len(upto)))}")
        replay = tmp_path / f"replay-{i}.jsonl"
        replay.write_text("".join(ln + "\n" for ln in lines + past))
        assert load(str(replay)) == final
        moved += 0 < head < len(mirrored)
    assert moved >= 3  # snapshots landed while records were still coming


def test_member_fence_holds_under_concurrent_handler_threads(tmp_path,
                                                             monkeypatch):
    """Concurrent /admin/ha/register and X-Router-Epoch placements at
    mixed epochs against one port member: the adopted epoch ends at the
    maximum, member_epoch.json holds it and was never written lower than
    before (a slow persist of an older epoch never overwrites a newer
    one), and no call below the epoch adopted before it was sent got a
    2xx."""
    eng = FakeEngine(EngineConfig(wal_dir=str(tmp_path / "mw"), **TINY),
                     blocklist_path=None, token_latency_s=0.0)
    srv = serve_in_thread(eng, port=0)
    port = srv.server_address[1]
    epoch_file = str(tmp_path / "mw" / "member_epoch.json")
    persisted = []
    real_fsync, real_replace = os.fsync, os.replace

    def slow_fsync(fd):
        time.sleep(0.002)  # widen the persist window
        real_fsync(fd)

    def recording_replace(src, dst):
        real_replace(src, dst)
        if str(dst) == epoch_file:
            with open(epoch_file) as f:
                persisted.append(json.load(f)["epoch"])

    monkeypatch.setattr(os, "fsync", slow_fsync)
    monkeypatch.setattr(os, "replace", recording_replace)
    rng = random.Random(11)
    plan = [(rng.choice(("register", "placement")), rng.randint(1, 12))
            for _ in range(150)]
    plan.append(("register", 13))
    results, lock = [], threading.Lock()

    def call(kind, epoch):
        before = srv.ha_epoch
        if kind == "register":
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/admin/ha/register",
                data=json.dumps({"epoch": epoch}).encode())
        else:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/api/generate",
                data=json.dumps({"model": "test-tiny", "prompt": "x",
                                 "stream": False,
                                 "options": {"num_predict": 1}}).encode(),
                headers={"X-Router-Epoch": str(epoch)})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                code = r.status
        except urllib.error.HTTPError as e:
            code = e.code
        with lock:
            results.append((kind, epoch, before, code))

    def worker(items):
        for kind, epoch in items:
            call(kind, epoch)

    try:
        chunks = [plan[i::8] for i in range(8)]
        threads = [threading.Thread(target=worker, args=(c,)) for c in chunks]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=10).read())
    finally:
        stop_server(srv)
    assert len(results) == len(plan)
    assert {code for *_, code in results} <= {200, 409}
    assert srv.ha_epoch == 13 and health["epoch"] == 13
    with open(epoch_file) as f:
        assert json.load(f)["epoch"] == 13
    assert persisted and persisted == sorted(persisted)
    assert persisted[-1] == 13
    leaked = [r for r in results if r[1] < r[2] and 200 <= r[3] < 300]
    assert leaked == []
    assert any(code == 409 for *_, code in results)
    fences = [r for r in eng.journal.tail(None) if r.get("kind") == "epoch_fence"]
    assert len(fences) == sum(1 for *_, code in results if code == 409)
    assert all(r["stale_epoch"] < r["epoch"] for r in fences)


# --------------------------------------------------- across the packages
def _metric_total(port, name):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        text = r.read().decode()
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith(name) and " " in ln)


def _wait_file(path, ok, budget=60.0):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        if ok(path):
            return
        time.sleep(0.1)
    raise TimeoutError(f"{path} never reached the wanted state")


def _stop_all(procs):
    for p in procs:
        try:
            p.kill()
            p.wait(timeout=10)
        except Exception:  # noqa: BLE001
            pass
        p._logf.close()


@pytest.mark.parametrize("primary_pkg,standby_pkg", [
    ("ollamamq_tpu", "ollamamq_tpu_torch"),
    ("ollamamq_tpu_torch", "ollamamq_tpu"),
], ids=["port-standby-of-jax-primary", "jax-standby-of-port-primary"])
def test_ha_sync_wire_across_packages(tmp_path, primary_pkg, standby_pkg):
    """The sync wire is the parity contract (a mixed fleet upgrades one
    router at a time): a standby of one package tails the other's
    primary — the snapshot, then its records — and after a kill -9 of
    the primary promotes to epoch 2 and resumes the stream byte- and
    token-identical; one JAX member and one port member both fence the
    revived zombie."""
    ports = {k: free_port() for k in ("a", "b", "primary", "standby")}
    urls = (f"http://127.0.0.1:{ports['a']},"
            f"http://127.0.0.1:{ports['b']}")
    wal_p, wal_s = str(tmp_path / "wal-p"), str(tmp_path / "wal-s")
    procs = [
        _spawn(tmp_path, ["--port", str(ports["a"])], "ma.log",
               package="ollamamq_tpu"),
        _spawn(tmp_path, ["--port", str(ports["b"])], "mb.log"),
    ]

    def primary_argv(tag=""):
        return ["--port", str(ports["primary"]), "--replicas", "0",
                "--replica-urls", urls, "--ha", "--takeover-grace-s", "1.0",
                "--wal-dir", wal_p, "--wal-fsync-ms", "2", "--journal-file",
                str(tmp_path / f"primary{tag}.jsonl")]

    try:
        _wait_health(ports["a"])
        _wait_health(ports["b"])
        procs.append(_spawn(tmp_path, primary_argv(), "primary.log",
                            package=primary_pkg))
        _wait_health(ports["primary"])
        _r, _t, ids0, done0 = _read_ndjson(_gen_request(ports["primary"], 6))
        assert done0 == "length" and len(ids0) == 6

        procs.append(_spawn(
            tmp_path,
            ["--port", str(ports["standby"]), "--replicas", "0",
             "--replica-urls", urls,
             "--standby-of", f"http://127.0.0.1:{ports['primary']}",
             "--takeover-grace-s", "1.0", "--wal-dir", wal_s,
             "--wal-fsync-ms", "2", "--journal-file",
             str(tmp_path / "standby.jsonl")], "standby.log",
            package=standby_pkg))
        standby = procs[-1]
        # The cold catch-up is the primary's snapshot: the replica holds
        # the finished pre-standby stream.
        replica = os.path.join(wal_s, "wal.jsonl")
        _wait_file(replica, lambda p: any(
            e["finished"] == "length" for e in load_wal_records(p)[0].values()))
        sb = _wait_health(ports["standby"],
                          ok=lambda b: b.get("role") == "standby"
                          and b.get("sync_lag_records") == 0)
        assert sb["status"] == "standby" and sb["epoch"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            _gen_request(ports["standby"], 2)
        assert e.value.code in (429, 503)
        assert e.value.headers.get("Retry-After") is not None

        resp = _gen_request(ports["primary"], 12)
        rid, text, ids = None, "", []
        for raw in resp:
            obj = json.loads(raw)
            rid = obj.get("req_id", rid)
            ids.extend(int(t) for t in obj.get("token_ids") or ())
            text += obj.get("response", "")
            if len(ids) >= 5:
                break
        # Then its records: the admission of the live stream reached the
        # replica through the record tail, not a second snapshot.
        _wait_file(replica, lambda p: rid in load_wal_records(p)[0])
        primary = procs[2]
        primary.kill()
        primary.wait(timeout=30)
        try:
            resp.close()
        except Exception:  # noqa: BLE001
            pass
        sb = _wait_health(ports["standby"], budget=60.0,
                          ok=lambda b: b.get("role") == "primary"
                          and b.get("status") != "recovering")
        assert sb["epoch"] == 2
        _r, rtext, rids, done = _read_ndjson(urllib.request.urlopen(
            f"http://127.0.0.1:{ports['standby']}"
            f"/api/stream/{rid}?from={len(ids)}", timeout=120))
        assert done == "length"
        assert text + rtext == "".join(f"word{i} " for i in range(12))
        assert ids + rids == list(range(1, 13))
        with open(str(tmp_path / "standby.jsonl")) as f:
            syncs = [json.loads(ln) for ln in f if '"standby_sync"' in ln]
        assert any(r.get("why") == "snapshot" for r in syncs)

        procs.append(_spawn(tmp_path, primary_argv("-zombie"), "zombie.log",
                            package=primary_pkg))
        name = "ollamamq_ha_fenced_calls_total"
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if min(_metric_total(ports[m], name) for m in ("a", "b")) >= 1:
                break
            time.sleep(0.2)
        assert _metric_total(ports["a"], name) >= 1, "the JAX member let it in"
        assert _metric_total(ports["b"], name) >= 1, "the port member let it in"
        _r, _t, pids, pdone = _read_ndjson(_gen_request(ports["standby"], 4))
        assert pdone == "length" and len(pids) == 4

        standby.send_signal(signal.SIGTERM)
        assert standby.wait(timeout=60) == 0
        spills = [str(tmp_path / "primary.jsonl"),
                  str(tmp_path / "standby.jsonl"),
                  os.path.join(wal_s, "primary-journal.jsonl")]
        bad, total = check_files([p for p in spills if os.path.exists(p)])
        assert bad == [] and total > 0
        with open(str(tmp_path / "standby.jsonl")) as f:
            done_recs = [json.loads(ln) for ln in f
                         if '"router_takeover"' in ln and '"done"' in ln]
        assert done_recs and done_recs[-1]["epoch"] == 2
        assert done_recs[-1]["why"] == "primary_dead"
    finally:
        _stop_all(procs)


# ------------------------------------------------------ a real engine
def test_ha_kill9_over_torch_engine_members_resumes_greedy_ids(tmp_path):
    """The kill -9 takeover once more with TorchEngine members on the CPU
    (test-tiny, float32): the promoted standby replays the stream's
    prompt and emitted ids on a member, and the resumed greedy ids equal
    an uninterrupted run of the same prompt on the same members."""
    ports = {k: free_port() for k in ("a", "b", "primary", "standby")}
    urls = (f"http://127.0.0.1:{ports['a']},"
            f"http://127.0.0.1:{ports['b']}")
    engine_args = ["--device", "cpu", "--dtype", "float32", "--max-slots", "4",
                   "--num-pages", "64", "--page-size", "16",
                   "--max-pages-per-seq", "16", "--max-new-tokens", "200"]
    procs = [_spawn(tmp_path, ["--port", str(ports[m]), *engine_args],
                    f"m{m}.log", fake=False) for m in ("a", "b")]
    # A short grace: the standby polls every 0.1 s, so the live stream's
    # admission reaches its replica well before the stream ends.
    router = ["--replicas", "0", "--replica-urls", urls, "--takeover-grace-s",
              "0.4", "--wal-fsync-ms", "2", "--max-new-tokens", "200"]
    body = {"model": "test-tiny", "prompt": "Tell me about fair queues.",
            "options": {"temperature": 0, "repeat_penalty": 1.0,
                        "num_predict": 200}}

    def post(port, stream):
        return urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/api/generate",
            data=json.dumps({**body, "stream": stream}).encode(),
            headers={"X-User-ID": "ha"}), timeout=300)

    def stream_ids(port, rid, start):
        ids, done = [], None
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/stream/{rid}?from={start}",
                timeout=300) as r:
            for raw in r:
                f = json.loads(raw)
                if f.get("done"):
                    done = f.get("done_reason")
                    break
                ids.extend(f.get("token_ids") or ())
        return ids, done

    try:
        for m in ("a", "b"):
            _wait_health(ports[m], budget=120)
        procs.append(_spawn(tmp_path, ["--port", str(ports["primary"]), *router,
                                       "--ha", "--wal-dir", str(tmp_path / "wal-p")],
                            "primary.log", fake=False))
        _wait_health(ports["primary"])
        # The uninterrupted reference, streamed (a router's frames carry
        # the ids its member sent).
        ref_ids, ref_done = [], None
        with post(ports["primary"], True) as r:
            for raw in r:
                f = json.loads(raw)
                ref_ids.extend(f.get("token_ids") or ())
                if f.get("done"):
                    ref_done = f.get("done_reason")
                    break
        assert ref_done in ("stop", "length")
        assert len(ref_ids) >= 40
        procs.append(_spawn(tmp_path, ["--port", str(ports["standby"]), *router,
                                       "--standby-of",
                                       f"http://127.0.0.1:{ports['primary']}",
                                       "--wal-dir", str(tmp_path / "wal-s")],
                            "standby.log", fake=False))
        _wait_health(ports["standby"], ok=lambda b: b.get("role") == "standby"
                     and b.get("sync_lag_records") == 0)
        resp = post(ports["primary"], True)
        rid = int(resp.headers["X-Request-ID"])
        seen, lock = [], threading.Lock()

        def observe():
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{ports['primary']}/api/stream/{rid}",
                        timeout=300) as r:
                    for raw in r:
                        f = json.loads(raw)
                        with lock:
                            seen.extend(f.get("token_ids") or ())
            except Exception:  # noqa: BLE001 — killed under it
                pass

        threading.Thread(target=observe, daemon=True).start()
        # Replication is asynchronous: kill once the standby's replica
        # holds the admission (a stream admitted inside the last poll
        # window before a crash is the primary's alone).
        replica = str(tmp_path / "wal-s" / "wal.jsonl")
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            with lock:
                if len(seen) >= 8 and rid in load_wal_records(replica)[0]:
                    pre = list(seen)
                    break
            time.sleep(0.002)
        else:
            raise TimeoutError("the stream never reached 8 replicated tokens")
        procs[2].kill()
        procs[2].wait(timeout=30)
        resp.close()
        assert len(pre) < len(ref_ids), "the stream ended before the kill"
        sb = _wait_health(ports["standby"], budget=60.0,
                          ok=lambda b: b.get("role") == "primary"
                          and b.get("status") != "recovering")
        assert sb["epoch"] == 2
        post_ids, done = stream_ids(ports["standby"], rid, len(pre))
        assert done == ref_done
        assert pre + post_ids == ref_ids
        assert stream_ids(ports["standby"], rid, 0)[0] == ref_ids
    finally:
        _stop_all(procs)


def test_tui_ha_chip_matches_reference():
    """The TUI's `ha` chip (admin/tui.py) carries the reference's fields
    for a primary, a standby that never synced and a promoting one, and
    is absent with HA off."""
    import types

    from ollamamq_tpu.admin.tui import _engine_stats_brief as jax_brief
    from ollamamq_tpu_torch.admin.tui import _engine_stats_brief as brief

    for hs in ({"role": "primary", "epoch": 3, "sync_lag_records": 0,
                "standby_connected": True, "handover": False},
               {"role": "standby", "epoch": 1, "sync_lag_records": None,
                "synced": False, "takeovers": 0},
               {"role": "promoting", "epoch": 1, "sync_lag_records": 4,
                "synced": True, "promote_elapsed_s": 0.5}):
        eng = types.SimpleNamespace(runtimes={}, chip_stats=lambda: [],
                                    ha_status=lambda hs=hs: hs)
        assert brief(eng)["ha"] == jax_brief(eng)["ha"]
    off = types.SimpleNamespace(runtimes={}, chip_stats=lambda: [],
                                ha_status=lambda: None)
    assert "ha" not in brief(off)
