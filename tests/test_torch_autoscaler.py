"""The port's autoscaler against the JAX package's autoscaler tests.

The mirror of tests/test_autoscaler.py, case for case, over the port's
FleetRouter and AutoscalerManager (fleet/autoscaler.py behind
EngineConfig.autoscale): the fleet grows one member at a time on
SUSTAINED SLO burn or backlog, shrinks only by drain -> migrate-off ->
retire (never a kill, streams stay byte-identical), a preemption
notice on a spot member costs zero dropped streams, the bulk tier may
scale to zero with its queued work PARKED at the router until the
pending-work signal wakes it (driven here over the port's stdlib
server on a real socket), and an oscillating load produces ZERO scale
events — all journaled (scale_up / scale_down / preempt_notice) and
audited by the port's journal tool.

Beyond the mirror: the subprocess provisioner spawns the port's own CLI
(`python -m ollamamq_tpu_torch.cli`, with `--tp 1` passed through as
the JAX package's provisioner passes it), and the member it spawned
answers /health.
"""

import dataclasses
import json
import os
import time
import types
import urllib.request

import pytest

from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine.fake import FakeEngine
from ollamamq_tpu_torch.engine.health import HealthMonitor
from ollamamq_tpu_torch.engine.tokenizer import ByteTokenizer
from ollamamq_tpu_torch.fleet import FleetRouter, LocalMember
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.telemetry.slo import AlertManager
from ollamamq_tpu_torch.testing.faults import FaultPlan
from ollamamq_tpu_torch.tools.journal import (check_no_dropped_streams,
                                              check_scale_pairing)
from testutil import collect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(model="test-tiny", max_slots=4, num_pages=64, page_size=8,
            max_pages_per_seq=8, decode_steps_per_iter=2)

FAST = dict(probe_period_s=0.05, eject_heartbeat_s=5.0,
            reprobe_backoff_s=0.1, evac_grace_s=1.0)

# One fast burn window so an untiered fleet's own TTFT objective fires
# within a test's patience: (label, long_s, short_s, factor, severity).
# Legs stay >= 2s: the objective counts in one-second buckets, so a
# sub-second leg would flicker empty depending on the clock's fraction.
FAST_WINDOWS = (("fast", 5.0, 2.0, 1.0, "page"),)

# Tight hysteresis for the scaling tests; the anti-flap test overrides
# with deliberately LARGE windows.
FAST_SCALE = dict(tick_period_s=0.02, cooldown_s=0.2, sustain_s=0.05,
                  idle_sustain_s=0.15, windows=FAST_WINDOWS)


def _elastic_fleet(n=1, tiers=None, token_latency_s=0.0, plan=None,
                   autoscale_kw=None, router_kw=None, **ecfg_over):
    """Fleet with autoscale on and factory-bearing members, so the
    router's LocalProvisioner fallback can grow it."""
    cfg = dict(TINY)
    cfg.setdefault("autoscale", True)
    cfg.setdefault("min_replicas", 1)
    cfg.setdefault("max_replicas", 4)
    cfg.update(ecfg_over)
    ecfg = EngineConfig(fault_plan=plan, tiers=tiers, **cfg)
    member_cfg = dataclasses.replace(ecfg, fault_plan=None, max_queued=0,
                                     max_queued_per_user=0, tiers=None,
                                     autoscale=False)

    def mkfactory():
        def build(tp=None):
            mcfg = (member_cfg if tp in (None, member_cfg.tp)
                    else dataclasses.replace(member_cfg, tp=tp))
            return FakeEngine(mcfg, blocklist_path=None,
                              token_latency_s=token_latency_s)
        return build

    members = []
    for i in range(n):
        f = mkfactory()
        members.append(LocalMember(f"r{i}", f(), engine_factory=f))
    kw = dict(FAST)
    kw.update(router_kw or {})
    akw = dict(FAST_SCALE)
    akw.update(autoscale_kw or {})
    router = FleetRouter(members, ecfg, blocklist_path=None, tiers=tiers,
                         tiering_kw=dict(balance=False) if tiers else None,
                         autoscale_kw=akw, **kw)
    router.start()
    return router


def _run(router, user, prompt="the quick brown fox jumps over",
         max_tokens=8, deadline_ms=None):
    tokens = ByteTokenizer().encode(prompt)
    sp = SamplingParams(max_tokens=max_tokens)
    if deadline_ms is not None:
        sp.deadline_ms = deadline_ms
    return router.enqueue_request(user, "", "test-tiny",
                                  prompt_tokens=tokens, sampling=sp,
                                  raw_prompt=prompt)


def _text(items):
    return "".join(i.text for i in items if i.kind == "token")


def _wait(pred, budget=30.0, period=0.01):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(period)
    return False


def _scale_recs(router, kind):
    return router.journal.tail(None, kind=kind)


# --------------------------------------------------------- burn scale-up
def test_burn_driven_scale_up_adds_member_e2e():
    """Sustained TTFT burn on an untiered fleet provisions ONE new
    member (a0) through the LocalProvisioner; the join is journaled as
    a paired scale_up start -> done plus a replica_join, the metric
    counts it, and the new member serves traffic."""
    up_before = tm.FLEET_SCALE_EVENTS_TOTAL.labels(
        direction="up", outcome="done").value
    # slo_ttft_ms microscopically small: every request violates, so the
    # objective burns at ~100x (target 0.99) over both window legs.
    router = _elastic_fleet(n=1, max_replicas=2, slo_ttft_ms=0.0001,
                            token_latency_s=0.01)
    try:
        # A trickle of violating requests keeps the burn lit while the
        # sustain window (0.05s) and the scaler's tick both elapse.
        deadline = time.monotonic() + 30
        i = 0
        while len(router.members) < 2 and time.monotonic() < deadline:
            req = _run(router, f"burn{i}", max_tokens=2)
            assert collect(req)[-1].kind == "done"
            i += 1
        assert len(router.members) == 2
        assert [m.name for m in router.members] == ["r0", "a0"]
        # The provisioned member went through start() and serves.
        assert _wait(lambda: router.fleet_counts()["healthy"] == 2)
        recs = _scale_recs(router, "scale_up")
        start = next(r for r in recs if r["phase"] == "start")
        done = next(r for r in recs if r["phase"] == "done")
        assert start["replica"] == done["replica"] == "a0"
        assert start["why"] == "burn"
        assert start["queued"] is not None
        assert done["spawn_ms"] >= 0
        joins = router.journal.tail(None, kind="replica_join")
        assert any(r["replica"] == "a0" and r["why"] == "scale_up"
                   for r in joins)
        assert tm.FLEET_SCALE_EVENTS_TOTAL.labels(
            direction="up", outcome="done").value == up_before + 1
        # Ceiling respected: max_replicas=2 means no further growth
        # while the burn keeps firing (going idle afterwards would
        # legitimately shrink the fleet back to the floor).
        for j in range(14):
            collect(_run(router, f"post{j}", max_tokens=2))
        assert len(router.members) == 2
        assert check_scale_pairing(router.journal.tail(None)) == []
        # The new member lands in the fleet status surface.
        st = router.fleet_status()
        assert st["autoscaler"]["fleet"] == 2
        assert any(r["name"] == "a0" for r in st["replicas"])
    finally:
        router.stop()


# ------------------------------------------------------- idle scale-down
def test_idle_scale_down_drains_and_migrates_byte_identical():
    """An idle 2-member fleet (floor 1) retires one member by drain ->
    migrate-off; a stream caught mid-decode on the victim continues on
    the survivor BYTE-IDENTICAL, and the retire journals as a paired
    scale_down start -> done with why="idle"."""
    router = _elastic_fleet(n=2, min_replicas=1, max_replicas=2,
                            slo_ttft_ms=60_000.0, token_latency_s=0.05)
    try:
        # Reference text from a completed stream (FakeEngine output is
        # deterministic per token count).
        ref = _text(collect(_run(router, "ref", max_tokens=30)))
        # Two long streams spread over both members; load (2) is within
        # the survivor's half-capacity low-water mark (1*4*0.5), so the
        # idle rule fires mid-decode and the victim's stream migrates.
        reqs = [_run(router, f"long{i}", max_tokens=30) for i in range(2)]
        assert _wait(lambda: len(router.members) == 1, budget=30)
        for r in reqs:
            items = collect(r)
            assert items[-1].kind == "done"
            assert _text(items) == ref
        recs = _scale_recs(router, "scale_down")
        start = next(r for r in recs if r["phase"] == "start")
        done = next(r for r in recs if r["phase"] == "done")
        assert start["replica"] == done["replica"]
        assert start["why"] == "idle"
        assert done["fleet"] == 1
        assert check_no_dropped_streams(router.journal.tail(None)) == []
        assert check_scale_pairing(router.journal.tail(None)) == []
        # Floor respected: the last member never retires, however idle
        # (several idle-sustain windows and cooldowns pass).
        assert not _wait(lambda: len(router.members) != 1, budget=0.5)
    finally:
        router.stop()


# ------------------------------------------------------ preemption notice
def test_preemption_notice_chaos_mid_decode_zero_drops():
    """faults.py site "preempt" serves r1 (flagged preemptible) a
    termination notice mid-decode on a FIXED fleet (no autoscaler —
    preemption is a router capability): the member migrates its streams
    off and retires within the window; zero drops, byte-identical
    continuations, journal carries preempt_notice + paired scale_down
    why="preempt"."""
    pre_before = tm.FLEET_PREEMPTIONS_TOTAL.value
    # Draws number 1.. per probe sweep over 2 members: even draws land
    # on r1. at=[6] fires on sweep 3 (~0.2s in) — streams are mid-decode.
    plan = FaultPlan([{"site": "preempt", "kind": "exception", "at": [6]}])
    ecfg = EngineConfig(fault_plan=plan, preemptible="r1", **TINY)
    member_cfg = dataclasses.replace(ecfg, fault_plan=None, max_queued=0,
                                     max_queued_per_user=0)
    members = [LocalMember(f"r{i}",
                           FakeEngine(member_cfg, blocklist_path=None,
                                      token_latency_s=0.05))
               for i in range(2)]
    router = FleetRouter(members, ecfg, blocklist_path=None, **FAST)
    router.start()
    try:
        assert router.members[1].preemptible is True
        ref = _text(collect(_run(router, "ref", max_tokens=24)))
        reqs = [_run(router, f"p{i}", max_tokens=24) for i in range(4)]
        assert _wait(lambda: len(router.members) == 1, budget=30)
        assert [m.name for m in router.members] == ["r0"]
        for r in reqs:
            items = collect(r)
            assert items[-1].kind == "done"
            assert _text(items) == ref
        notice = router.journal.tail(None, kind="preempt_notice")[-1]
        assert notice["replica"] == "r1"
        assert notice["notice_s"] > 0
        recs = _scale_recs(router, "scale_down")
        start = next(r for r in recs if r["phase"] == "start")
        assert (start["replica"], start["why"]) == ("r1", "preempt")
        assert any(r["phase"] == "done" and r["replica"] == "r1"
                   for r in recs)
        assert tm.FLEET_PREEMPTIONS_TOTAL.value == pre_before + 1
        assert check_no_dropped_streams(router.journal.tail(None)) == []
        assert check_scale_pairing(router.journal.tail(None)) == []
    finally:
        router.stop()


def test_preempt_requires_preemptible_flag():
    ecfg = EngineConfig(**TINY)
    member_cfg = dataclasses.replace(ecfg, max_queued=0,
                                     max_queued_per_user=0)
    members = [LocalMember(f"r{i}",
                           FakeEngine(member_cfg, blocklist_path=None))
               for i in range(2)]
    router = FleetRouter(members, ecfg, blocklist_path=None, **FAST)
    router.start()
    try:
        with pytest.raises(ValueError):
            router.preempt_replica("r0")
        with pytest.raises(KeyError):
            router.preempt_replica("nope")
    finally:
        router.stop()


# -------------------------------------------------- scale-to-zero / wake
def test_scale_to_zero_parks_and_wakes_over_http():
    """The bulk tier idles to ZERO members; queued bulk work parks at
    the router (503 Retry-After covers the wake+spawn time) and the
    pending-work signal wakes the tier — bypassing cooldown — so the
    parked stream completes, streamed over the port's stdlib server.
    Interactive keeps its min_replicas floor throughout."""
    router = _elastic_fleet(
        n=2, tiers="interactive=r0;bulk=r1", min_replicas=1,
        max_replicas=3, slo_ttft_ms=60_000.0, token_latency_s=0.02)
    srv = None
    try:
        # Phase A: nothing queued -> bulk (floor 0) drains to zero;
        # interactive (floor 1) never shrinks.
        assert _wait(lambda: router.tiers.scaled_to_zero == {"bulk"},
                     budget=30)
        assert [m.name for m in router.members] == ["r0"]
        down = _scale_recs(router, "scale_down")[-1]
        assert (down["replica"], down["tier"]) == ("r1", "bulk")
        # Retry-After for the parked tier accounts for wake + spawn.
        wake = router.autoscaler.wake_wait_s()
        assert wake > 0
        assert router.retry_after_s() >= wake

        # Phase B: a bulk request over HTTP parks, wakes the tier, and
        # streams to completion on the woken member.
        srv = serve_in_thread(router, timeout_s=60)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/api/generate",
            data=json.dumps({"model": "test-tiny", "prompt": "wake up",
                             "options": {"num_predict": 6}}).encode(),
            headers={"X-User-ID": "bulkuser",
                     "Content-Type": "application/json"})
        texts = []
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            for line in resp:
                if not line.strip():
                    continue
                obj = json.loads(line)
                texts.append(obj.get("response", ""))
                if obj.get("done"):
                    assert obj["done_reason"] in ("length", "stop")
                    break
        text = "".join(texts)
        assert text.startswith("word0 word1 ")
        ups = _scale_recs(router, "scale_up")
        wake_start = next(r for r in ups if r["phase"] == "start")
        assert (wake_start["why"], wake_start["tier"]) == ("wake", "bulk")
        assert any(r["phase"] == "done" for r in ups)
        assert "bulk" not in router.tiers.scaled_to_zero
        woken = next(m for m in router.members if m.name == "a0")
        assert woken.tier == "bulk"
        assert check_scale_pairing(router.journal.tail(None)) == []
    finally:
        if srv is not None:
            stop_server(srv)  # stops the router too
        else:
            router.stop()


# -------------------------------------------------------------- anti-flap
def test_oscillating_load_produces_zero_scale_events():
    """Hysteresis: bursts shorter than the sustain window, separated by
    idle gaps shorter than the idle window, must produce ZERO scale
    events in either direction — the one-knob cooldown discipline."""
    router = _elastic_fleet(
        n=2, min_replicas=1, max_replicas=3, slo_ttft_ms=0.0001,
        token_latency_s=0.01,
        autoscale_kw=dict(tick_period_s=0.02, cooldown_s=30.0,
                          sustain_s=10.0, idle_sustain_s=30.0,
                          windows=FAST_WINDOWS))
    try:
        for burst in range(3):
            # Burn fires (every TTFT violates) + backlog spikes past
            # backlog_high for a moment...
            reqs = [_run(router, f"o{burst}-{i}", max_tokens=2)
                    for i in range(6)]
            for r in reqs:
                assert collect(r)[-1].kind == "done"
            # ...then the fleet goes fully idle for a moment.
            time.sleep(0.15)
        assert len(router.members) == 2
        assert _scale_recs(router, "scale_up") == []
        assert _scale_recs(router, "scale_down") == []
    finally:
        router.stop()


# -------------------------------------------------------- CLI validation
def test_cli_autoscale_validation_fails_fast():
    from ollamamq_tpu_torch.cli import main

    base = ["--no-tui", "--replicas", "2"]
    assert main(base + ["--autoscale", "--min-replicas", "0"]) == 2
    assert main(base + ["--autoscale", "--min-replicas", "3",
                        "--max-replicas", "2"]) == 2
    assert main(base + ["--autoscale", "--scale-cooldown-s", "0"]) == 2
    # Starting fleet larger than the ceiling.
    assert main(["--no-tui", "--replicas", "5", "--autoscale",
                 "--max-replicas", "4"]) == 2
    # Preemptible flags: unknown member name; no fleet to flag.
    assert main(base + ["--preemptible", "r5"]) == 2
    assert main(["--no-tui", "--preemptible", "r0"]) == 2


# ------------------------------------------------- scale_storm watchdog
def test_scale_storm_watchdog_fires_and_resolves():
    """health.py scale_storm: a flapping autoscaler (rate above
    SCALE_STORM_PER_MIN) fires the warn alert and counts ONE
    ollamamq_watchdog_stalls_total{kind="scale"} per firing transition;
    the alert resolves when the rate drops."""
    rate = {"v": 12.0}
    stub = types.SimpleNamespace(
        alerts=AlertManager(),
        autoscaler=types.SimpleNamespace(
            scale_rate_per_min=lambda: rate["v"]))
    mon = HealthMonitor(stub)
    before = tm.WATCHDOG_STALLS_TOTAL.labels(kind="scale").value
    mon._check_scale_storm()
    assert any(a.name == "scale_storm" for a in stub.alerts.active())
    assert tm.WATCHDOG_STALLS_TOTAL.labels(
        kind="scale").value == before + 1
    # Still firing: no double count.
    mon._check_scale_storm()
    assert tm.WATCHDOG_STALLS_TOTAL.labels(
        kind="scale").value == before + 1
    rate["v"] = 0.0
    mon._check_scale_storm()
    assert not any(a.name == "scale_storm"
                   for a in stub.alerts.active())
    # A non-elastic engine (no .autoscaler) is a clean no-op.
    HealthMonitor(types.SimpleNamespace(
        alerts=AlertManager()))._check_scale_storm()


# ------------------------------------------------- journal scale pairing
def test_check_scale_pairing_rules():
    def rec(kind, rep, seq, **kw):
        return {"kind": kind, "replica": rep, "seq": seq, **kw}

    # Paired up + paired down + resolved notice: clean.
    ok = [
        rec("scale_up", "a0", 1, phase="start"),
        rec("scale_up", "a0", 2, phase="done"),
        rec("preempt_notice", "r1", 3),
        rec("scale_down", "r1", 4, phase="start"),
        rec("scale_down", "r1", 5, phase="done"),
        rec("scale_up", "a1", 6, phase="start"),
        rec("scale_up", "a1", 7, phase="aborted"),
    ]
    assert check_scale_pairing(ok) == []
    # Hanging scale_up start.
    bad = check_scale_pairing([rec("scale_up", "a0", 1, phase="start")])
    assert len(bad) == 1 and "UNRESOLVED" in bad[0]
    # A notice the fleet never acted on (window lapsed, member serving).
    bad = check_scale_pairing([rec("preempt_notice", "r1", 1)])
    assert len(bad) == 1 and "r1" in bad[0]
    # Double start for the same (direction, replica).
    bad = check_scale_pairing([
        rec("scale_down", "r0", 1, phase="start"),
        rec("scale_down", "r0", 2, phase="start"),
        rec("scale_down", "r0", 3, phase="done"),
    ])
    assert len(bad) == 1 and "never resolved" in bad[0]
    # A bare resolution (spill ring tail) is tolerated.
    assert check_scale_pairing(
        [rec("scale_down", "r0", 9, phase="done")]) == []


def test_subprocess_provisioner_scrubs_router_env(monkeypatch):
    # A provisioned member is a plain single-engine server. Router-level
    # env leaking into it is fatal (TIERS without a fleet fail-fasts the
    # child CLI) or corrupting (a shared JOURNAL_FILE / WAL_DIR has two
    # processes appending to one log), so the provisioner must scrub it
    # the same way the in-process path strips member_cfg fields.
    from ollamamq_tpu_torch.fleet.autoscaler import SubprocessProvisioner

    monkeypatch.setenv("TIERS", "interactive=r0;bulk=r1")
    monkeypatch.setenv("AUTOSCALE", "true")
    monkeypatch.setenv("REPLICAS", "2")
    monkeypatch.setenv("JOURNAL_FILE", "/tmp/router-spill.jsonl")
    monkeypatch.setenv("MODELS", "test-tiny")
    prov = SubprocessProvisioner(["--fake-engine"],
                                 env={"FAKE_TOKEN_LATENCY_S": "0"})
    env = prov.child_env()
    for key in ("TIERS", "AUTOSCALE", "REPLICAS", "JOURNAL_FILE"):
        assert key not in env
    assert env["MODELS"] == "test-tiny"      # member config still rides
    assert env["FAKE_TOKEN_LATENCY_S"] == "0"  # explicit overlay wins


def test_subprocess_provisioner_spawns_a_port_cli_member(tmp_path,
                                                         monkeypatch):
    """The spawned member is the port's own CLI (never the JAX
    package's), takes the `--tp 1` the provisioner passes for a tier
    width of 1, answers /health, serves a stream as an HttpMember, and
    exits on retire."""
    from ollamamq_tpu_torch.fleet.autoscaler import SubprocessProvisioner

    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("TIERS", "interactive=r0;bulk=r1")  # scrubbed
    prov = SubprocessProvisioner(
        ["--fake-engine", "--models", "test-tiny", "--max-slots", "2",
         "--blocklist", str(tmp_path / "blocked.json")],
        log_dir=str(tmp_path), health_timeout_s=120.0)
    member = prov.provision("a0", tier="bulk", tp=1)
    proc, _ = prov._procs["a0"]
    try:
        argv = proc.args
        assert argv[1:3] == ["-m", "ollamamq_tpu_torch.cli"]
        assert argv[-2:] == ["--tp", "1"]
        with urllib.request.urlopen(member.url + "/health",
                                    timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok"
        member.start()
        router = FleetRouter([member], EngineConfig(**TINY),
                             blocklist_path=None, **FAST)
        router.start()
        try:
            items = collect(_run(router, "sub", max_tokens=3))
            assert items[-1].kind == "done"
            assert _text(items).split() == ["word0", "word1", "word2"]
        finally:
            router.stop()
    finally:
        prov.retire(member)
    assert proc.poll() is not None
    assert "a0" not in prov._procs
