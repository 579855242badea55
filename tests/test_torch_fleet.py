"""The port's fleet router against the JAX package's fleet tests.

The mirror of tests/test_fleet.py, case for case, over the port's
FleetRouter: members are the port's FakeEngine and TorchEngine on the
CPU (test-tiny, float32, plain attention), HTTP members are the port's
stdlib server on real sockets. The contract: a replica dying, ejected
or drained mid-stream is invisible to the client beyond latency. The
stream continues byte-identically on another replica (by KV migration,
or by recompute replay when a transfer cannot land), nothing is
dropped, pages are conserved on every member, and the router's journal
explains every eject, failover, drain and migration.

Beyond the mirror: the server refuses a body over MAX_BODY with 413
before reading it, as the JAX package's server does.
"""

import dataclasses
import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine import kv_cache as kvc
from ollamamq_tpu_torch.engine.engine import QueueFullError, TorchEngine
from ollamamq_tpu_torch.engine.fake import FakeEngine
from ollamamq_tpu_torch.engine.request import FinishReason
from ollamamq_tpu_torch.engine.tokenizer import ByteTokenizer
from ollamamq_tpu_torch.fleet import FleetRouter, HttpMember, LocalMember
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.app import (MAX_BODY, OllamaServer,
                                           serve_in_thread, stop_server)
from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.telemetry.journal import check_invariants
from ollamamq_tpu_torch.testing.faults import FaultPlan
from ollamamq_tpu_torch.tools.journal import check_no_dropped_streams
from testutil import collect

TINY = dict(model="test-tiny", max_slots=4, num_pages=64, page_size=8,
            max_pages_per_seq=8, decode_steps_per_iter=2)

FAST = dict(probe_period_s=0.05, eject_heartbeat_s=5.0,
            reprobe_backoff_s=0.1, evac_grace_s=1.0)

# Prompts shared with tests/test_fleet.py: repetitive ones give the
# n-gram proposer drafts to verify and the prefix cache pages to share.
PROMPTS = [
    "the cat sat on the mat the cat sat on the",
    "the cat sat on the mat the cat sat on a",
    "pack my box with five dozen jugs",
    "the cat sat on the mat the cat sat on my",
    "pack my box with five dozen mugs",
    "the cat sat on the mat the cat",
]


def _member_cfg(ecfg):
    return dataclasses.replace(ecfg, fault_plan=None, max_queued=0,
                               max_queued_per_user=0)


def _fake_fleet(n=2, token_latency_s=0.0, plan=None, router_kw=None,
                **ecfg_over):
    cfg = dict(TINY)
    cfg.update(ecfg_over)
    ecfg = EngineConfig(fault_plan=plan, **cfg)
    members = [
        LocalMember(f"r{i}", FakeEngine(_member_cfg(ecfg), blocklist_path=None,
                                        token_latency_s=token_latency_s))
        for i in range(n)
    ]
    kw = dict(FAST)
    kw.update(router_kw or {})
    router = FleetRouter(members, ecfg, blocklist_path=None, **kw)
    router.start()
    return router


def _torch_fleet(n=2, plan=None, router_kw=None, **ecfg_over):
    """TorchEngine members on the CPU in float32: greedy identity holds
    across members (one process, one set of seeded weights)."""
    cfg = dict(TINY, dtype="float32")
    cfg.update(ecfg_over)
    ecfg = EngineConfig(fault_plan=plan, **cfg)
    members = [
        LocalMember(f"r{i}", TorchEngine(_member_cfg(ecfg), device="cpu",
                                         models={"test-tiny": None},
                                         blocklist_path=None,
                                         dtype=torch.float32))
        for i in range(n)
    ]
    kw = dict(FAST)
    kw.update(router_kw or {})
    router = FleetRouter(members, ecfg, blocklist_path=None, **kw)
    router.start()
    return router


def _run(router, user, prompt="the quick brown fox jumps over", max_tokens=8,
         **sp_kw):
    rt = router.resolve_runtime("test-tiny")
    tok = rt.tokenizer if rt is not None else ByteTokenizer()
    return router.enqueue_request(
        user, "", "test-tiny", prompt_tokens=tok.encode(prompt),
        sampling=SamplingParams(max_tokens=max_tokens, **sp_kw),
        raw_prompt=prompt)


def _text(items):
    return "".join(i.text for i in items if i.kind == "token")


def _serving_member(router, req):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        for f in list(router.flights):
            if f.req is req and f.member is not None:
                return f.member
        time.sleep(0.01)
    raise TimeoutError("request never placed")


def _wait_healthy(router, n=2, budget=30.0):
    deadline = time.monotonic() + budget
    while router.fleet_counts()["healthy"] < n \
            and time.monotonic() < deadline:
        time.sleep(0.05)


def _kill_at_depth(router, depth):
    """Crash the member serving the first stream to reach `depth`
    generated tokens; returns it."""
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        for f in list(router.flights):
            if f.attempt is not None \
                    and len(f.attempt.req.generated_ids) >= depth:
                f.member.crash()
                return f.member
        time.sleep(0.01)
    raise AssertionError("no stream reached the kill depth")


# ------------------------------------------------------------ basic routing
def test_least_loaded_placement_spreads_across_members():
    router = _fake_fleet(n=2)
    try:
        reqs = [_run(router, f"u{i}") for i in range(8)]
        for r in reqs:
            items = collect(r)
            assert items[-1].kind == "done"
            assert _text(items).startswith("word0 ")
        placed = {rec["runtime"] for rec in router.journal.tail(
            None, kind="place")}
        assert placed == {"r0", "r1"}, placed
        assert check_no_dropped_streams(router.journal.tail(None)) == []
    finally:
        router.stop()


def test_bounded_admission_sheds_fleet_wide_with_aggregate_retry_after():
    # 2 members x 1 slot, slow tokens: the 3rd+ request queues at the
    # ROUTER; the per-user cap sheds with a fleet-derived Retry-After.
    router = _fake_fleet(n=2, token_latency_s=0.2, max_slots=1,
                         max_queued_per_user=1)
    try:
        reqs = []
        with pytest.raises(QueueFullError) as ei:
            for _ in range(11):  # the cap must hit while members serve
                reqs.append(_run(router, "greedy", max_tokens=4))
                time.sleep(0.02)
        assert ei.value.scope == "user_queue_full"
        assert 1 <= ei.value.retry_after_s <= 300
        sheds = router.journal.tail(None, kind="shed")
        assert sheds and sheds[-1]["reason"] == "user_queue_full"
        for r in reqs:
            collect(r)
        # The ROUTER tracer observed every member's completions.
        assert len(router.tracer.finish_times) == len(reqs)
    finally:
        router.stop()


# ------------------------------------------------------- failover (local)
@pytest.mark.parametrize(
    "prefix_cache,spec",
    [(False, False), (True, False), (True, True)],
    ids=["plain", "cache", "cache+spec"])
def test_failover_byte_identity_fuzz(prefix_cache, spec):
    """Kill a replica mid-stream: every stream, failed-over ones
    included, matches the single-replica golden run byte for byte."""
    over = dict(prefix_cache=prefix_cache, spec=spec, spec_k=2)
    golden = _torch_fleet(n=1, **over)
    try:
        gtexts = [_text(collect(_run(golden, f"u{i % 3}", p, max_tokens=12)))
                  for i, p in enumerate(PROMPTS)]
    finally:
        golden.stop()
    router = _torch_fleet(n=2, **over)
    try:
        reqs = [_run(router, f"u{i % 3}", p, max_tokens=12)
                for i, p in enumerate(PROMPTS)]
        _kill_at_depth(router, 2)
        texts = [_text(collect(r)) for r in reqs]
        assert texts == gtexts
        recs = router.journal.tail(None)
        assert any(r["kind"] == "replica_eject" for r in recs)
        assert router.migration_count + router.failover_count >= 1
        assert check_no_dropped_streams(recs) == []
        assert check_invariants(recs) == []
    finally:
        router.stop()


def test_affinity_placement_routes_to_cached_replica():
    router = _torch_fleet(n=2, prefix_cache=True)
    try:
        prompt = "shared system preamble for affinity routing tests ok"
        collect(_run(router, "aff", prompt, max_tokens=4))
        first = router.journal.tail(None, kind="place")[-1]["runtime"]
        hits0 = tm.FLEET_AFFINITY_HITS_TOTAL.value
        collect(_run(router, "aff", prompt, max_tokens=4))
        second = router.journal.tail(None, kind="place")[-1]["runtime"]
        assert second == first  # the radix tree holds the prefix there
        assert tm.FLEET_AFFINITY_HITS_TOTAL.value > hits0
    finally:
        router.stop()


# ------------------------------------------------- eject / heal / rejoin
def test_ejected_replica_rejoins_after_heal():
    """Site "replica" device_loss with heal_after_s: the member crashes,
    its stream moves, the backoff re-probe keeps it out until the plan
    heals, then it rejoins; replica_stale fires while it is out."""
    plan = FaultPlan([{"site": "replica", "kind": "device_loss",
                       "at": [1], "heal_after_s": 0.6}])
    router = _fake_fleet(n=2, token_latency_s=0.05, plan=plan)
    try:
        req = _run(router, "heal", max_tokens=16)
        deadline = time.monotonic() + 30
        while router.fleet_counts()["ejected"] == 0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        assert router.fleet_counts()["ejected"] == 1
        assert router.stale_replicas() == ["r0"]
        before = tm.WATCHDOG_STALLS_TOTAL.labels(kind="replica").value
        router.health.check_once()
        assert any(a.name == "replica_stale" for a in router.alerts.active())
        assert tm.WATCHDOG_STALLS_TOTAL.labels(
            kind="replica").value == before + 1
        items = collect(req)
        assert items[-1].kind == "done"
        assert _text(items).startswith("word0 word1 ")
        _wait_healthy(router)
        assert router.fleet_counts() == {"healthy": 2, "ejected": 0,
                                         "draining": 0}
        joins = [r for r in router.journal.tail(None, kind="replica_join")
                 if r.get("why") == "heal"]
        assert joins and joins[-1]["replica"] == "r0"
        router.health.check_once()
        assert not any(a.name == "replica_stale"
                       for a in router.alerts.active())
    finally:
        router.stop()


def test_slow_fault_forces_stale_heartbeat_eject_and_rejoin():
    plan = FaultPlan([{"site": "replica", "kind": "slow", "delay_s": 0.5,
                       "at": [2]}])  # call 2 = member r1, first sweep
    router = _fake_fleet(n=2, token_latency_s=0.02, plan=plan,
                         router_kw=dict(eject_heartbeat_s=0.2))
    try:
        reqs = [_run(router, f"s{i}", max_tokens=10) for i in range(4)]
        for r in reqs:
            assert collect(r)[-1].kind == "done"
        ejected = router.journal.tail(None, kind="replica_eject")
        assert any(r["why"] == "stale_heartbeat" for r in ejected)
        _wait_healthy(router)
        assert router.fleet_counts()["healthy"] == 2
        assert check_no_dropped_streams(router.journal.tail(None)) == []
    finally:
        router.stop()


# ----------------------------------------------------------- HTTP plumbing
def _post(url, body=None, raw=None, headers=None, timeout=30):
    data = raw if raw is not None else json.dumps(body or {}).encode()
    hdrs = {"Content-Type": "application/json", **(headers or {})}
    return urllib.request.urlopen(urllib.request.Request(
        url, data=data, headers=hdrs, method="POST"), timeout=timeout)


def _get_json(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read())


def _ndjson(resp):
    """(text, done frame) of an NDJSON stream."""
    texts, last = [], None
    for line in resp:
        if not line.strip():
            continue
        obj = json.loads(line)
        texts.append(obj.get("response", ""))
        last = obj
        if obj.get("done"):
            break
    return "".join(texts), last


class _HttpBackend:
    """An engine served by the port's stdlib server on a real socket,
    with a HARD kill: every live connection is shut down (the reset a
    crashed service presents), not a graceful drain."""

    def __init__(self, engine):
        self.engine = engine
        self.conns = []
        backend = self

        class _Server(OllamaServer):
            def process_request(self, request, client_address):
                backend.conns.append(request)
                super().process_request(request, client_address)

        engine.start()
        self.server = _Server(engine, "127.0.0.1", 0, timeout_s=30)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def stop(self):
        if self.server is None:
            return
        self.server.shutdown()
        for sock in self.conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        self.server.server_close()
        self.thread.join(timeout=10)
        self.server = None
        self.engine.stop()


def _http_fleet(n=2, **router_kw):
    backends = [_HttpBackend(FakeEngine(EngineConfig(**TINY),
                                        blocklist_path=None,
                                        token_latency_s=0.05))
                for _ in range(n)]
    members = [HttpMember(f"h{i}", b.url, timeout_s=30, poll_period_s=0.1)
               for i, b in enumerate(backends)]
    kw = dict(probe_period_s=0.05, eject_heartbeat_s=1.0,
              reprobe_backoff_s=0.2, evac_grace_s=0.5)
    kw.update(router_kw)
    router = FleetRouter(members, EngineConfig(**TINY), blocklist_path=None,
                         **kw)
    router.start()
    return router, backends


# --------------------------------------------------------------- drain e2e
def test_drain_completes_all_streams_over_http():
    router = _fake_fleet(n=2, token_latency_s=0.05)
    srv = serve_in_thread(router, timeout_s=60)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        out = [None] * 6

        def stream_one(i):
            with _post(url + "/api/generate",
                       {"model": "test-tiny", "prompt": f"hello {i}",
                        "options": {"num_predict": 10}},
                       headers={"X-User-ID": f"d{i}"}) as resp:
                assert resp.status == 200
                out[i] = _ndjson(resp)

        threads = [threading.Thread(target=stream_one, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        time.sleep(0.15)  # streams are mid-flight
        with _post(url + "/admin/drain/r0") as resp:
            assert resp.status == 200
            assert json.loads(resp.read())["state"] == "draining"
        for t in threads:
            t.join(timeout=60)
        for text, last in out:
            assert text.startswith("word0 word1 ")  # nothing dropped
            assert last["done_reason"] in ("length", "stop")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            fl = _get_json(url + "/admin/fleet")
            if fl["counts"] == {"healthy": 2, "ejected": 0, "draining": 0}:
                break
            time.sleep(0.05)
        assert fl["counts"]["healthy"] == 2
        assert fl["placement"] == "affinity"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url + "/admin/drain/nope")
        assert ei.value.code == 404
        recs = router.journal.tail(None)
        assert "replica_drain" in [r["kind"] for r in recs]
        assert any(r["kind"] == "replica_join"
                   and r.get("why") == "drain_complete" for r in recs)
        assert check_no_dropped_streams(recs) == []
    finally:
        stop_server(srv)


# ------------------------------------------------------------ HTTP members
def test_http_members_serve_and_fail_over():
    """A pure router over two engine services. Killing a backend
    mid-stream fails the victim over in TOKEN space (the frames carry
    their ids) and drops nothing."""
    router, backends = _http_fleet()
    try:
        warm = collect(_run(router, "h-warm", "warmup prompt", max_tokens=4))
        assert warm[-1].kind == "done"
        assert _text(warm) == "word0 word1 word2 word3 "
        req = _run(router, "h-kill", "victim prompt", max_tokens=16)
        mem = _serving_member(router, req)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            f = next((f for f in list(router.flights) if f.req is req), None)
            if f is not None and f.attempt is not None \
                    and f.attempt.n_items >= 2:
                break
            time.sleep(0.01)
        backends[int(mem.name[1])].stop()  # the service dies mid-stream
        items = collect(req, timeout=60)
        assert items[-1].kind == "done"
        tokens = [i for i in items if i.kind == "token"]
        assert len(tokens) == 16
        assert _text(items) == "".join(f"word{i} " for i in range(16))
        assert [i.token_id for i in tokens] == list(range(1, 17))
        assert router.failover_count >= 1
        assert check_no_dropped_streams(router.journal.tail(None)) == []
    finally:
        router.stop()
        for b in backends:
            b.stop()


# ------------------------------------------------------- journal & surfaces
def test_fleet_journal_kinds_schema_and_explanations():
    from ollamamq_tpu_torch.telemetry.journal import (Journal, JournalError,
                                                      explain)

    j = Journal(capacity=64)
    j.record("replica_eject", replica="r1", why="stale_heartbeat",
             victims=3, heartbeat_age_s=4.2, backoff_s=0.5)
    j.record("replica_failover", req_id=7, user="u", replica="r1",
             to_replica="r0", replayed_tokens=5)
    j.record("replica_drain", replica="r0", inflight=2, timeout_s=30.0)
    j.record("replica_join", replica="r1", why="heal")
    j.record("migrate_export", req_id=7, user="u", replica="r1",
             tokens=5, kv_len=21, pages=3, bytes=4096)
    j.record("migrate_import", req_id=7, user="u", replica="r1",
             to_replica="r0", tokens=5, pages=3, bytes=4096)
    j.record("migrate_abort", req_id=8, user="u", replica="r1",
             why="timeout")
    texts = [explain(r) for r in j.tail(None)]
    assert "r1 ejected (stale_heartbeat)" in texts[0]
    assert "3 in-flight stream(s)" in texts[0]
    assert "failed over from replica r1 to r0" in texts[1]
    assert "replaying 5" in texts[1]
    assert "draining" in texts[2]
    assert "joined rotation (heal)" in texts[3]
    assert "exported for migration" in texts[4]
    assert "0 recomputed" in texts[5] and "r1 -> r0" in texts[5]
    assert "aborted (timeout)" in texts[6]
    assert "recompute" in texts[6]
    with pytest.raises(JournalError):
        j.record("replica_eject", why="missing-replica-field")
    with pytest.raises(JournalError):
        j.record("replica_failover", replica="r1", bogus=1)
    with pytest.raises(JournalError):
        j.record("migrate_export", replica="r1")  # missing tokens
    with pytest.raises(JournalError):
        j.record("migrate_abort", replica="r1")  # missing why


def test_no_dropped_streams_checker_flags_missing_terminal():
    clean = [
        {"kind": "replica_failover", "req_id": 4, "seq": 1},
        {"kind": "finish", "req_id": 4, "seq": 2, "reason": "length"},
    ]
    assert check_no_dropped_streams(clean) == []
    dropped = [
        {"kind": "replica_failover", "req_id": 4, "seq": 1},
        {"kind": "replica_failover", "req_id": 9, "seq": 3},
        {"kind": "deadline_drop", "req_id": 9, "seq": 4},
    ]
    bad = check_no_dropped_streams(dropped)
    assert len(bad) == 1 and "req 4" in bad[0] and "DROPPED" in bad[0]


def test_tui_brief_carries_replica_counts():
    from ollamamq_tpu_torch.admin.tui import _engine_stats_brief

    router = _fake_fleet(n=2)
    try:
        brief = _engine_stats_brief(router)
        assert brief["replicas"] == {"healthy": 2, "ejected": 0,
                                     "draining": 0}
        assert len(brief["models"]) == 2  # one test-tiny row per member
        assert brief["router_overhead"]["budget_ms"] == 50.0
    finally:
        router.stop()
    single = FakeEngine(EngineConfig(**TINY), blocklist_path=None)
    brief = _engine_stats_brief(single)
    assert "replicas" not in brief and "router_overhead" not in brief


def test_fleet_metrics_and_stats_surface():
    router = _fake_fleet(n=2)
    try:
        for i in range(3):
            collect(_run(router, f"m{i}"))
        snap = {lv[0]: child.value
                for lv, child in tm.FLEET_REPLICAS.series()}
        assert snap == {"healthy": 2, "ejected": 0, "draining": 0}
        stats = router.stats()
        assert stats["fleet"]["counts"]["healthy"] == 2
        assert len(stats["fleet"]["replicas"]) == 2
        assert stats["queue"] is not None
        assert len(stats["runtimes"]) == 2
        assert {r["replica"] for r in stats["runtimes"]} == {"r0", "r1"}
    finally:
        router.stop()


@pytest.mark.parametrize("argv,message", [
    (["--replicas", "0"], "--replicas must be >= 1"),
    (["--replicas", "-1"], "--replicas must be >= 1"),
    (["--drain-timeout-s", "0"], "--drain-timeout-s"),
    (["--migrate-timeout-s", "0"], "--migrate-timeout-s"),
    (["--migrate-timeout-s", "-1"], "--migrate-timeout-s"),
    (["--router-overhead-budget-ms", "-1"], "--router-overhead-budget-ms"),
    (["--preemptible", "r0"], "--preemptible needs a fleet"),
    (["--replicas", "2", "--preemptible", "r7"], "unknown members: r7"),
    (["--replicas", "2", "--tiers", "gold=r0"], "unknown tier name 'gold'"),
    (["--replicas", "2", "--autoscale", "--min-replicas", "0"],
     "--min-replicas must be >= 1"),
    (["--replicas", "2", "--ha"], "--ha requires --wal-dir"),
    (["--standby-of", "http://127.0.0.1:1"], "--standby-of requires --wal-dir"),
], ids=["zero", "negative", "drain", "migrate", "migrate-neg", "budget",
        "preempt-nofleet", "preempt-unknown", "tiers", "autoscale", "ha",
        "standby"])
def test_cli_fleet_flag_validation(argv, message, caplog):
    """Each invalid fleet flag exits 2 before any device work (a bad
    tier spec, a bad autoscaler bound, an HA role without its WAL)."""
    from ollamamq_tpu_torch.cli import main

    assert main(argv + ["--no-tui"]) == 2
    assert message in caplog.text


def test_fleet_router_refuses_unported_policy_layers():
    """The policy layers refuse only what they cannot serve: an HA
    primary without the WAL it replicates, a tier spec that leaves a
    tier empty, and an autoscaler with no provisioner and no member
    factory to build one from."""
    ecfg = EngineConfig(**TINY)
    member = LocalMember("r0", FakeEngine(ecfg, blocklist_path=None))
    with pytest.raises(ValueError, match="--ha requires --wal-dir"):
        FleetRouter([member], dataclasses.replace(ecfg, ha=True),
                    blocklist_path=None)
    with pytest.raises(ValueError, match="tier 'bulk' has no members"):
        FleetRouter([member], ecfg, blocklist_path=None,
                    tiers="interactive=r0")
    with pytest.raises(ValueError, match="needs a MemberProvisioner"):
        FleetRouter([member], dataclasses.replace(ecfg, autoscale=True),
                    blocklist_path=None)


# ------------------------------------------------------------- migration
def _alloc_conserved(router):
    """free + used + cached == pool on every member runtime."""
    for mem in router.local_members:
        for rt in mem.engine.runtimes.values():
            alloc = getattr(rt, "alloc", None)
            if alloc is None:
                continue
            assert (alloc.free_pages + alloc.used_pages + alloc.cached_pages
                    == alloc.num_pages - 1), mem.name


def _member_journals_clean(router):
    for mem in router.local_members:
        assert check_invariants(mem.engine.journal.tail(None)) == [], mem.name


@pytest.mark.parametrize(
    "prefix_cache,kv_dtype,spec,seed",
    [(False, "bfloat16", False, 0), (True, "bfloat16", False, 1),
     (False, "int8", False, 2), (True, "int8", True, 3)],
    ids=["plain", "cache", "int8", "cache+int8+spec"])
def test_migration_fuzz_byte_identity_and_page_conservation(
        prefix_cache, kv_dtype, spec, seed):
    """Kill a member at a seeded decode depth across prefix cache x int8
    KV x spec: victim streams MIGRATE (pages shipped, zero recomputed
    tokens), every stream matches the single-replica golden byte for
    byte, and free + used + cached == pool holds on both members."""
    over = dict(prefix_cache=prefix_cache, kv_dtype=kv_dtype, spec=spec,
                spec_k=2)
    depth = random.Random(seed).randrange(1, 6)
    golden = _torch_fleet(n=1, **over)
    try:
        gtexts = [_text(collect(_run(golden, f"mg{i % 2}", p, max_tokens=48)))
                  for i, p in enumerate(PROMPTS)]
    finally:
        golden.stop()
    router = _torch_fleet(n=2, **over)
    try:
        reqs = [_run(router, f"mg{i % 2}", p, max_tokens=48)
                for i, p in enumerate(PROMPTS)]
        _kill_at_depth(router, depth)
        texts = [_text(collect(r)) for r in reqs]
        assert texts == gtexts
        recs = router.journal.tail(None)
        migrated = [r for r in recs if r["kind"] == "migrate_import"
                    and r.get("what") != "prefix"]
        assert migrated, "the crash should have migrated a stream"
        assert router.migration_count >= 1
        assert tm.FLEET_MIGRATIONS_TOTAL.labels(outcome="migrated").value >= 1
        assert check_no_dropped_streams(recs) == []
        assert check_invariants(recs) == []
        _member_journals_clean(router)
        _wait_healthy(router)
        _alloc_conserved(router)
    finally:
        router.stop()


def test_drain_migrates_streams_instead_of_running_them_out():
    router = _fake_fleet(n=2, token_latency_s=0.05)
    try:
        reqs = [_run(router, f"dm{i}", max_tokens=16) for i in range(4)]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            placed = [f for f in list(router.flights) if f.attempt is not None]
            if len(placed) == 4 and all(f.attempt.req.generated_ids
                                        for f in placed):
                break
            time.sleep(0.01)
        router.drain_replica("r0")
        for r in reqs:
            items = collect(r)
            assert items[-1].kind == "done"
            words = _text(items).split()
            assert words[:2] == ["word0", "word1"]
            # The word cursor migrated with the stream: no restart.
            assert words == [f"word{i}" for i in range(len(words))]
        recs = router.journal.tail(None)
        assert any(r["kind"] == "migrate_export" for r in recs)
        assert any(r["kind"] == "migrate_import" for r in recs)
        assert router.migration_count >= 1
        assert check_no_dropped_streams(recs) == []
        _wait_healthy(router)
        assert router.fleet_counts()["healthy"] == 2
    finally:
        router.stop()


def _placed_on_r0(router):
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        placed = [f for f in list(router.flights)
                  if f.member is not None and f.member.name == "r0"
                  and f.attempt is not None and f.attempt.req.generated_ids]
        if placed:
            return placed
        time.sleep(0.01)
    raise AssertionError("no stream mid-generation on r0")


def test_migration_mid_transfer_crash_falls_back_to_recompute():
    """Site "migrate" exception: the first transfer dies mid-flight and
    aborts into recompute replay, paired in the journal, nothing
    dropped."""
    plan = FaultPlan([{"site": "migrate", "kind": "exception", "at": [1]}])
    router = _fake_fleet(n=2, token_latency_s=0.05, plan=plan)
    try:
        reqs = [_run(router, f"ab{i}", max_tokens=16) for i in range(3)]
        _placed_on_r0(router)
        router.drain_replica("r0")
        for r in reqs:
            items = collect(r)
            assert items[-1].kind == "done"
            words = _text(items).split()
            assert words == [f"word{i}" for i in range(len(words))]
        recs = router.journal.tail(None)
        aborts = [r for r in recs if r["kind"] == "migrate_abort"]
        assert aborts and aborts[0]["why"] == "fault_injected"
        assert tm.FLEET_MIGRATIONS_TOTAL.labels(outcome="aborted").value >= 1
        assert check_no_dropped_streams(recs) == []
    finally:
        router.stop()


def test_migration_source_death_after_export_still_lands():
    """Site "migrate" device_loss: the source dies right after the
    export; the import still lands and the commit resolves inline
    against the dead loop."""
    plan = FaultPlan([{"site": "migrate", "kind": "device_loss", "at": [1],
                       "heal_after_s": 0.5}])
    router = _fake_fleet(n=2, token_latency_s=0.05, plan=plan)
    try:
        reqs = [_run(router, f"dl{i}", max_tokens=16) for i in range(3)]
        _placed_on_r0(router)
        router.drain_replica("r0")
        for r in reqs:
            items = collect(r)
            assert items[-1].kind == "done"
            words = _text(items).split()
            assert words == [f"word{i}" for i in range(len(words))]
        recs = router.journal.tail(None)
        assert any(r["kind"] == "migrate_import" for r in recs)
        assert check_no_dropped_streams(recs) == []
    finally:
        router.stop()


def test_affinity_miss_ships_prefix_to_chosen_member():
    """The prefix ships TO the chosen member: its radix tree gains the
    pages, the shipment is journaled and its bytes counted."""
    router = _torch_fleet(n=2, prefix_cache=True)
    try:
        prompt = "shared system preamble for prefix shipping tests ok"
        collect(_run(router, "ps", prompt, max_tokens=4))
        holder = router.journal.tail(None, kind="place")[-1]["runtime"]
        src = next(m for m in router.members if m.name == holder)
        dst = next(m for m in router.members if m.name != holder)
        tokens = router.resolve_runtime("test-tiny").tokenizer.encode(prompt)
        assert src.affinity_pages("test-tiny", tokens) >= 1
        assert dst.affinity_pages("test-tiny", tokens) == 0
        bytes0 = tm.FLEET_MIGRATE_BYTES_TOTAL.value
        flight = type("F", (), {"rid0": 999, "user": "ps", "model":
                      "test-tiny", "kind": "generate",
                      "prompt_tokens": tokens})()
        router._maybe_ship_prefix(flight, dst)
        assert dst.affinity_pages("test-tiny", tokens) >= 1
        ships = [r for r in router.journal.tail(None, kind="migrate_import")
                 if r.get("what") == "prefix"]
        assert ships and ships[-1]["replica"] == holder \
            and ships[-1]["to_replica"] == dst.name
        # The counter counts the shipment's bytes: pages x page bytes.
        rt = dst.engine.runtimes["test-tiny"]
        page_bytes = kvc.kv_page_bytes(rt.cfg, rt.ecfg.page_size,
                                       bytes_per_el=4)
        assert (tm.FLEET_MIGRATE_BYTES_TOTAL.value - bytes0
                == ships[-1]["pages"] * page_bytes == ships[-1]["bytes"])
        _alloc_conserved(router)
        _member_journals_clean(router)
    finally:
        router.stop()


def test_http_member_drain_migrates_over_admin_migrate_wire():
    """An HTTP member's drain rides /admin/migrate end to end: export
    (keyed by the frames' req_id), import (200 ack + NDJSON
    continuation), commit; the word cursor continues with no recompute."""
    router, backends = _http_fleet(eject_heartbeat_s=2.0,
                                   migrate_timeout_s=10.0)
    try:
        req = _run(router, "hm", "migrate me over http", max_tokens=16)
        mem = _serving_member(router, req)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            f = next((f for f in list(router.flights) if f.req is req), None)
            if f is not None and f.attempt is not None \
                    and f.attempt.member_rid is not None \
                    and f.attempt.n_items >= 2:
                break
            time.sleep(0.01)
        router.drain_replica(mem.name)
        items = collect(req, timeout=60)
        assert items[-1].kind == "done"
        assert _text(items).split() == [f"word{i}" for i in range(16)]
        recs = router.journal.tail(None)
        migrated = [r for r in recs if r["kind"] == "migrate_import"
                    and r.get("what") != "prefix"]
        assert migrated and migrated[-1]["replica"] == mem.name
        assert migrated[-1]["tokens"] >= 2  # resumed mid-stream
        assert router.migration_count >= 1
        assert check_no_dropped_streams(recs) == []
    finally:
        router.stop()
        for b in backends:
            b.stop()


def test_migration_blob_wire_roundtrip():
    blob = {"version": 1, "kind": "stream", "kv_len": 9,
            "request": {"user": "u", "generated_ids": [1, 2, 3]},
            "k_pages": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
            "recent": np.full((8,), -1, np.int32),
            "_inc_decode": object()}  # in-process only: dropped on pack
    out = kvc.unpack_migration_blob(kvc.pack_migration_blob(blob))
    assert out["kv_len"] == 9 and out["request"]["generated_ids"] == [1, 2, 3]
    assert np.array_equal(out["k_pages"], blob["k_pages"])
    assert np.array_equal(out["recent"], blob["recent"])
    assert "_inc_decode" not in out
    with pytest.raises(ValueError):
        kvc.unpack_migration_blob(b"not a blob")
    # bf16 (no numpy dtype) crosses as a uint8 view with its name in the
    # header, and unpacks to a torch bf16 tensor, bit for bit.
    bf = torch.arange(8, dtype=torch.float32).to(torch.bfloat16).reshape(2, 4)
    raw = kvc.pack_migration_blob({"kind": "stream", "k_pages": bf})
    out = kvc.unpack_migration_blob(raw)
    assert out["k_pages"].dtype == torch.bfloat16
    assert torch.equal(out["k_pages"], bf)
    # The counted bytes are every array's, as the JAX package counts
    # them: the page payload and the penalty-ring row.
    assert kvc.migration_blob_bytes({
        "k_pages": bf, "k_scale": np.zeros(3, np.float32),
        "recent": np.zeros(64, np.int32), "kv_len": 7}) == 16 + 12 + 256


def test_no_dropped_streams_checker_pairs_migrations():
    clean = [
        {"kind": "migrate_export", "req_id": 4, "seq": 1, "tokens": 2},
        {"kind": "migrate_import", "req_id": 4, "seq": 2},
        {"kind": "finish", "req_id": 4, "seq": 3, "reason": "length"},
    ]
    assert check_no_dropped_streams(clean) == []
    aborted = [
        {"kind": "migrate_export", "req_id": 5, "seq": 1, "tokens": 2},
        {"kind": "migrate_abort", "req_id": 5, "seq": 2, "why": "t"},
        {"kind": "replica_failover", "req_id": 5, "seq": 3},
        {"kind": "finish", "req_id": 5, "seq": 4, "reason": "stop"},
    ]
    assert check_no_dropped_streams(aborted) == []
    bad = check_no_dropped_streams(
        [{"kind": "migrate_export", "req_id": 6, "seq": 1, "tokens": 2}])
    assert len(bad) == 2
    assert any("DROPPED" in b for b in bad)
    assert any("ORPHANED" in b for b in bad)
    bad = check_no_dropped_streams([
        {"kind": "migrate_export", "req_id": 7, "seq": 1, "tokens": 2},
        {"kind": "migrate_import", "req_id": 7, "seq": 2},
    ])
    assert len(bad) == 1 and "DROPPED" in bad[0]


def test_cancel_mid_stream_releases_fleet_state():
    router = _fake_fleet(n=2, token_latency_s=0.05)
    try:
        req = _run(router, "cx", max_tokens=64)
        _serving_member(router, req)
        router.cancel(req.req_id)
        items = collect(req)
        assert items[-1].finish_reason == FinishReason.CANCELLED
        deadline = time.monotonic() + 10
        while router.flights and time.monotonic() < deadline:
            time.sleep(0.02)
        assert not router.flights
    finally:
        router.stop()


# ---------------------------------------------------------- the body cap
def test_body_over_max_body_is_refused_413_unread():
    """A Content-Length past MAX_BODY (1 GB) is answered 413 from the
    headers alone: the server neither waits for nor allocates the body,
    and a normal request on a new connection still serves."""
    eng = FakeEngine(EngineConfig(**TINY), blocklist_path=None)
    srv = serve_in_thread(eng)
    port = srv.server_address[1]
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
            s.sendall((f"POST /admin/migrate/import HTTP/1.1\r\n"
                       f"Host: x\r\nContent-Length: {MAX_BODY + 1}\r\n"
                       f"Content-Type: application/octet-stream\r\n\r\n"
                       ).encode())
            t0 = time.monotonic()
            reply = b""
            while b"\r\n\r\n" not in reply:
                chunk = s.recv(4096)
                if not chunk:
                    break
                reply += chunk
            assert time.monotonic() - t0 < 5.0  # answered, not awaited
        assert reply.startswith(b"HTTP/1.1 413"), reply[:80]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/health", timeout=10) as resp:
            assert resp.status == 200
    finally:
        stop_server(srv)


def test_streamed_reply_names_its_request_id_before_any_frame():
    """A streamed reply's X-Request-ID header is the req_id its frames
    carry, so an HTTP member's stream is exportable before its first text
    frame (random-weight ids often decode to no text at all)."""
    eng = FakeEngine(EngineConfig(**TINY), blocklist_path=None)
    srv = serve_in_thread(eng)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with _post(url + "/api/generate",
                   {"model": "test-tiny", "prompt": "hi",
                    "options": {"num_predict": 3}}) as resp:
            hdr = resp.headers.get("X-Request-ID")
            frames = [json.loads(x) for x in resp if x.strip()]
        assert hdr is not None
        assert {f["req_id"] for f in frames} == {int(hdr)}
    finally:
        stop_server(srv)
