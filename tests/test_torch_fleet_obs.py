"""The port's fleet observability plane against the JAX package's tests.

The mirror of tests/test_fleet_obs.py over the port's FleetRouter, plus
the federation case of tests/test_stepprof.py: distributed tracing (one
stitched timeline per stream across the router and member processes),
metrics federation (member series re-exported with a replica label),
and the router-overhead self-profiler. The contract: a stream placed by
the router, served by an HTTP member and failed over to a second one
still reads as ONE timeline at /debug/trace/{rid}, whose fleet-wide
phase sum equals the client-observed end-to-end wall clock.
"""

import importlib.util
import json
import os
import re
import time
import urllib.error
import urllib.request

import pytest

from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine.fake import FakeEngine
from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
from ollamamq_tpu_torch.telemetry import REGISTRY, tracing
from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.telemetry.stepprof import PROFILER
from test_torch_fleet import TINY, _fake_fleet, _http_fleet, _run, _text
from testutil import collect

TOL_MS = 0.5  # float noise on phase-sum == e2e (ms)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _place_count() -> int:
    return tm.ROUTER_OVERHEAD_MS.labels(site="place").count


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, json.loads(resp.read())


def _wait(cond, budget=30.0, msg="condition"):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise TimeoutError(f"timed out waiting for {msg}")


# ------------------------------------------------------------ trace context
def test_ctx_mint_and_validate():
    ctx = tracing.mint_ctx()
    assert tracing.valid_ctx(ctx)
    assert not tracing.valid_ctx("nope")
    assert not tracing.valid_ctx(None)
    assert not tracing.valid_ctx("00-xyz-abc-01")


def test_trace_ctx_propagates_in_process_and_stitches():
    """In-process members trace under the router's fleet context
    (un-metered), and the merged timeline's phase sum equals the
    router-observed e2e."""
    router = _fake_fleet(n=2, token_latency_s=0.01)
    try:
        req = _run(router, "tr-local", "trace me please", max_tokens=6)
        rid = req.req_id
        assert collect(req)[-1].kind == "done"
        root = router.tracer.find(rid)
        assert root is not None and tracing.valid_ctx(root.ctx)
        member_spans = []
        for mem in router.members:
            member_spans += mem.trace_spans(root.ctx)
        assert member_spans, "no member-side spans for the fleet ctx"
        assert all(s["origin"] in ("r0", "r1") for s in member_spans)
        for mem in router.members:
            for tr in mem.engine.tracer.find_ctx(root.ctx):
                assert tr.metered is False
        spans = router.fleet_trace_spans(rid)
        assert {s["origin"] for s in spans} >= {"router"}
        st = tracing.merged_chrome(spans, root_origin="router")["stitched"]
        assert st["outcome"] in ("stop", "length")
        assert st["e2e_ms"] > 0
        assert abs(st["phase_sum_ms"] - st["e2e_ms"]) < TOL_MS
        assert "router" in st["origins"]
        assert st["phases_ms"].get("decode", 0) > 0
    finally:
        router.stop()


def test_debug_trace_rid_http_and_failover_keeps_trace_whole():
    """A stream placed by the router and failed over mid-decode to a
    second HTTP member shows ONE merged trace whose phase sum equals the
    client-observed e2e; GET /debug/trace/{rid} on the router serves it."""
    router, backends = _http_fleet()
    srv = serve_in_thread(router)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        t0 = time.monotonic()
        req = _run(router, "tr-kill", "trace the victim", max_tokens=16)
        rid = req.req_id
        deadline = time.monotonic() + 30
        victim = None
        while time.monotonic() < deadline:
            f = next((f for f in list(router.flights) if f.req is req), None)
            if f is not None and f.attempt is not None \
                    and f.attempt.n_items >= 2:
                victim = f.member
                break
            time.sleep(0.01)
        assert victim is not None
        backends[int(victim.name[1])].stop()
        items = collect(req, timeout=60)
        e2e_observed_ms = (time.monotonic() - t0) * 1e3
        assert items[-1].kind == "done"
        assert _text(items) == "".join(f"word{i} " for i in range(16))
        assert router.failover_count >= 1
        spans = router.fleet_trace_spans(rid)
        origins = {s["origin"] for s in spans}
        survivor = f"h{1 - int(victim.name[1])}"
        assert "router" in origins
        assert survivor in origins, f"no spans from {survivor}: {origins}"
        merged = tracing.merged_chrome(spans, root_origin="router")
        st = merged["stitched"]
        assert st["outcome"] in ("stop", "length")
        assert abs(st["phase_sum_ms"] - st["e2e_ms"]) < TOL_MS
        assert st["e2e_ms"] <= e2e_observed_ms + TOL_MS
        names = [e["name"] for e in st["events"]]
        assert "failover" in names or "migrate" in names
        assert "first_token" in names
        assert len({e["tid"] for e in merged["traceEvents"]}) >= 2
        # The same stitched timeline over the router's route.
        status, body = _get(f"{url}/debug/trace/{rid}")
        assert status == 200
        assert survivor in body["stitched"]["origins"]
    finally:
        stop_server(srv)
        for b in backends:
            b.stop()


def test_traceparent_header_adopted_by_member_server():
    """The member's server adopts a propagated traceparent: the wire
    contract HttpMember relies on for stitching."""
    eng = FakeEngine(EngineConfig(**TINY), blocklist_path=None)
    srv = serve_in_thread(eng)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    ctx = tracing.mint_ctx()
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url + "/api/generate", data=json.dumps({
                    "model": "test-tiny", "prompt": "hello", "stream": False,
                    "options": {"num_predict": 3}}).encode(),
                headers={tracing.TRACEPARENT_HEADER: ctx}), timeout=30) as r:
            assert r.status == 200
            json.loads(r.read())
        status, body = _get(f"{url}/debug/trace?ctx={ctx}")
        assert status == 200
        assert body["ctx"] == ctx
        assert len(body["spans"]) == 1
        assert body["spans"][0]["ctx"] == ctx
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{url}/debug/trace?ctx=garbage",
                                   timeout=10)
        assert ei.value.code == 400
    finally:
        stop_server(srv)


# --------------------------------------------------------------- federation
def test_metrics_federation_replica_labels_under_eject_rejoin():
    """Member series re-export with a replica label; an ejected member
    drops out of the exposition and returns on rejoin."""
    router, backends = _http_fleet(reprobe_backoff_s=0.1)
    members = router.members
    srv = serve_in_thread(router)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        _wait(lambda: all(m.metric_snapshot() for m in members),
              msg="member metric snapshots")
        fed = router.member_metric_federation()
        assert {name for name, _ in fed} == {"h0", "h1"}
        text = REGISTRY.render(federated=fed)
        assert 'replica="h0"' in text and 'replica="h1"' in text
        m = re.search(r'^(ollamamq_[a-z0-9_]+?)(?:_bucket|_sum|_count)?'
                      r'\{[^}]*replica="h0"', text, re.M)
        assert m, "no federated series found"
        assert text.count(f"# TYPE {m.group(1)} ") == 1
        # The router's /metrics route federates too.
        with urllib.request.urlopen(url + "/metrics", timeout=10) as resp:
            assert 'replica="h1"' in resp.read().decode()
        members[0].crash()
        _wait(lambda: members[0].state == "ejected", msg="h0 eject")
        text = REGISTRY.render(federated=router.member_metric_federation())
        assert 'replica="h0"' not in text
        assert 'replica="h1"' in text
        _wait(lambda: members[0].state == "healthy", budget=60,
              msg="h0 rejoin")
        _wait(lambda: any(n == "h0" for n, _ in
                          router.member_metric_federation()),
              msg="h0 snapshot back")
        text = REGISTRY.render(federated=router.member_metric_federation())
        assert 'replica="h0"' in text
    finally:
        stop_server(srv)
        for b in backends:
            b.stop()


def test_federation_exposes_per_replica_step_series():
    """(tests/test_stepprof.py's federation case) HTTP members federate
    their step-phase series into the router's exposition."""
    router, backends = _http_fleet(reprobe_backoff_s=0.1)
    try:
        items = collect(_run(router, "fed-user"))
        assert items[-1].kind == "done", items[-1].error
        assert PROFILER.seq > 0, "fake member steps recorded no samples"

        def federated_step_series():
            fed = router.member_metric_federation()
            if {name for name, _ in fed} != {"h0", "h1"}:
                return False
            text = REGISTRY.render(federated=fed)
            return re.search(r'^ollamamq_step_phase_ms[^\n]*replica="h[01]"',
                             text, re.M) is not None

        _wait(federated_step_series, msg="federated step-phase series")
    finally:
        router.stop()
        for b in backends:
            b.stop()


def test_federation_off_switch():
    router = _fake_fleet(n=2)
    try:
        router.ecfg.federate_metrics = False
        assert router.member_metric_federation() == []
    finally:
        router.stop()


# ---------------------------------------------------------- router overhead
def test_router_overhead_histogram_journal_and_alert():
    """Every placement lands in ollamamq_router_overhead_ms{site=place}
    and on its place record; the windowed p99 feeds stats and the health
    monitor's overhead-storm alert (fires over budget, resolves under)."""
    before = _place_count()
    router = _fake_fleet(n=2)
    try:
        for r in [_run(router, f"ov{i}", max_tokens=4) for i in range(4)]:
            collect(r)
        assert _place_count() > before
        places = router.journal.tail(None, kind="place")
        assert places and any(p.get("overhead_ms") is not None
                              for p in places)
        p99 = router.router_overhead_p99_ms()
        assert p99 is not None and p99 >= 0
        stats = router.stats()["fleet"]["router_overhead"]
        assert stats["sites"]["place"]["count"] > 0
        assert stats["place_p99_ms"] is not None
        assert stats["budget_ms"] == router.ecfg.router_overhead_budget_ms
        assert tm.ROUTER_OVERHEAD_MS.labels(site="journal").count > 0
        router.ecfg.router_overhead_budget_ms = 1e-9
        router.health.check_once()
        assert any(a.name == "router_overhead"
                   for a in router.alerts.active())
        router.ecfg.router_overhead_budget_ms = 1e9
        router.health.check_once()
        assert not any(a.name == "router_overhead"
                       for a in router.alerts.active())
    finally:
        router.stop()


# ------------------------------------------------- /debug endpoints + WAL
def test_debug_trace_rid_and_wal_cross_links_over_http():
    """One engine's /debug/trace/{rid} (a one-process stitch), and
    /debug/requests cross-linking wal_rid both ways."""
    eng = FakeEngine(EngineConfig(**TINY), blocklist_path=None)
    srv = serve_in_thread(eng)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        req = _run(eng, "walx", "cross link me", max_tokens=4)
        rid = req.req_id
        collect(req)
        status, merged = _get(f"{url}/debug/trace/{rid}")
        assert status == 200
        st = merged["stitched"]
        assert abs(st["phase_sum_ms"] - st["e2e_ms"]) < TOL_MS
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{url}/debug/trace/999999", timeout=10)
        assert ei.value.code == 404
        old = 999001
        eng.journal.record("recover_replay", req_id=rid, user="walx",
                           tokens=2, outcome="replayed", wal_rid=old)
        _, body = _get(f"{url}/debug/requests/{rid}")
        assert body["wal_rid"] == old
        assert body["pre_crash_timeline"] == f"/debug/requests/{old}"
        status, body = _get(f"{url}/debug/requests/{old}")
        assert status == 200
        assert body["state"] == "recovered" and body["recovered_as"] == rid
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{url}/debug/requests/424242", timeout=10)
        assert ei.value.code == 404
    finally:
        stop_server(srv)


def test_router_debug_bundle_gathers_member_sections():
    router = _fake_fleet(n=2)
    srv = serve_in_thread(router)
    try:
        collect(_run(router, "bun", max_tokens=3))
        _, bundle = _get(f"http://127.0.0.1:{srv.server_address[1]}"
                         "/debug/bundle")
        assert set(bundle["members"]) == {"r0", "r1"}
        for row in bundle["members"].values():
            assert row.get("kind") == "local"
            assert "stats" in row and "journal" in row
        assert "router_overhead" in bundle["fleet"]
    finally:
        stop_server(srv)


# ------------------------------------------------------------ journal merge
def test_journal_merge_interleaves_fleet_spills(tmp_path):
    from ollamamq_tpu_torch.telemetry.journal import Journal, load_jsonl
    from ollamamq_tpu_torch.tools import journal as tools

    ra, rb = str(tmp_path / "router.jsonl"), str(tmp_path / "member.jsonl")
    ja = Journal(capacity=64, path=ra)
    jb = Journal(capacity=64, path=rb)
    ja.record("enqueue", req_id=1, user="u", n_prompt=4, queued=1)
    jb.record("install", req_id=101, user="u", slot=0)
    ja.record("admit", req_id=1, user="u", queued=0)
    time.sleep(1.2)  # >> MERGE_TICK_S * MAX_ARRIVAL_GAP_TICKS
    jb.record("finish", req_id=101, user="u", reason="stop", tokens=2)
    ja.record("finish", req_id=1, user="u", reason="stop", tokens=2)
    ja.close()
    jb.close()
    meta, merged = tools.merge_journals([ra, rb])
    assert [s["file"] for s in meta["merged_from"]] == ["router.jsonl",
                                                        "member.jsonl"]
    assert [r["seq"] for r in merged] == list(range(5))
    ts = [r["t"] for r in merged]
    assert ts == sorted(ts)
    assert {r["src"] for r in merged} == {"router.jsonl", "member.jsonl"}
    assert all("src_seq" in r and "src_tick" in r for r in merged)
    ticks = [r["tick"] for r in merged]
    assert ticks == sorted(ticks)
    assert max(ticks) <= tools.MAX_ARRIVAL_GAP_TICKS + 4
    out = str(tmp_path / "merged.jsonl")
    assert tools.main(["merge", "--out", out, ra, rb]) == 0
    m2, recs = load_jsonl(out)
    assert len(recs) == 5 and m2["merged_from"][0]["file"] == "router.jsonl"
    assert tools.main(["tail", out, "--kind", "finish", "--n", "0"]) == 0
    assert tools.main(["explain", out]) == 0
    assert tools.main(["stats", out]) == 0


# ------------------------------------------------------------ doc gate
def test_router_span_vocabulary_is_doc_gated(tmp_path):
    """The README's router-span table (pinned to the JAX package by
    scripts/check_metrics_docs.py) names exactly the port's
    ROUTER_EVENTS, and the script's parser catches a missing and a ghost
    row."""
    spec = importlib.util.spec_from_file_location(
        "check_metrics_docs",
        os.path.join(REPO, "scripts", "check_metrics_docs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as f:
        full = f.read()
    assert mod.documented_router_spans(full) == set(tracing.ROUTER_EVENTS)
    missing = full.replace("| `failover` |", "| failover-less |", 1)
    assert mod.documented_router_spans(missing) != set(tracing.ROUTER_EVENTS)
    ghost = full.replace(mod.ROUTER_SPANS_END,
                         "| `notaspan` | bogus |\n" + mod.ROUTER_SPANS_END, 1)
    assert mod.documented_router_spans(ghost) != set(tracing.ROUTER_EVENTS)
