"""The port's decision journal against the JAX package's, on the CPU.

The mirror of tests/test_journal.py (every test that needs no fleet), on
the port's Journal, its ModelRuntime (the ragged path), its FakeEngine
and its stdlib server:
  - the ring stays O(capacity), the schema is loud, every kind records
    and explains, the tail filters, the spill rotates;
  - a seeded chaos run recorded by the port's tool replays with an
    identical decision sequence, and a tampered recording is caught;
  - the invariant checker catches each violation class and stays clean
    over randomized overload traffic on a real runtime;
  - /debug/journal's filters, the journal slice of /debug/requests/{id},
    the bundle's journal section, the cold-start Retry-After clamp, the
    health monitor's invariant alert, the audit and signature shapes.
Beyond the mirror:
  - the vocabulary, field sets, decision kinds and explanations are the
    JAX module's;
  - the port's runtime and the JAX runtime, driven tick by tick under
    preemption, prefix-cache hits and speculation (test-tiny, float32,
    weights bridged), journal the same records at every tick: the same
    decision_signature and the same page post-states, and
    check_invariants is clean on both;
  - a trace recorded by the JAX tool replays identically under the
    port's, and the reverse; `simulate --scheduler srpt` gives the same
    signature digest under both tools.
"""

import glob
import hashlib
import itertools
import json
import os
import random
import urllib.error
import urllib.request

import numpy as np
import pytest

from ollamamq_tpu.core import MQCore as JaxMQCore
from ollamamq_tpu.engine.request import Request as JaxRequest
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu.telemetry import journal as jax_journal
from ollamamq_tpu.tools import journal as jax_tool
from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.core.mqcore import MQCore
from ollamamq_tpu_torch.engine.engine import ModelRuntime, drop_expired
from ollamamq_tpu_torch.engine.fake import FakeEngine
from ollamamq_tpu_torch.engine.request import Request
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
from ollamamq_tpu_torch.telemetry.journal import (DECISION_KINDS, EVENT_FIELDS,
                                                  EVENTS, Journal, JournalError,
                                                  batch_stats, check_invariants,
                                                  decision_signature, explain,
                                                  fair_share_audit, load_jsonl)
from ollamamq_tpu_torch.tools import journal as tool
from ollamamq_tpu_torch.tools.journal import record_chaos, replay_journal

from test_journal import _MINIMAL
from test_torch_prefix_cache import jax_runtime, tick, torch_runtime
from test_torch_spec import SPEC, _mixed_prompts

_IDS = itertools.count(1)
PAGE_KINDS = ("page_alloc", "page_free", "page_evict", "spec_rollback")


# ------------------------------------------------------------------ schema
def test_vocabulary_is_the_jax_modules():
    assert EVENTS == jax_journal.EVENTS
    assert EVENT_FIELDS == jax_journal.EVENT_FIELDS
    assert DECISION_KINDS == jax_journal.DECISION_KINDS
    for kind, fields in _MINIMAL.items():
        rec = {"seq": 0, "t": 0.0, "tick": 0, "kind": kind, "req_id": 3,
               "user": "bob", "model": "m", **fields}
        assert explain(rec) == jax_journal.explain(rec)


def test_ring_stays_bounded():
    j = Journal(capacity=64)
    for i in range(1000):
        j.record("admit", req_id=i, user="u", queued=i)
    snap = j.snapshot()
    assert snap["size"] == 64 and snap["seq"] == 1000 and snap["evicted"] == 936
    assert len(j.tail(None)) == 64
    assert j.tail(None)[-1]["req_id"] == 999
    assert j.tail(None)[0]["req_id"] == 936


def test_schema_validation_is_loud():
    j = Journal(capacity=8)
    with pytest.raises(JournalError):
        j.record("warp_speed", req_id=1)
    with pytest.raises(JournalError):
        j.record("shed", user="u")  # missing required 'reason'
    with pytest.raises(JournalError):
        j.record("admit", queued=1, bogus_field=2)  # unknown field
    assert j.seq == 0  # rejected records never land


def test_every_kind_records_and_explains():
    assert set(_MINIMAL) == set(EVENTS)
    j = Journal(capacity=64)
    for kind, fields in _MINIMAL.items():
        rec = j.record(kind, req_id=3, user="bob", model="m", **fields)
        assert isinstance(explain(rec), str) and explain(rec)
    assert j.seq == len(EVENTS)
    # The TUI line tracks the newest decision kind; page bookkeeping
    # does not displace it.
    assert "stale-epoch router call fenced" in j.last_summary()
    j.record("page_alloc", model="m", n=1, free=9, used=21, cached=1, pool=31)
    assert "stale-epoch router call fenced" in j.last_summary()


def test_tail_filters():
    j = Journal(capacity=128)
    for i in range(10):
        j.record("admit", req_id=i, user=f"u{i % 2}", queued=i)
    j.record("shed", user="u0", reason="queue_full", queued=9, limit=9)
    assert len(j.tail(n=3)) == 3
    assert all(r["user"] == "u1" for r in j.tail(None, user="u1"))
    assert len(j.tail(None, user="u1")) == 5
    assert [r["kind"] for r in j.tail(None, kind="shed")] == ["shed"]
    assert len(j.tail(None, req_id=7)) == 1


def test_journal_file_rotation(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = Journal(capacity=32, path=path, rotate_bytes=4000, keep=2)
    for i in range(400):
        j.record("admit", req_id=i, user="u", queued=i)
    j.close()
    files = sorted(glob.glob(path + "*"))
    assert path in files and len(files) <= 3
    assert any(f.endswith(".1") for f in files)
    for f in files:
        assert os.path.getsize(f) < 4000 + 500  # one record of slack
    _meta, records = load_jsonl(path)
    assert records and all(r["kind"] == "admit" for r in records)
    _meta1, recs1 = load_jsonl(files[-1] if files[-1] != path else files[0])
    assert recs1


# ---------------------------------------------------- record/replay loop
def test_chaos_record_replays_deterministically(tmp_path):
    path = str(tmp_path / "chaos.jsonl")
    journal = record_chaos(path, seed=7, requests=32)
    kinds = {r["kind"] for r in journal.tail(None)}
    assert {"enqueue", "admit", "place", "install", "finish",
            "shed", "retry", "poison"} <= kinds
    for r in journal.tail(None, kind="shed"):
        assert r["queued"] >= r["limit"] and "retry_after_s" in r
    assert check_invariants(journal.tail(None)) == []
    ok, rec_sig, rep_sig, div = replay_journal(path)
    assert ok, f"diverged at {div}: {rec_sig[div:div+2]} vs {rep_sig[div:div+2]}"
    assert len(rec_sig) > 50


def test_replay_detects_tampered_recording(tmp_path):
    path = str(tmp_path / "chaos.jsonl")
    record_chaos(path, seed=3, requests=24)
    lines = open(path, encoding="utf-8").read().splitlines()
    for i, line in enumerate(lines):
        obj = json.loads(line)
        if obj.get("kind") == "finish":
            obj["reason"] = ("cancelled" if obj["reason"] != "cancelled"
                             else "length")
            lines[i] = json.dumps(obj)
            break
    open(path, "w", encoding="utf-8").write("\n".join(lines) + "\n")
    ok, _rec, _rep, div = replay_journal(path)
    assert not ok and div is not None


@pytest.mark.parametrize("seed,trace", [(5, "chaos"), (2, "bimodal")])
def test_traces_replay_across_packages(tmp_path, seed, trace):
    """The JAX tool's recording replays under the port's tool and the
    port's under the JAX tool; the two recordings are the same records
    (their monotonic clocks aside)."""
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    jax_tool.record_chaos(jpath, seed=seed, requests=32, trace=trace)
    record_chaos(tpath, seed=seed, requests=32, trace=trace)
    ok, rec_sig, _rep, div = replay_journal(jpath)
    assert ok and len(rec_sig) > 50, div
    ok, _rec, _rep, div = jax_tool.replay_journal(tpath)
    assert ok, div

    def strip(path):
        return [{k: v for k, v in r.items() if k != "t"}
                for r in load_jsonl(path)[1]]

    assert strip(tpath) == strip(jpath)
    assert tool.main(["replay", jpath]) == 0
    assert jax_tool.main(["replay", tpath]) == 0


def test_simulate_srpt_digest_matches_jax(tmp_path, capsys):
    path = str(tmp_path / "bimodal.jsonl")
    jax_tool.record_chaos(path, seed=4, requests=40, trace="bimodal")
    digests = []
    for mod in (tool, jax_tool):
        assert mod.main(["simulate", path, "--scheduler", "srpt"]) == 0
        first = capsys.readouterr().out.splitlines()[0]
        digests.append(first.rsplit(" ", 1)[-1])
        _rec, sim = mod.simulate_journal(path, "srpt")
        digests.append(hashlib.sha256(repr(decision_signature(sim)).encode())
                       .hexdigest()[:16])
    assert len(set(digests)) == 1, digests


def test_tool_commands_on_a_spill(tmp_path, capsys):
    """tail / explain / stats / merge / check over a recorded spill."""
    path = str(tmp_path / "chaos.jsonl")
    record_chaos(path, seed=1, requests=16)
    capsys.readouterr()
    assert tool.main(["tail", path, "--kind", "shed", "--n", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert 1 <= len(lines) <= 2 and all(json.loads(x)["kind"] == "shed"
                                        for x in lines)
    assert tool.main(["explain", path, "--n", "3"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 3
    assert tool.main(["stats", path]) == 0
    out = capsys.readouterr().out
    assert "batch stats:" in out and "fair-share audit" in out
    merged = str(tmp_path / "merged.jsonl")
    assert tool.main(["merge", path, path, "--out", merged]) == 0
    _meta, recs = load_jsonl(merged)
    assert len(recs) == 2 * len(load_jsonl(path)[1])
    assert tool.main(["check", path]) == 0


# ------------------------------------------------------------ invariants
def test_invariant_checker_catches_each_class():
    bad = check_invariants([
        {"seq": 0, "kind": "page_alloc", "n": 2, "free": 5, "used": 5,
         "cached": 0, "pool": 31}])
    assert len(bad) == 1 and "not conserved" in bad[0]
    bad = check_invariants([
        {"seq": 0, "kind": "install", "model": "m", "slot": 1, "req_id": 1},
        {"seq": 1, "kind": "install", "model": "m", "slot": 1, "req_id": 2}])
    assert len(bad) == 1 and "double-assignment" in bad[0]
    assert check_invariants([
        {"seq": 0, "kind": "install", "model": "m", "slot": 1, "req_id": 1},
        {"seq": 1, "kind": "finish", "model": "m", "slot": 1, "req_id": 1,
         "reason": "stop"},
        {"seq": 2, "kind": "install", "model": "m", "slot": 1,
         "req_id": 2}]) == []
    bad = check_invariants([
        {"seq": 0, "kind": "preempt", "req_id": 4, "user": "alice",
         "slot": 0, "why": "kv_pressure", "vip": "alice"}])
    assert len(bad) == 1 and "VIP" in bad[0]
    assert check_invariants([
        {"seq": 0, "kind": "preempt", "req_id": 4, "user": "bob",
         "slot": 0, "why": "kv_pressure", "vip": "alice"}]) == []
    bad = check_invariants([
        {"seq": 0, "kind": "shed", "user": "u", "reason": "queue_full",
         "queued": 3, "limit": 8}])
    assert len(bad) == 1 and "below bound" in bad[0]
    recs = [{"seq": 0, "kind": "admit", "req_id": 9, "queued": 1}]
    recs += [{"seq": 1 + i, "kind": "batch", "slots": [0], "bucket": 32,
              "batch_size": 1, "tokens": 8, "occupancy": 0.5}
             for i in range(60)]
    bad = check_invariants(recs)
    assert len(bad) == 1 and "starved" in bad[0]
    assert bad == jax_journal.check_invariants(recs)
    recs.insert(30, {"seq": 99, "kind": "install", "req_id": 9, "slot": 0})
    assert check_invariants(recs) == []


@pytest.mark.parametrize("seed", [0, 1])
def test_invariant_fuzz_randomized_overload(seed):
    """Randomized arrival storms over an undersized pool with injected
    allocation pressure on the port's runtime (the ragged path):
    preemptions, kv_stalls and evictions fire, and the journal comes out
    invariant-clean."""
    from ollamamq_tpu_torch.testing.faults import FaultPlan

    rng = random.Random(seed)
    rt = ModelRuntime("test-tiny", _tiny_cfg(), EngineConfig(
        model="test-tiny", max_slots=3, num_pages=24, page_size=8,
        max_pages_per_seq=8, max_new_tokens=8, decode_steps_per_iter=2,
        max_batch_tokens=32, token_granule=8, preempt=True, preempt_max=1,
        prefix_cache=True),
        device="cpu")
    rt.tokenizer.eos_id = -1  # deterministic full-length streams
    rt.fault_plan = FaultPlan([{"site": "extend", "kind": "alloc_fail",
                                "every": 4}], seed=seed)
    journal = Journal(capacity=8192)
    rt.journal = journal
    core = MQCore(None)

    def requeue(req):
        if req.expired():
            drop_expired(req, core, rt.name, journal=journal)
            return False
        rt.pending_prefill.appendleft(req)
        return True

    rt.on_preempt = requeue
    issued, reqs, guard = 0, [], 0
    while True:
        while issued < 14 and len(rt.pending_prefill) < 6 and rng.random() < 0.7:
            n = rng.randrange(4, 40)
            req = Request(next(_IDS), f"u{issued % 4}", rt.name,
                          [rng.randrange(3, 400) for _ in range(n)],
                          SamplingParams(max_tokens=rng.randrange(2, 10)))
            rt.submit(req)
            reqs.append(req)
            issued += 1
        if not rt.step_ragged(core) and any(r is not None for r in rt.slot_req):
            rt.step_decode(core, k_steps=2)
        if issued >= 14 and all(r.stats.finished_at for r in reqs):
            break
        guard += 1
        assert guard < 20000, "overload fuzz wedged"
    recs = journal.tail(None)
    kinds = {r["kind"] for r in recs}
    assert {"batch", "install", "finish", "page_alloc", "page_free",
            "preempt", "kv_stall"} <= kinds
    assert check_invariants(recs) == []
    bs = batch_stats(recs)
    assert bs["batches"] > 0 and 0.0 <= bs["padding_waste"] < 1.0
    assert bs["real_tokens"] <= bs["padded_tokens"]


def _tiny_cfg():
    from ollamamq_tpu_torch.config import MODEL_CONFIGS

    return MODEL_CONFIGS["test-tiny"]


# --------------------------------------------- lockstep against JAX
def _journaled_drive(rt, core, journal, make_req, prompts, max_ticks=8000):
    """test_torch_prefix_cache.drive with the journal's tick set to the
    drive's tick, so records compare tick by tick."""
    rt.journal = journal
    rt.on_preempt = lambda req: (rt.pending_prefill.appendleft(req), True)[1]
    reqs = []
    for i, p in enumerate(prompts):
        req = make_req(next(_IDS), f"u{i % 3}", list(p))
        req._inc_decode = rt.tokenizer.make_incremental_decoder()
        rt.pending_prefill.append(req)
        reqs.append(req)
    for t in range(max_ticks):
        if all(r.stats.finished_at for r in reqs):
            break
        journal.tick = t
        tick(rt, core)
    assert all(r.stats.finished_at for r in reqs), "requests wedged"
    return [list(r.generated_ids) for r in reqs], journal.tail(None)


def _by_tick(records):
    out = {}
    for r in records:
        out.setdefault(r["tick"], []).append(r)
    return out


def _page_post(records):
    return [(r["kind"], r.get("n", r.get("freed")), r.get("slot"), r["free"],
             r["used"], r["cached"], r["pool"])
            for r in records if r["kind"] in PAGE_KINDS]


def test_runtime_journal_matches_jax_tick_by_tick():
    """The pressured speculation scenario of test_torch_spec.py (prefix
    cache on, a 19-page pool): per tick the two runtimes journal the
    same decision_signature and the same page post-states; every record
    is field-for-field equal but for its clock."""
    prompts = _mixed_prompts(np.random.default_rng(31), 4)
    kw = dict(SPEC, num_pages=20, retry_backoff_s=0.0, prefix_cache=True)
    jrt = jax_runtime(spec=True, **kw)
    trt = torch_runtime(jrt, spec=True, **kw)
    base = next(_IDS) + 1000
    jids = itertools.count(base)
    tids = itertools.count(base)
    want, jrecs = _journaled_drive(
        jrt, JaxMQCore(None), jax_journal.Journal(capacity=100000),
        lambda _rid, u, p: JaxRequest(next(jids), u, "test-tiny", p,
                                      JaxSampling(max_tokens=32)), prompts)
    got, trecs = _journaled_drive(
        trt, MQCore(None), Journal(capacity=100000),
        lambda _rid, u, p: Request(next(tids), u, "test-tiny", p,
                                   SamplingParams(max_tokens=32)), prompts)
    assert got == want
    # The JAX runtime also journals `compile` (a jit cache filled for a
    # new shape); eager PyTorch compiles nothing per shape, so those
    # records are left out of the comparison, and `seq` with them.
    jrecs = [r for r in jrecs if r["kind"] != "compile"]
    kinds = {r["kind"] for r in trecs}
    assert {"preempt", "spec_verify", "spec_rollback", "page_evict",
            "page_alloc", "page_free", "install", "finish", "batch"} <= kinds
    jt, tt = _by_tick(jrecs), _by_tick(trecs)
    assert sorted(jt) == sorted(tt)
    for t in sorted(tt):
        assert decision_signature(tt[t]) == jax_journal.decision_signature(jt[t]), t
        assert _page_post(tt[t]) == _page_post(jt[t]), t
    def strip(recs):
        return [{k: v for k, v in r.items() if k not in ("t", "seq")}
                for r in recs]

    assert strip(trecs) == strip(jrecs)
    assert check_invariants(trecs) == []
    assert jax_journal.check_invariants(jrecs) == []


# ---------------------------------------------------------- HTTP surface
@pytest.fixture
def server(tmp_path):
    eng = FakeEngine(EngineConfig(model="test-tiny", max_slots=8),
                     models={"test-tiny": None},
                     blocklist_path=str(tmp_path / "blocked.json"))
    srv = serve_in_thread(eng, timeout_s=30)
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    stop_server(srv)


def _get(base, path):
    return json.loads(urllib.request.urlopen(base + path, timeout=30).read())


def _gen(base, user="alice", prompt="hi"):
    req = urllib.request.Request(
        base + "/api/generate", data=json.dumps(
            {"model": "test-tiny", "prompt": prompt, "stream": False}).encode(),
        headers={"X-User-ID": user})
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def test_debug_journal_filters(server):
    _gen(server, user="alice")
    _gen(server, user="bob")
    body = _get(server, "/debug/journal")
    assert body["capacity"] == 2048
    assert {"enqueue", "admit", "place", "install", "finish"} <= {
        e["kind"] for e in body["events"]}
    evs = _get(server, "/debug/journal?kind=enqueue")["events"]
    assert evs and all(e["kind"] == "enqueue" for e in evs)
    evs = _get(server, "/debug/journal?user=bob")["events"]
    assert evs and all(e["user"] == "bob" for e in evs)
    rid = evs[0]["req_id"]
    evs = _get(server, f"/debug/journal?req_id={rid}")["events"]
    assert {"enqueue", "admit", "place"} <= {e["kind"] for e in evs}
    assert all(e["req_id"] == rid for e in evs)
    assert len(_get(server, "/debug/journal?n=2")["events"]) == 2
    for bad in ("kind=warp", "n=x", "req_id=x"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(server + "/debug/journal?" + bad, timeout=30)
        assert e.value.code == 400
        if bad == "kind=warp":
            assert "vocabulary" in json.loads(e.value.read())["error"]


def test_request_timeline_includes_journal_slice(server):
    _gen(server)
    rid = _get(server, "/debug/journal?kind=finish")["events"][-1]["req_id"]
    body = _get(server, f"/debug/requests/{rid}")
    assert all(e["req_id"] == rid for e in body["journal"])
    assert {"enqueue", "admit", "place", "install", "finish"} <= {
        e["kind"] for e in body["journal"]}


def test_bundle_has_journal_section(server):
    _gen(server)
    body = _get(server, "/debug/bundle")
    assert body["journal"]["capacity"] == 2048
    assert body["journal"]["events"]


# ------------------------------------------------------------- satellites
def test_retry_after_cold_start_is_clamped():
    eng = FakeEngine(EngineConfig(model="test-tiny"), blocklist_path=None)
    eng.core.total_queued = lambda: 500
    assert 2.0 <= eng.retry_after_s() <= 10.0
    eng.core.total_queued = lambda: 0
    assert 2.0 <= eng.retry_after_s() <= 10.0


def test_health_monitor_raises_invariant_alert():
    from ollamamq_tpu_torch.engine.health import HealthMonitor
    from ollamamq_tpu_torch.telemetry.slo import AlertManager

    class Eng:
        alerts = AlertManager()
        journal = Journal(capacity=32)

    eng = Eng()
    mon = HealthMonitor.__new__(HealthMonitor)
    mon.engine = eng
    mon._check_journal_invariants()
    assert not any(a.name == "journal_invariant" for a in eng.alerts.active())
    eng.journal.record("page_alloc", model="m", n=1, free=1, used=1,
                       cached=1, pool=99)
    mon._check_journal_invariants()
    firing = [a for a in eng.alerts.active() if a.name == "journal_invariant"]
    assert firing and "not conserved" in firing[0].message
    eng.journal = Journal(capacity=32)
    mon._check_journal_invariants()
    assert not any(a.name == "journal_invariant" for a in eng.alerts.active())


def test_fair_share_audit_and_signature_shapes():
    j = Journal(capacity=64)
    j.record("enqueue", req_id=1, user="a", n_prompt=3, queued=1)
    j.record("shed", user="b", reason="queue_full", queued=9, limit=9)
    j.record("page_alloc", model="m", n=1, free=1, used=1, cached=0, pool=2)
    audit = fair_share_audit(j.tail(None))
    assert audit["a"]["enqueued"] == 1 and audit["b"]["shed"] == 1
    sig = decision_signature(j.tail(None))
    assert [s[0] for s in sig] == ["enqueue", "shed"]
    assert all(s[0] in DECISION_KINDS for s in sig)


def test_tui_sends_the_last_decision():
    from ollamamq_tpu_torch.admin.tui import _engine_stats_brief

    eng = FakeEngine(EngineConfig(model="test-tiny"), blocklist_path=None)
    assert _engine_stats_brief(eng)["last_decision"] == ""
    eng.journal.record("shed", user="b", reason="queue_full", queued=9, limit=9)
    assert "shed (queue_full)" in _engine_stats_brief(eng)["last_decision"]
