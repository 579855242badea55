"""Crash durability of the port against the JAX package's, on the CPU.

The mirror of tests/test_durability.py over the port's FakeEngine, its
fleet router, its CLI in a subprocess and
TorchEngine on the CPU: the admission is on disk before enqueue returns,
embeds are not logged, any truncation of the WAL loads, disk trouble
degrades loudly, a crash mid-stream recovers token-exact (on a real
runtime too, with pages conserved), a spent budget surfaces its
terminal, the resume endpoint replays and follows, SIGTERM drains and
exits 0, kill -9 and a restart resume byte-identically, quiesce sheds
honestly, sampled journals keep their decisions, the multi-file check
rolls up across a crash, and the crash-point soak completes every
stream.

Beyond the mirror: the WAL lines of both packages have the same keys and
value types, and a WAL written by either engine and cut mid-stream
recovers in the other with the greedy continuation of an uninterrupted
run (test-tiny, float32, weights bridged).
"""

import json
import os
import random
import shutil
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.durability.wal import load_wal_records as jax_load_wal
from ollamamq_tpu.engine.engine import TPUEngine
from ollamamq_tpu.engine.fake import FakeEngine as JaxFakeEngine
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.durability.wal import load_wal_records
from ollamamq_tpu_torch.engine.engine import QueueFullError, TorchEngine
from ollamamq_tpu_torch.engine.fake import FakeEngine
from ollamamq_tpu_torch.models.weights import from_jax_numpy
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.telemetry.journal import Journal, check_invariants
from ollamamq_tpu_torch.testing.faults import FaultPlan
from ollamamq_tpu_torch.tools.journal import main as journal_main
from testutil import collect, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fake(tmp_path, latency=0.0, **over):
    cfg = dict(model="test-tiny", wal_dir=str(tmp_path / "wal"), wal_fsync_ms=2.0)
    cfg.update(over)
    eng = FakeEngine(EngineConfig(**cfg), blocklist_path=None,
                     token_latency_s=latency)
    eng.start()
    return eng


def _crash(eng):
    """Abrupt loop death (not stop(), which flushes what a crash leaves
    behind); the WAL flusher stops too, so the copy is a stable snapshot."""
    eng._running = False
    eng.notify()
    time.sleep(0.1)
    wal = eng.durability.wal
    wal._stop.set()
    with wal._cond:
        wal._cond.notify_all()  # the flusher sleeps until woken
    if wal._flusher is not None:
        wal._flusher.join(timeout=5)
        assert not wal._flusher.is_alive()


def _crash_copy(eng, tmp_path, name="wal-crash"):
    """Copy the crashed engine's WAL dir, then tear the corpse down."""
    dst = str(tmp_path / name)
    shutil.copytree(eng.ecfg.wal_dir, dst)
    eng.stop()
    return dst


def _wal(path):
    return load_wal_records(os.path.join(path, "wal.jsonl"))


# ---------------------------------------------------------------- WAL basics
def test_wal_admit_is_durable_before_ack(tmp_path):
    eng = _fake(tmp_path)
    try:
        req = eng.enqueue_request("alice", "", "test-tiny", prompt_tokens=[1, 2, 3],
                                  sampling=SamplingParams(max_tokens=4))
        entries, torn = _wal(eng.ecfg.wal_dir)
        assert torn == 0 and entries[req.req_id]["admit"]["prompt"] == [1, 2, 3]
        assert collect(req)[-1].kind == "done"
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            ent = _wal(eng.ecfg.wal_dir)[0][req.req_id]
            if ent["finished"] is not None:
                break
            time.sleep(0.02)
        assert ent["finished"] == "length"
        assert [i for i, _ in ent["toks"]] == [1, 2, 3, 4]
        assert "".join(t for _, t in ent["toks"]) == "word0 word1 word2 word3 "
        wal_admits = eng.journal.tail(kind="wal_admit")
        assert len(wal_admits) == 1 and wal_admits[0]["fsync_ms"] >= 0
    finally:
        eng.stop()


def test_wal_embeds_not_logged(tmp_path):
    eng = _fake(tmp_path)
    try:
        req = eng.enqueue_request("e", "", "test-tiny", prompt_tokens=[1, 2],
                                  kind="embed", sampling=SamplingParams())
        collect(req)
        assert req.req_id not in _wal(eng.ecfg.wal_dir)[0]
    finally:
        eng.stop()


def test_wal_truncated_tail_is_loadable(tmp_path):
    eng = _fake(tmp_path)
    try:
        for i in range(3):
            collect(eng.enqueue_request(
                f"u{i}", "", "test-tiny", prompt_tokens=[1] * (i + 2),
                sampling=SamplingParams(max_tokens=3 + i)))
        time.sleep(0.2)  # let the flusher land everything
    finally:
        eng.stop()
    path = os.path.join(str(tmp_path / "wal"), "wal.jsonl")
    full, torn = load_wal_records(path)
    assert torn == 0 and len(full) == 3
    data = open(path, "rb").read()
    rng = random.Random(7)
    for _ in range(25):
        trunc = str(tmp_path / "trunc.jsonl")
        with open(trunc, "wb") as f:
            f.write(data[:rng.randrange(0, len(data))])
        part, _torn = load_wal_records(trunc)  # must not raise
        for rid, ent in part.items():
            assert ent["admit"]["prompt"] == full[rid]["admit"]["prompt"]
            assert ent["toks"] == full[rid]["toks"][:len(ent["toks"])]


def test_token_appends_never_wait_on_fsync(tmp_path, monkeypatch):
    """The engine thread appends token records while the flusher is in a
    slow fsync: the append returns at once (the write and the fsync run
    outside the buffer's lock), and the admission still waits for its
    covering fsync."""
    from ollamamq_tpu_torch.durability import wal as wal_mod

    in_fsync = wal_mod.threading.Event()
    real_fsync = os.fsync

    def slow_fsync(fd):
        in_fsync.set()
        time.sleep(0.3)
        real_fsync(fd)

    wal = wal_mod.RequestWAL(str(tmp_path / "wal"), fsync_ms=2.0)
    wal.begin()
    monkeypatch.setattr(wal_mod.os, "fsync", slow_fsync)
    try:
        wal.append_tokens(1, [[5, "a"]])
        assert in_fsync.wait(5)
        t0 = time.monotonic()
        wal.append_tokens(1, [[6, "b"]])
        assert time.monotonic() - t0 < 0.05
        assert wal.admit({"k": "admit", "rid": 2, "prompt": [1]}) >= 0.0
        assert 2 in load_wal_records(wal.path)[0]
    finally:
        wal.close()
    assert [i for i, _ in load_wal_records(wal.path)[0][2]["toks"]] == []


def test_idle_wal_flusher_sleeps(tmp_path):
    """An idle WAL's flusher waits for work instead of polling every
    window (on the card a 2 ms poll slowed the engine thread's eager
    dispatch by ~15%); a token record still reaches the disk within a
    window or so of being appended."""
    from ollamamq_tpu_torch.durability.wal import RequestWAL

    wal = RequestWAL(str(tmp_path / "wal"), fsync_ms=2.0)
    flushes = []
    real = wal._flush
    wal._flush = lambda: (flushes.append(time.monotonic()), real())[1]
    wal.begin()
    try:
        time.sleep(0.3)
        assert len(flushes) == 0
        wal.admit({"k": "admit", "rid": 1, "prompt": [1]})
        wal.append_tokens(1, [[9, "x"]])
        deadline = time.monotonic() + 5
        while (not load_wal_records(wal.path)[0][1]["toks"]
               and time.monotonic() < deadline):
            time.sleep(0.002)
        assert load_wal_records(wal.path)[0][1]["toks"] == [[9, "x"]]
        settled = len(flushes)
        time.sleep(0.3)
        assert len(flushes) == settled <= 3
    finally:
        wal.close()


def test_wal_concurrent_admits_and_appends(tmp_path):
    """16 threads admit, append tokens and finish against the flusher
    with a shortened switch interval: each admit's record is on disk when
    admit returns, and every record lands exactly once."""
    import threading

    from ollamamq_tpu_torch.durability.wal import RequestWAL

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    wal = RequestWAL(str(tmp_path / "wal"), fsync_ms=1.0)
    wal.begin()
    late = []

    def client(i):
        for j in range(10):
            rid = i * 100 + j
            wal.admit({"k": "admit", "rid": rid, "prompt": [i, j]})
            if rid not in load_wal_records(wal.path)[0]:
                late.append(rid)
            wal.append_tokens(rid, [[j, "t"]])
            wal.finish(rid, "stop")

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        wal.close()
    entries, torn = load_wal_records(wal.path)
    assert not late and torn == 0 and len(entries) == 160
    assert all(e["finished"] == "stop" and len(e["toks"]) == 1
               and e["admit"]["prompt"] == [rid // 100, rid % 100]
               for rid, e in entries.items())


def test_wal_fault_degrades_loudly(tmp_path):
    plan = FaultPlan([{"site": "wal", "kind": "exception", "at": [1]}])
    eng = _fake(tmp_path, fault_plan=plan)
    try:
        req = eng.enqueue_request("f", "", "test-tiny", prompt_tokens=[1, 2],
                                  sampling=SamplingParams(max_tokens=3))
        assert collect(req)[-1].kind == "done"  # serving survived the disk
        deadline = time.monotonic() + 5
        while not eng.durability.wal.dead and time.monotonic() < deadline:
            time.sleep(0.02)
        assert eng.durability.wal.dead
        assert any(a.name == "wal_degraded" for a in eng.alerts.active())
        items = collect(eng.enqueue_request(
            "f", "", "test-tiny", prompt_tokens=[3],
            sampling=SamplingParams(max_tokens=2)))
        assert items[-1].kind == "done"
    finally:
        eng.stop()


# ------------------------------------------------------------------ recovery
def test_recovery_resumes_token_exact(tmp_path):
    eng = _fake(tmp_path, latency=0.02)
    req = eng.enqueue_request("alice", "", "test-tiny", prompt_tokens=[1, 2, 3],
                              sampling=SamplingParams(max_tokens=12))
    rid = req.req_id
    while len(req.generated_ids) < 5:
        time.sleep(0.005)
    _crash(eng)
    crash_dir = _crash_copy(eng, tmp_path)
    eng2 = _fake(tmp_path / "ignored", wal_dir=crash_dir)
    try:
        dur = eng2.durability
        assert dur.recovered_streams == 1
        entry = dur.registry.find(rid)
        assert entry is not None and entry.recovered
        deadline = time.monotonic() + 20
        while entry.terminal is None and time.monotonic() < deadline:
            time.sleep(0.01)
        frames, term = entry.snapshot(0)
        assert term == {"reason": "length", "error": ""}
        assert "".join(t for _, t in frames) == "".join(
            f"word{i} " for i in range(12))
        assert [i for i, _ in frames if i >= 0] == list(range(1, 13))
        recs = eng2.journal.tail(kind="recover_replay")
        assert len(recs) == 1 and recs[0]["outcome"] == "replayed"
        assert recs[0]["wal_rid"] == rid
        assert recs[0]["tokens"] == len(load_wal_records(
            os.path.join(crash_dir, "wal.jsonl.1"))[0][rid]["toks"])
        # The new generation holds the survivor under its ORIGINAL rid.
        assert rid in _wal(crash_dir)[0]
    finally:
        eng2.stop()


def test_recovery_refuses_out_of_vocab_ids_alone(tmp_path):
    """A foreign WAL whose admission carries an id outside the model's
    vocabulary (which on the card would index the embedding table past
    its end): that entry fails on its own with an error terminal, and the
    other stream still recovers token-exact."""
    eng = _fake(tmp_path, latency=0.02)
    good = eng.enqueue_request("alice", "", "test-tiny", prompt_tokens=[1, 2, 3],
                               sampling=SamplingParams(max_tokens=12))
    bad = eng.enqueue_request("bob", "", "test-tiny", prompt_tokens=[4, 5],
                              sampling=SamplingParams(max_tokens=12))
    while len(good.generated_ids) < 3 or len(bad.generated_ids) < 3:
        time.sleep(0.005)
    _crash(eng)
    crash_dir = _crash_copy(eng, tmp_path)
    path = os.path.join(crash_dir, "wal.jsonl")
    with open(path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    for rec in lines:
        if rec["k"] == "admit" and rec["rid"] == bad.req_id:
            rec["prompt"] = [4, 999999999]
    with open(path, "w") as f:
        f.writelines(json.dumps(rec) + "\n" for rec in lines)
    eng2 = _fake(tmp_path / "ignored", wal_dir=crash_dir)
    try:
        dur = eng2.durability
        assert dur.recovered_streams == 1
        failed = dur.registry.find(bad.req_id)
        assert failed.terminal["reason"] == "error"
        assert "outside [0, 512)" in failed.terminal["error"]
        entry = dur.registry.find(good.req_id)
        deadline = time.monotonic() + 20
        while entry.terminal is None and time.monotonic() < deadline:
            time.sleep(0.01)
        frames, term = entry.snapshot(0)
        assert term == {"reason": "length", "error": ""}
        assert [i for i, _ in frames if i >= 0] == list(range(1, 13))
        outcomes = sorted(r["outcome"]
                          for r in eng2.journal.tail(kind="recover_replay"))
        assert outcomes == ["failed", "replayed"]
    finally:
        eng2.stop()


def test_drainer_runs_only_while_orphans_live(tmp_path):
    """The thread that drains recovered, client-less streams exists only
    while there are some: a process that recovered nothing has none (no
    idle wake-ups beside the engine thread), and a recovering one's
    drainer exits once its orphans reach their terminals."""
    eng = _fake(tmp_path, latency=0.02)
    try:
        assert eng.durability._drainer is None
        req = eng.enqueue_request("alice", "", "test-tiny", prompt_tokens=[1, 2],
                                  sampling=SamplingParams(max_tokens=12))
        while len(req.generated_ids) < 3:
            time.sleep(0.005)
        assert eng.durability._drainer is None
    finally:
        _crash(eng)
    crash_dir = _crash_copy(eng, tmp_path)
    eng2 = _fake(tmp_path / "ignored", latency=0.02, wal_dir=crash_dir)
    try:
        dur = eng2.durability
        assert dur.recovered_streams == 1
        drainer = dur._drainer
        assert drainer is not None
        drainer.join(timeout=20)
        assert not drainer.is_alive()
        assert dur.status()["orphan_streams"] == 0
        assert dur.registry.find(req.req_id).terminal["reason"] == "length"
    finally:
        eng2.stop()


def test_recovery_finished_budget_surfaces_terminal(tmp_path):
    eng = _fake(tmp_path)
    req = eng.enqueue_request("b", "", "test-tiny", prompt_tokens=[1],
                              sampling=SamplingParams(max_tokens=4))
    rid = req.req_id
    assert collect(req)[-1].kind == "done"
    time.sleep(0.2)
    _crash(eng)
    crash_dir = _crash_copy(eng, tmp_path)
    path = os.path.join(crash_dir, "wal.jsonl")
    lines = [ln for ln in open(path) if '"fin"' not in ln]
    open(path, "w").writelines(lines)
    eng2 = _fake(tmp_path / "ignored", wal_dir=crash_dir)
    try:
        assert eng2.durability.recovered_streams == 0
        entry = eng2.durability.registry.find(rid)
        assert entry.terminal == {"reason": "length", "error": ""}
        assert entry.token_count() == 4
        recs = eng2.journal.tail(kind="recover_replay")
        assert recs and recs[0]["outcome"] == "finished"
    finally:
        eng2.stop()


TINY = dict(model="test-tiny", max_slots=2, num_pages=64, page_size=8,
            max_pages_per_seq=8, decode_steps_per_iter=1)
PROMPT = list(range(7, 19))


@pytest.fixture(scope="module")
def jax_golden():
    """An uninterrupted greedy run on TPUEngine: (ids, text, bridged
    weights for the port)."""
    ref = TPUEngine(JaxEngineConfig(prefill_buckets=(16, 32), **TINY),
                    blocklist_path=None, dtype=jnp.float32)
    ref.start()
    try:
        gr = ref.enqueue_request("g", "", "test-tiny", prompt_tokens=list(PROMPT),
                                 sampling=JaxSampling(max_tokens=10))
        items = collect(gr, timeout=240)
        pnp = jax.tree_util.tree_map(np.asarray, ref.runtimes["test-tiny"].params)
    finally:
        ref.stop()
    ids = list(gr.generated_ids)
    assert len(ids) == 10
    text = "".join(i.text for i in items if i.kind == "token")
    return ids, text, from_jax_numpy(pnp, MODEL_CONFIGS["test-tiny"])


def _torch_engine(params, **over):
    eng = TorchEngine(EngineConfig(**{**TINY, **over}), device="cpu",
                      dtype=torch.float32, params=params, blocklist_path=None)
    eng.start()
    return eng


def _jax_engine(**over):
    eng = TPUEngine(JaxEngineConfig(prefill_buckets=(16, 32), **{**TINY, **over}),
                    blocklist_path=None, dtype=jnp.float32)
    eng.start()
    return eng


# A slowed decode step on the writing engine, so the crash lands
# mid-stream however fast the host is (the fault sleeps before any device
# work; tokens are unchanged).
SLOW_DECODE = [{"site": "decode", "kind": "slow", "every": 1, "delay_s": 0.05}]


def _crash_mid_stream(eng, tmp_path, at=4):
    """Start the greedy stream on `eng` (either package), crash it once
    `at` tokens are out, return (pre-crash rid, the crash copy)."""
    sp = (SamplingParams if isinstance(eng, TorchEngine) else JaxSampling)
    req = eng.enqueue_request("g", "", "test-tiny", prompt_tokens=list(PROMPT),
                              sampling=sp(max_tokens=10))
    deadline = time.monotonic() + 240
    while len(req.generated_ids) < at and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(req.generated_ids) >= at, "stream never got going"
    _crash(eng)
    assert not req.stats.finished_at, "finished before the crash"
    return req.req_id, _crash_copy(eng, tmp_path)


def _recovered(eng, rid):
    entry = eng.durability.registry.find(rid)
    assert entry is not None
    deadline = time.monotonic() + 240
    while entry.terminal is None and time.monotonic() < deadline:
        time.sleep(0.02)
    frames, term = entry.snapshot(0)
    assert term is not None and term["reason"] in ("length", "stop")
    return [i for i, _ in frames if i >= 0], "".join(t for _, t in frames)


def test_recovery_real_engine_page_conservation(tmp_path, jax_golden):
    """A greedy stream on TorchEngine cut mid-decode recovers byte- and
    token-identical to the uninterrupted run, the allocator conserves
    its pages and the journal is invariant-clean."""
    ids, text, params = jax_golden
    eng = _torch_engine(params)
    try:
        gr = eng.enqueue_request("g", "", "test-tiny", prompt_tokens=list(PROMPT),
                                 sampling=SamplingParams(max_tokens=10))
        collect(gr, timeout=240)
    finally:
        eng.stop()
    assert list(gr.generated_ids) == ids
    eng = _torch_engine(params, wal_dir=str(tmp_path / "wal"), wal_fsync_ms=2.0,
                        fault_plan=FaultPlan(SLOW_DECODE))
    rid, crash_dir = _crash_mid_stream(eng, tmp_path)
    eng2 = _torch_engine(params, wal_dir=crash_dir, wal_fsync_ms=2.0)
    try:
        assert _recovered(eng2, rid) == (ids, text)
        alloc = eng2.runtimes["test-tiny"].alloc
        assert (alloc.free_pages + alloc.used_pages + alloc.cached_pages
                == alloc.num_pages - 1)
        assert check_invariants(eng2.journal.tail(None)) == []
    finally:
        eng2.stop()


def test_jax_wal_recovers_in_the_port(tmp_path, jax_golden):
    """A WAL written by TPUEngine and cut mid-stream: TorchEngine
    recovers it with the JAX engine's uninterrupted greedy continuation."""
    ids, text, params = jax_golden
    from ollamamq_tpu.testing.faults import FaultPlan as JaxFaultPlan

    rid, crash_dir = _crash_mid_stream(
        _jax_engine(wal_dir=str(tmp_path / "wal"), wal_fsync_ms=2.0,
                    fault_plan=JaxFaultPlan(SLOW_DECODE)), tmp_path)
    eng = _torch_engine(params, wal_dir=crash_dir, wal_fsync_ms=2.0)
    try:
        assert eng.durability.recovered_streams == 1
        assert _recovered(eng, rid) == (ids, text)
    finally:
        eng.stop()


def test_port_wal_recovers_in_jax(tmp_path, jax_golden):
    """And the reverse: TorchEngine's WAL recovered by TPUEngine."""
    ids, text, params = jax_golden
    rid, crash_dir = _crash_mid_stream(
        _torch_engine(params, wal_dir=str(tmp_path / "wal"), wal_fsync_ms=2.0,
                      fault_plan=FaultPlan(SLOW_DECODE)), tmp_path)
    eng = _jax_engine(wal_dir=crash_dir, wal_fsync_ms=2.0)
    try:
        assert eng.durability.recovered_streams == 1
        assert _recovered(eng, rid) == (ids, text)
    finally:
        eng.stop()


def test_seeded_stream_recovers_identically(tmp_path, jax_golden):
    """A seeded sampled stream cut mid-decode: its uniforms are drawn
    from (seed, position) alone (ops/sampling.py row_uniforms), with no
    counter a restart would reset, and the WAL keeps the folded seed, so
    the recovered stream on TorchEngine (float32, CPU) is the
    uninterrupted one. The reference gates only greedy recovery; this
    records what a seeded one does here."""
    _ids, _text, params = jax_golden

    def sampling():
        return SamplingParams(max_tokens=12, temperature=0.9, top_k=40, seed=123)

    eng = _torch_engine(params)
    try:
        gr = eng.enqueue_request("s", "", "test-tiny", prompt_tokens=list(PROMPT),
                                 sampling=sampling())
        collect(gr, timeout=240)
    finally:
        eng.stop()
    eng = _torch_engine(params, wal_dir=str(tmp_path / "wal"), wal_fsync_ms=2.0,
                        fault_plan=FaultPlan(SLOW_DECODE))
    req = eng.enqueue_request("s", "", "test-tiny", prompt_tokens=list(PROMPT),
                              sampling=sampling())
    deadline = time.monotonic() + 240
    while len(req.generated_ids) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    _crash(eng)
    assert not req.stats.finished_at
    crash_dir = _crash_copy(eng, tmp_path)
    eng2 = _torch_engine(params, wal_dir=crash_dir, wal_fsync_ms=2.0)
    try:
        ids, _ = _recovered(eng2, req.req_id)
    finally:
        eng2.stop()
    assert ids == list(gr.generated_ids) and len(ids) == 12


def _shape(obj):
    """Keys and value types of a WAL line, recursively."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in sorted(obj.items())}
    if isinstance(obj, list):
        return [_shape(v) for v in obj[:1]]
    return type(obj).__name__


def test_wal_lines_have_the_jax_shape(tmp_path):
    """admit / tok / fin lines of both packages' FakeEngines: the same
    keys with the same value types, the sampling state included."""
    shapes = []
    for name, make, sp in (("torch", FakeEngine, SamplingParams),
                           ("jax", JaxFakeEngine, JaxSampling)):
        cfg = (EngineConfig if make is FakeEngine else JaxEngineConfig)(
            model="test-tiny", wal_dir=str(tmp_path / name), wal_fsync_ms=2.0)
        eng = make(cfg, blocklist_path=None)
        eng.start()
        try:
            req = eng.enqueue_request("s", "", "test-tiny", prompt_tokens=[5, 6],
                                      raw_prompt="hi",
                                      sampling=sp(max_tokens=3, seed=4,
                                                  temperature=0.5, stop=["x"],
                                                  deadline_ms=60000))
            collect(req)
        finally:
            eng.stop()
        lines = [json.loads(ln) for ln in
                 open(os.path.join(str(tmp_path / name), "wal.jsonl"))]
        shapes.append({ln["k"]: _shape(ln) for ln in lines})
    assert set(shapes[0]) == {"admit", "tok", "fin"}
    assert shapes[0] == shapes[1]


# ------------------------------------------------- resume endpoint (sockets)
def _read_ndjson(resp):
    text, ids, done = "", [], None
    for raw in resp:
        obj = json.loads(raw)
        ids.extend(int(t) for t in obj.get("token_ids") or ())
        text += obj.get("response", "")
        if obj.get("done"):
            done = obj.get("done_reason")
            break
    return text, ids, done


def test_resume_endpoint_e2e(tmp_path):
    eng = FakeEngine(EngineConfig(model="test-tiny", wal_dir=str(tmp_path / "wal"),
                                  wal_fsync_ms=2.0),
                     blocklist_path=None, token_latency_s=0.03)
    srv = serve_in_thread(eng, timeout_s=30)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        h = json.loads(urllib.request.urlopen(url + "/health", timeout=5).read())
        assert h["wal"]["enabled"] and h["status"] == "ok"
        body = json.dumps({"model": "test-tiny", "prompt": "x", "stream": True,
                           "options": {"num_predict": 9}}).encode()
        main = urllib.request.urlopen(urllib.request.Request(
            url + "/api/generate", data=body), timeout=30)
        rid = json.loads(next(iter(main)))["req_id"]
        text, ids, done = _read_ndjson(urllib.request.urlopen(
            url + f"/api/stream/{rid}?from=1", timeout=30))
        assert done == "length"
        assert text == "".join(f"word{i} " for i in range(1, 9))
        assert ids == list(range(2, 10))
        main.close()
        text, ids, done = _read_ndjson(urllib.request.urlopen(
            url + f"/api/stream/{rid}?from=0", timeout=30))
        assert text == "".join(f"word{i} " for i in range(9))
        assert ids == list(range(1, 10))
        for path, code in (("/api/stream/99999", 404), ("/api/stream/x", 400),
                           (f"/api/stream/{rid}?from=-1", 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(url + path, timeout=5)
            assert e.value.code == code
    finally:
        stop_server(srv)


def test_wal_logs_each_route_prompt(tmp_path):
    """Every generation route logs the client's prompt text as the
    reference's server passes it (raw_prompt): /api/generate its prompt,
    /api/chat and /v1/chat/completions the rendered chat, /v1/completions
    each prompt."""
    eng = FakeEngine(EngineConfig(model="test-tiny", wal_dir=str(tmp_path / "wal"),
                                  wal_fsync_ms=2.0), blocklist_path=None)
    srv = serve_in_thread(eng, timeout_s=30)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    msgs = [{"role": "user", "content": "hello"}]
    try:
        for path, body in (("/api/generate", {"prompt": "gen"}),
                           ("/api/chat", {"messages": msgs}),
                           ("/v1/chat/completions", {"messages": msgs}),
                           ("/v1/completions", {"prompt": ["c1", "c2"]})):
            urllib.request.urlopen(urllib.request.Request(
                url + path, data=json.dumps({"model": "test-tiny", "stream": False,
                                             **body}).encode()), timeout=30).read()
        time.sleep(0.1)
        raws = [e["admit"]["raw_prompt"] for _, e in sorted(
            load_wal_records(os.path.join(str(tmp_path / "wal"), "wal.jsonl"))[0].items())]
    finally:
        stop_server(srv)
    from ollamamq_tpu_torch.config import get_model_config
    from ollamamq_tpu_torch.server.templates import render_chat

    chat = render_chat(msgs, get_model_config("test-tiny"))
    assert raws == ["gen", chat, chat, "c1", "c2"]


def test_no_resume_route_without_wal(tmp_path):
    eng = FakeEngine(EngineConfig(model="test-tiny"), blocklist_path=None)
    srv = serve_in_thread(eng, timeout_s=30)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert "wal" not in json.loads(urllib.request.urlopen(
            url + "/health", timeout=5).read())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/api/stream/1", timeout=5)
        assert e.value.code == 404
    finally:
        stop_server(srv)


def test_recovered_rid_resolves_in_debug_requests(tmp_path):
    """/debug/requests/{pre-crash rid} answers with the id the recovery
    pass re-admitted the stream under (the recover_replay alias)."""
    eng = _fake(tmp_path, latency=0.02)
    req = eng.enqueue_request("a", "", "test-tiny", prompt_tokens=[1, 2],
                              sampling=SamplingParams(max_tokens=12))
    rid = req.req_id
    while len(req.generated_ids) < 3:
        time.sleep(0.005)
    _crash(eng)
    crash_dir = _crash_copy(eng, tmp_path)
    eng2 = FakeEngine(EngineConfig(model="test-tiny", wal_dir=crash_dir,
                                   wal_fsync_ms=2.0), blocklist_path=None)
    srv = serve_in_thread(eng2, timeout_s=30)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        new = eng2.journal.tail(kind="recover_replay")[0]["req_id"]
        assert new != rid
        body = json.loads(urllib.request.urlopen(
            url + f"/debug/requests/{rid}", timeout=5).read())
        assert body["state"] == "recovered" and body["recovered_as"] == new
        body = json.loads(urllib.request.urlopen(
            url + f"/debug/requests/{new}", timeout=5).read())
        assert body["wal_rid"] == rid
    finally:
        stop_server(srv)


# ------------------------------------------------- subprocess e2e (cli path)
def _spawn_cli(tmp_path, port, wal_dir, extra=(), latency="0.05"):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["FAKE_TOKEN_LATENCY_S"] = latency
    env["PYTHONPATH"] = REPO + (os.pathsep + os.environ["PYTHONPATH"]
                                if os.environ.get("PYTHONPATH") else "")
    logf = open(str(tmp_path / f"server-{port}.log"), "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ollamamq_tpu_torch.cli", "--fake-engine",
         "--no-tui", "--models", "test-tiny", "--port", str(port),
         "--wal-dir", wal_dir, "--wal-fsync-ms", "2",
         "--blocklist", str(tmp_path / "bl.json"), *extra],
        stdout=logf, stderr=subprocess.STDOUT, env=env)
    proc._logf = logf
    return proc


def _wait_health(port, budget=90.0):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        try:
            body = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{port}/health", timeout=2).read())
            if body.get("status") != "recovering":
                return body
        except Exception:  # noqa: BLE001 — not up yet
            pass
        time.sleep(0.1)
    raise TimeoutError(f"server :{port} never became healthy")


def test_sigterm_drains_then_exits_zero(tmp_path):
    port = free_port()
    wal_dir = str(tmp_path / "wal")
    proc = _spawn_cli(tmp_path, port, wal_dir, extra=("--stop-grace-s", "30"))
    try:
        _wait_health(port)
        body = json.dumps({"model": "test-tiny", "prompt": "x", "stream": True,
                           "options": {"num_predict": 12}}).encode()
        gen = f"http://127.0.0.1:{port}/api/generate"
        resp = urllib.request.urlopen(urllib.request.Request(gen, data=body),
                                      timeout=60)
        first = json.loads(next(iter(resp)))
        assert first["req_id"] >= 1
        proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 10
        shed = None
        while time.monotonic() < deadline:
            try:
                urllib.request.urlopen(urllib.request.Request(gen, data=body),
                                       timeout=5).read()
            except urllib.error.HTTPError as e:
                shed = e.code
                break
            except Exception:  # noqa: BLE001 — already gone is fine too
                break
            time.sleep(0.1)
        text, _ids, done = _read_ndjson(resp)
        assert done == "length"
        assert first.get("response", "") + text == "".join(
            f"word{i} " for i in range(12))
        assert proc.wait(timeout=60) == 0
        if shed is not None:
            assert shed == 503
        entries, _ = load_wal_records(os.path.join(wal_dir, "wal.jsonl"))
        assert all(e["finished"] is not None for e in entries.values())
        # The exit line carries the process's whole count of kernel
        # launches (none under the fake engine).
        proc._logf.flush()
        with open(proc._logf.name) as f:
            done_line = [ln for ln in f if "graceful shutdown complete" in ln][-1]
        counts = json.loads(done_line.split("kernel launches ", 1)[1]
                            .rsplit("; exiting", 1)[0])
        assert counts and set(counts.values()) == {0}
    finally:
        proc.kill()
        proc._logf.close()


def test_kill9_restart_resume_byte_identical(tmp_path):
    port = free_port()
    wal_dir = str(tmp_path / "wal")
    proc = _spawn_cli(tmp_path, port, wal_dir)
    proc2 = None
    try:
        _wait_health(port)
        body = json.dumps({"model": "test-tiny", "prompt": "x", "stream": True,
                           "options": {"num_predict": 12}}).encode()
        resp = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}/api/generate", data=body), timeout=60)
        rid, text, ids = None, "", []
        for raw in resp:
            obj = json.loads(raw)
            rid = obj.get("req_id", rid)
            ids.extend(int(t) for t in obj.get("token_ids") or ())
            text += obj.get("response", "")
            if len(ids) >= 5:
                break
        proc.kill()  # SIGKILL: no flush, no goodbye
        proc.wait(timeout=30)
        try:
            resp.close()
        except Exception:  # noqa: BLE001
            pass
        proc2 = _spawn_cli(tmp_path, port, wal_dir, latency="0.0")
        health = _wait_health(port)
        assert health["wal"]["recovered_streams"] == 1
        rtext, rids, done = _read_ndjson(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/stream/{rid}?from={len(ids)}",
            timeout=60))
        assert done == "length"
        assert text + rtext == "".join(f"word{i} " for i in range(12))
        assert ids + rids == list(range(1, 13))
    finally:
        proc.kill()
        if proc2 is not None:
            proc2.kill()
        proc._logf.close()


# ------------------------------------------------------- graceful quiesce
def test_quiesce_sheds_honestly(tmp_path):
    eng = _fake(tmp_path)
    try:
        eng.quiesce()
        with pytest.raises(QueueFullError) as e:
            eng.enqueue_request("q", "", "test-tiny", prompt_tokens=[1],
                                sampling=SamplingParams(max_tokens=2))
        assert e.value.scope == "queue_full"
        sheds = eng.journal.tail(kind="shed")
        assert sheds and sheds[-1]["limit"] == 0
        assert check_invariants(eng.journal.tail(None)) == []
        assert eng.inflight_count() == 0
    finally:
        eng.stop()


# ------------------------------------------------------- sampled journaling
def test_sampled_journal_keeps_decisions(tmp_path):
    path = str(tmp_path / "sampled.jsonl")
    j = Journal(capacity=8192, path=path, sample=0.1)
    for _ in range(400):
        j.record("batch", slots=[0], batch_size=1, tokens=4, occupancy=0.5,
                 mode="fake", padded_tokens=4)
        j.record("page_alloc", n=1, free=10, used=5, cached=1, pool=16)
    for i in range(20):
        j.record("enqueue", req_id=i, user="u", n_prompt=3, queued=1)
        j.record("shed", user="u", reason="queue_full", queued=9, limit=8)
        j.record("finish", req_id=i, user="u", reason="stop", tokens=2)
    j.close()
    recs = j.tail(None)
    kinds = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    assert kinds.get("batch", 0) + kinds.get("page_alloc", 0) < 300
    assert kinds["enqueue"] == kinds["shed"] == kinds["finish"] == 20
    assert j.sampled_out > 0 and j.snapshot()["sample"] == 0.1
    batch_total = next(child.value for labels, child in
                       tm.JOURNAL_EVENTS_TOTAL.series() if labels == ("batch",))
    assert batch_total >= 400
    assert check_invariants(recs, starve_after=None) == []
    assert journal_main(["check", path]) == 0


def test_sampled_journal_default_records_everything():
    j = Journal(capacity=64)
    for _ in range(30):
        j.record("batch", slots=[0], batch_size=1, tokens=1, occupancy=0.1)
    assert len(j.tail(None)) == 30
    assert j.sampled_out == 0 and "sample" not in j.snapshot()


# ----------------------------------------------- multi-file audit roll-up
def _spill(path, records, meta=None):
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps({"journal_meta": {"version": 1, **(meta or {})}}) + "\n")
        for i, r in enumerate(records):
            f.write(json.dumps({"seq": i, "t": 0.0, "tick": i, **r}) + "\n")


def test_multi_file_check_rolls_up_across_crash(tmp_path):
    pre, post = str(tmp_path / "r1.jsonl"), str(tmp_path / "r2.jsonl")
    _spill(pre, [
        {"kind": "enqueue", "req_id": 5, "user": "u", "n_prompt": 3, "queued": 1},
        {"kind": "replica_eject", "replica": "r0", "why": "crash"},
        {"kind": "replica_failover", "req_id": 5, "user": "u", "replica": "r0",
         "to_replica": "r1", "replayed_tokens": 2},
    ])
    _spill(post, [
        {"kind": "recover_replay", "req_id": 1, "user": "u", "tokens": 4,
         "outcome": "replayed", "wal_rid": 5},
        {"kind": "finish", "req_id": 1, "user": "u", "reason": "stop", "tokens": 6},
    ])
    assert journal_main(["check", pre]) == 1
    assert journal_main(["check", pre, post]) == 0
    unres = str(tmp_path / "r3.jsonl")
    _spill(unres, [{"kind": "recover_replay", "req_id": 1, "user": "u",
                    "tokens": 4, "outcome": "replayed", "wal_rid": 5}])
    assert journal_main(["check", pre, unres]) == 1


def test_attribution_flags_double_terminal(tmp_path):
    path = str(tmp_path / "double.jsonl")
    _spill(path, [
        {"kind": "replica_failover", "req_id": 7, "user": "u", "replica": "a",
         "to_replica": "b", "replayed_tokens": 1},
        {"kind": "finish", "req_id": 7, "user": "u", "reason": "stop", "tokens": 3},
        {"kind": "finish", "req_id": 7, "user": "u", "reason": "stop", "tokens": 3},
    ])
    assert journal_main(["check", path]) == 1


def test_engine_spills_check_across_a_crash(tmp_path):
    """The port's own spills: the pre-crash process's journal leaves the
    stream cut; with the restarted process's spill the roll-up is
    clean."""
    eng = _fake(tmp_path, latency=0.02, journal_file=str(tmp_path / "j1.jsonl"))
    req = eng.enqueue_request("a", "", "test-tiny", prompt_tokens=[1, 2],
                              sampling=SamplingParams(max_tokens=10))
    while len(req.generated_ids) < 3:
        time.sleep(0.005)
    _crash(eng)
    eng.journal.close()
    crash_dir = _crash_copy(eng, tmp_path)
    eng2 = _fake(tmp_path / "x", wal_dir=crash_dir,
                 journal_file=str(tmp_path / "j2.jsonl"))
    try:
        entry = eng2.durability.registry.find(req.req_id)
        deadline = time.monotonic() + 20
        while entry.terminal is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert entry.terminal is not None
    finally:
        eng2.stop()
    assert journal_main(["check", str(tmp_path / "j1.jsonl"),
                         str(tmp_path / "j2.jsonl")]) == 0


def test_fleet_router_wal_recovery(tmp_path):
    """Fleet-wide recovery: the ROUTER owns the WAL; after a crash its
    streams re-place across the surviving members and the roll-up audit
    over both router generations is clean."""
    import dataclasses

    from ollamamq_tpu_torch.fleet import FleetRouter, LocalMember

    def build(wal_dir, spill, members_n=2):
        ecfg = EngineConfig(model="test-tiny", max_slots=4, wal_dir=wal_dir,
                            wal_fsync_ms=2.0, journal_file=spill)
        member_cfg = dataclasses.replace(ecfg, wal_dir=None, journal_file=None)
        members = [LocalMember(f"r{i}", FakeEngine(
            member_cfg, blocklist_path=None, token_latency_s=0.02))
            for i in range(members_n)]
        router = FleetRouter(members, ecfg, blocklist_path=None,
                             probe_period_s=0.05, eject_heartbeat_s=5.0,
                             reprobe_backoff_s=0.1, evac_grace_s=0.5)
        router.start()
        return router

    wal_dir = str(tmp_path / "wal")
    r1 = build(wal_dir, str(tmp_path / "r1.jsonl"))
    req = r1.enqueue_request("fl", "", "test-tiny", prompt_tokens=[1, 2],
                             sampling=SamplingParams(max_tokens=10))
    rid = req.req_id
    # The router-side Request never fills generated_ids (members own
    # generation); progress reads off the durability tap's frame log.
    live = r1.durability.registry.find(rid)
    deadline = time.monotonic() + 30
    while live.token_count() < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert live.token_count() >= 3
    # Crash the whole router process-equivalent: loop and members die.
    r1._running = False
    r1.notify()
    for m in r1.members:
        m.engine._running = False
        m.engine.notify()
    time.sleep(0.15)
    wal = r1.durability.wal
    wal._stop.set()
    with wal._cond:
        wal._cond.notify_all()  # the flusher sleeps until woken
    if wal._flusher is not None:
        wal._flusher.join(timeout=5)
    r1.journal.close()
    crash_dir = str(tmp_path / "wal-crash")
    shutil.copytree(wal_dir, crash_dir)
    r1.stop()  # tear the corpse down (threads), after the snapshot
    r2 = build(crash_dir, str(tmp_path / "r2.jsonl"))
    try:
        assert r2.durability.recovered_streams == 1
        entry = r2.durability.registry.find(rid)
        deadline = time.monotonic() + 30
        while entry.terminal is None and time.monotonic() < deadline:
            time.sleep(0.02)
        frames, term = entry.snapshot(0)
        assert term is not None
        assert "".join(t for _, t in frames) \
            == "".join(f"word{i} " for i in range(10))
        # Re-placed on a surviving member by the router's placement.
        assert any(r["kind"] == "place" for r in r2.journal.tail(None))
    finally:
        r2.stop()
    assert journal_main(["check", str(tmp_path / "r1.jsonl"),
                         str(tmp_path / "r2.jsonl")]) == 0


# ------------------------------------------------------------------- soak
def test_recovery_crash_point_soak(tmp_path):
    """Randomized crash points x several streams: every recovery
    completes every stream byte-identical, never duplicating a token."""
    rng = random.Random(11)
    for trial in range(6):
        base = tmp_path / f"t{trial}"
        base.mkdir()
        eng = _fake(base, latency=0.01)
        reqs = [eng.enqueue_request(
            f"u{i % 3}", "", "test-tiny", prompt_tokens=[1] * (2 + i),
            sampling=SamplingParams(max_tokens=rng.randrange(4, 14)))
            for i in range(5)]
        target = rng.randrange(1, 30)
        deadline = time.monotonic() + 30
        while (sum(len(r.generated_ids) for r in reqs) < target
               and time.monotonic() < deadline):
            time.sleep(0.002)
        _crash(eng)
        crash_dir = _crash_copy(eng, base)
        eng2 = _fake(base / "x", wal_dir=crash_dir)
        try:
            for r in reqs:
                entry = eng2.durability.registry.find(r.req_id)
                assert entry is not None
                deadline = time.monotonic() + 60
                while entry.terminal is None and time.monotonic() < deadline:
                    time.sleep(0.01)
                frames, term = entry.snapshot(0)
                assert term is not None, f"trial {trial} req {r.req_id}"
                want = min(r.sampling.max_tokens, 16)
                assert [i for i, _ in frames if i >= 0] == list(range(1, want + 1))
                assert "".join(t for _, t in frames) == "".join(
                    f"word{i} " for i in range(want))
            assert check_invariants(eng2.journal.tail(None),
                                    starve_after=None) == []
        finally:
            eng2.stop()


class _TapCheckedPending(dict):
    """A front-end's pending table that records, at the moment a request
    becomes visible to the loop, whether its durability tap is in
    place."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __setitem__(self, rid, val):
        req = getattr(val, "req", val)  # the router's table holds flights
        self.seen.append(req.kind != "generate" or req.stream.tap is not None)
        super().__setitem__(rid, val)


@pytest.mark.parametrize("front", ["engine", "router"])
def test_tap_in_place_before_the_loop_sees_the_request(front, tmp_path):
    """The race behind the crash-point soak's hang: a front-end published
    a request to its loop before DurabilityManager.admit installed the
    stream tap, so a loop that served it first (a short recovered stream
    under load) left the registry without its terminal. The tap and the
    admission line now go in under the pending lock; a recovered stream
    too (its re-admission takes the same enqueue path)."""
    import dataclasses

    from ollamamq_tpu_torch.fleet import FleetRouter, LocalMember

    if front == "engine":
        eng = _fake(tmp_path)
    else:
        ecfg = EngineConfig(model="test-tiny", max_slots=4,
                            wal_dir=str(tmp_path / "wal"), wal_fsync_ms=2.0)
        member = LocalMember("r0", FakeEngine(
            dataclasses.replace(ecfg, wal_dir=None), blocklist_path=None))
        eng = FleetRouter([member], ecfg, blocklist_path=None)
        eng.start()
    try:
        table = _TapCheckedPending()
        table.update(eng.pending)
        eng.pending = table
        reqs = [eng.enqueue_request("tap", "", "test-tiny", prompt_tokens=[1, 2],
                                    sampling=SamplingParams(max_tokens=3))
                for _ in range(3)]
        eng.enqueue_request("tap", "", "test-tiny", prompt_tokens=[1],
                            kind="embed", sampling=SamplingParams())
        assert table.seen == [True] * 4
        for r in reqs:
            entry = eng.durability.registry.find(r.req_id)
            deadline = time.monotonic() + 30
            while entry.terminal is None and time.monotonic() < deadline:
                time.sleep(0.01)
            assert entry.terminal == {"reason": "length", "error": ""}
            assert entry.token_count() == 3
    finally:
        eng.stop()
    # The admission line precedes every token line of its request.
    path = os.path.join(eng.ecfg.wal_dir, "wal.jsonl")
    first = {}
    for i, line in enumerate(open(path)):
        rec = json.loads(line)
        first.setdefault((rec["rid"], rec["k"]), i)
    for r in reqs:
        if (r.req_id, "tok") in first:
            assert first[(r.req_id, "admit")] < first[(r.req_id, "tok")]


def test_jax_load_reads_port_wal(tmp_path):
    """The JAX loader reads a port WAL into the same live state."""
    eng = _fake(tmp_path)
    try:
        collect(eng.enqueue_request("a", "", "test-tiny", prompt_tokens=[1, 2],
                                    sampling=SamplingParams(max_tokens=5)))
        time.sleep(0.2)
    finally:
        eng.stop()
    path = os.path.join(str(tmp_path / "wal"), "wal.jsonl")
    assert load_wal_records(path) == jax_load_wal(path)
