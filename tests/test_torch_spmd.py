"""Tensor-parallel serving of the port over gloo processes, on the CPU.

The mirror of tests/test_spmd.py, tests/test_spmd_heartbeat.py and
tests/test_spmd_recovery.py (test_spmd_dp_replicas_across_hosts has its
counterpart in tests/test_torch_spmd_dp.py). Rank 0 runs
SPMDEngine, rank 1 run_worker, each in its own process with one compute
thread, over a TCPStore on a fresh port; every process is killed on the
way out and every wait is bounded.

  - two-rank serving of test-tiny in float32 streams the greedy ids of
    the JAX engine at tp 2 (the test session's virtual CPU devices) and
    of the port at tp 1, on the same weights (the JAX seed's tree written
    as a safetensors checkpoint that both ranks load and cut); the
    worker's digest of every dispatch output equals the leader's, and so
    do their op counts; an embed on test-tiny-embed runs on both ranks
    and matches the port at tp 1; rank 0's /metrics, scraped once the
    worker's posted snapshot has settled, is the registry's render of
    that snapshot merged in, and counts the worker's probe series once;
  - the heartbeat monitor's staleness logic;
  - a worker killed mid-stream (os._exit, no report): the request ends
    with an error within the heartbeat bound, /health still answers and
    raises worker_stale;
  - a worker desync (its replay fails after the dispatch ran): the
    request fails loudly, OP_RELOAD rebuilds the runtime on both ranks,
    serving resumes with the ids of an undisturbed run, a model pulled at
    run time (OP_LOAD) embeds on both ranks and is evicted again
    (OP_EVICT);
  - speculation and the prefix cache: verify spans ride OP_SPEC, and the
    worker's outputs and the ids match the leader's and the port's at
    tp 1;
  - the wire's payload packing round-trips every opcode the slice uses,
    through a real TCPStore.

The reference's dead-worker and desync tests fail with the installed
JAX (its gloo transport aborts); these mirrors hold the port to the
behaviour those tests describe.
"""

import datetime
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.engine import spmd
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from testutil import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = dict(model="test-tiny", max_slots=2, num_pages=32, page_size=8,
                max_pages_per_seq=8, decode_steps_per_iter=2, dtype="float32")
PROMPT = "spmd check"
# Speculation and the prefix cache: repeated patterns draft well, and the
# second prompt shares the first's pages.
SPEC = dict(spec=True, spec_k=4, prefix_cache=True, prefix_cache_min_pages=1)
SPEC_PROMPTS = ["abcd abcd abcd abcd abcd abcd", "abcd abcd abcd abcd abcd xyz"]

# argv: rank, port, scenario, checkpoint dir ("" = seeded weights)
CHILD = r"""
import json, os, sys, time
rank, port, scenario, ckpt = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4] or None
os.environ["OLLAMAMQ_SPMD_HB_EVERY"] = "0.5"
os.environ["OLLAMAMQ_SPMD_HB_STALE"] = "3"
import torch
torch.set_num_threads(1)
from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine import spmd
from ollamamq_tpu_torch.parallel import distributed
from ollamamq_tpu_torch.parallel.mesh import make_mesh

distributed.initialize(f"127.0.0.1:{port}", 2, rank, devices=["cpu", "cpu"],
                       timeout_s=60)
mesh = make_mesh(tp=2)
ecfg = EngineConfig(**SETTINGS, **(SPEC if scenario == "spec" else {}))
MODELS = {"test-tiny": ckpt}
if scenario == "serve":
    MODELS["test-tiny-embed"] = None


def result(obj):
    print("RESULT " + json.dumps(obj), flush=True)


if rank == 0:
    from ollamamq_tpu_torch.ops.sampling import SamplingParams

    eng = spmd.SPMDEngine(ecfg, mesh=mesh, blocklist_path=None, models=MODELS)
    eng.recover_interval = 0.5

    def wait(req, budget=120):
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            item = req.stream.get(timeout=0.5)
            if item and item.kind in ("done", "error"):
                return item
        return None

    def generate(max_tokens, budget=120):
        tok = eng.runtimes["test-tiny"].tokenizer
        req = eng.enqueue_request("u", "", "test-tiny", prompt_tokens=tok.encode(PROMPT),
                                  sampling=SamplingParams(max_tokens=max_tokens,
                                                          temperature=0.0))
        t0 = time.monotonic()
        item = wait(req, budget)
        return req, item, time.monotonic() - t0

    def embed(model):
        tok = eng.runtimes[model].tokenizer
        req = eng.enqueue_request("u", "", model, prompt_tokens=tok.encode("embed me"),
                                  sampling=SamplingParams(), kind="embed")
        item = wait(req)
        return bool(item and item.kind == "done"), req.embedding or []

    if scenario == "spec":
        eng.start()
        tok = eng.runtimes["test-tiny"].tokenizer
        reqs = [eng.enqueue_request("u", "", "test-tiny", prompt_tokens=tok.encode(p),
                                    sampling=SamplingParams(max_tokens=24,
                                                            temperature=0.0))
                for p in SPEC_PROMPTS]
        items = [wait(r) for r in reqs]
        eng.stop()
        result({"tokens": [r.generated_ids for r in reqs],
                "done": all(it is not None and it.kind == "done" for it in items),
                "proposed": eng.runtimes["test-tiny"].spec_proposed,
                "me": eng.spmd_report(), "workers": eng.worker_reports})
    elif scenario == "serve":
        sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
        from test_torch_spmd import federated_scrape

        eng.start()
        req, item, _ = generate(6)
        ok, emb = embed("test-tiny-embed")
        metrics = federated_scrape(eng, [eng._plane])
        eng.stop()
        result({"tokens": req.generated_ids, "done": item.kind == "done",
                "embed_ok": ok, "embedding": emb, "me": eng.spmd_report(),
                "workers": eng.worker_reports, "n_chips": eng.runtimes["test-tiny"].n_chips,
                "param_bytes": eng.runtimes["test-tiny"].param_bytes,
                "kv_bytes": eng.runtimes["test-tiny"].kv_bytes,
                "metrics": metrics})
    elif scenario == "dead":
        from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
        import urllib.request

        srv = serve_in_thread(eng)
        req, item, elapsed = generate(64, budget=240)
        time.sleep(3.5)  # the worker's heartbeat value now stale
        eng.health.check_once()
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.server_address[1]}/health", timeout=30).read())
        stop_server(srv)
        eng.stop(report_timeout_s=1)
        result({"kind": item.kind if item else "timeout",
                "error": (item.error or "") if item else "", "elapsed": elapsed,
                "health_status": health["status"],
                "alerts": [a["name"] for a in health["alerts"]],
                "failed": [r["failed"] for r in health["runtimes"]]})
    else:  # desync
        eng.start()
        req1, item1, _ = generate(4)
        loud = bool(item1 and item1.kind == "error")
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            rt = eng.runtimes["test-tiny"]
            if not rt._failed and eng.journal.tail(kind="rebuild"):
                break
            time.sleep(0.1)
        recovered = not eng.runtimes["test-tiny"]._failed
        req2, item2, _ = generate(6)
        eng.load_model("test-tiny-embed")  # OP_LOAD: /api/pull on both ranks
        ok, emb = embed("test-tiny-embed")
        evicted = eng.evict_model("test-tiny-embed")  # OP_EVICT
        eng.stop()
        result({"loud": loud, "error1": item1.error if item1 else "",
                "recovered": recovered, "done2": bool(item2 and item2.kind == "done"),
                "tokens2": req2.generated_ids, "embed_ok": ok, "embed_dim": len(emb),
                "evicted": evicted, "models": eng.loaded_models(),
                "me": eng.spmd_report(), "workers": eng.worker_reports})
else:
    state = {"decodes": 0, "tripped": False}
    orig = spmd._replay

    def replay(rt, op, a, b, payload):
        if scenario == "dead" and op == spmd.OP_DECODE:
            state["decodes"] += 1
            if state["decodes"] >= 2:
                os._exit(7)  # hard death: no cleanup, no status write, no report
        out = orig(rt, op, a, b, payload)
        if scenario == "desync" and op == spmd.OP_DECODE and not state["tripped"]:
            # Fail AFTER the dispatch ran (device-side error class: both
            # ranks ran the step, this one's state update is lost).
            state["tripped"] = True
            rt.recent.zero_()
            raise RuntimeError("injected worker decode failure")
        return out

    spmd._replay = replay
    if scenario == "serve":
        sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
        from test_torch_spmd import probe_worker_metrics

        probe_worker_metrics()
    steps = spmd.run_worker(MODELS, ecfg, mesh)
    result({"steps": steps, "tripped": state["tripped"]})
distributed.exit_process(0)  # never through torch's teardown of live groups
""".replace("SETTINGS", repr(SETTINGS)).replace("SPEC_PROMPTS", repr(SPEC_PROMPTS)).replace(
    "SPEC", repr(SPEC)).replace("PROMPT", repr(PROMPT))


def _run_ranks(tmp_path, scenario, ckpt="", timeout=240):
    """Both ranks of CHILD; returns their RESULT objects (None for a rank
    that printed none). Each process is killed on the way out."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    paths = [tmp_path / f"{scenario}{r}.log" for r in (0, 1)]
    logs = [open(p, "w") for p in paths]
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(port),
                               scenario, ckpt], cwd=REPO, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in (0, 1)]
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"{scenario}: ranks hung:\n"
                            + paths[0].read_text()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    outs = []
    for p, path in zip(procs, paths):
        lines = [ln for ln in path.read_text().splitlines()
                 if ln.startswith("RESULT ")]
        outs.append((p.returncode, json.loads(lines[-1][7:]) if lines else None,
                     path.read_text()))
    return outs


# A series rank 0 never records, which each worker rank of a federation
# test counts once before it serves: a worker's own series repeat rank
# 0's gauges and count nothing else, so without it the merge would not
# show in the scrape.
PROBE_KIND = "federation_probe"


def probe_worker_metrics():
    """Count this worker rank once under PROBE_KIND in its registry."""
    from ollamamq_tpu_torch.telemetry import schema as tm

    tm.JOURNAL_EVENTS_TOTAL.labels(kind=PROBE_KIND).inc()


def federated_scrape(engine, planes, every_s=0.5, budget_s=30.0):
    """`engine`'s /metrics text once every worker rank of `planes` (the
    SPMD planes of its rank worlds) has posted its snapshot and two reads
    `every_s` apart agree, with the registry's render of exactly those
    snapshots (read off each world's store, not through the engine)
    beside it. Rendered again if a gauge moved between the two."""
    from ollamamq_tpu_torch.server.app import render_prometheus
    from ollamamq_tpu_torch.telemetry.metrics import REGISTRY

    def read():
        posts = []
        for plane in planes:
            client = plane.client()
            posts += [spmd._try_get(client, f"ollamamq/metrics/{p}")
                      for p in range(plane.size)]
        return posts

    # Rank 0 of each world posts nothing: its registry is the scraped one.
    firsts = {sum(pl.size for pl in planes[:i]) for i in range(len(planes))}
    deadline = time.monotonic() + budget_s
    posts = read()
    while time.monotonic() < deadline:
        time.sleep(every_s)
        again = read()
        if again == posts and all(v for i, v in enumerate(again) if i not in firsts):
            break
        posts = again
    snaps = [json.loads(v) for i, v in enumerate(posts) if v and i not in firsts]
    for _ in range(3):
        scrape = render_prometheus(engine)
        want = REGISTRY.render(extra_snapshots=snaps)
        if scrape == want:
            break
    return {"snapshots": len(snaps), "rank0_posted": any(posts[i] for i in firsts),
            "scrape": scrape, "want": want}


def probe_count(text):
    """The PROBE_KIND count of a Prometheus scrape (0 if absent)."""
    m = re.search(r'^ollamamq_journal_events_total\{kind="%s"\} (\S+)$'
                  % PROBE_KIND, text, re.M)
    return int(float(m.group(1))) if m else 0


def assert_federated(metrics, n_workers):
    """The scrape merged every worker rank's posted snapshot once and
    nothing else: it equals the registry's render of those snapshots,
    counts the probe once a worker rank, and no rank 0 posted.
    tests/test_torch_spmd_dp.py and _wide_members.py use it too."""
    assert metrics["snapshots"] == n_workers and not metrics["rank0_posted"]
    assert metrics["scrape"] == metrics["want"]
    assert probe_count(metrics["scrape"]) == n_workers


def _wait(req, budget=120):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        item = req.stream.get(timeout=0.5)
        if item and item.kind in ("done", "error"):
            return item
    raise TimeoutError


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """The JAX engine's seed-0 test-tiny tree (float32), written as a
    safetensors checkpoint the port's ranks load."""
    import jax
    import jax.numpy as jnp

    from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
    from ollamamq_tpu.models import weights as jweights
    from ollamamq_tpu_torch.models.weights import from_jax_numpy, save_safetensors

    jp = jweights.load_params(JAX_CONFIGS["test-tiny"], None, seed=0,
                              dtype=jnp.float32)
    pnp = jax.tree_util.tree_map(np.asarray, jp)
    path = str(tmp_path_factory.mktemp("ckpt"))
    save_safetensors(from_jax_numpy(pnp, MODEL_CONFIGS["test-tiny"]),
                     MODEL_CONFIGS["test-tiny"], path)
    return path


def _port_tp1(ckpt, models=None, max_tokens=6):
    eng = TorchEngine(EngineConfig(**SETTINGS), device="cpu", blocklist_path=None,
                      models=models or {"test-tiny": ckpt})
    eng.start()
    try:
        tok = eng.runtimes["test-tiny"].tokenizer
        req = eng.enqueue_request("u", "", "test-tiny",
                                  prompt_tokens=tok.encode(PROMPT),
                                  sampling=SamplingParams(max_tokens=max_tokens,
                                                          temperature=0.0))
        assert _wait(req).kind == "done"
        emb = None
        if "test-tiny-embed" in eng.runtimes:
            ereq = eng.enqueue_request("u", "", "test-tiny-embed",
                                       prompt_tokens=tok.encode("embed me"),
                                       sampling=SamplingParams(), kind="embed")
            assert _wait(ereq).kind == "done"
            emb = ereq.embedding
        return req.generated_ids, emb
    finally:
        eng.stop()


def test_spmd_two_rank_serving_matches_jax_tp2_and_tp1(tmp_path, jax_checkpoint):
    (rc0, leader, log0), (rc1, worker, log1) = _run_ranks(
        tmp_path, "serve", jax_checkpoint)
    assert rc0 == 0 and leader is not None, log0[-3000:]
    assert rc1 == 0 and worker is not None, log1[-3000:]
    assert leader["done"] and len(leader["tokens"]) == 6
    assert leader["embed_ok"] and len(leader["embedding"]) == 64
    # The worker replayed every dispatch and got the same outputs.
    (report,) = leader["workers"]
    assert report["rank"] == 1 and leader["me"]["rank"] == 0
    assert report["digest"] == leader["me"]["digest"]
    assert report["ops"] == leader["me"]["ops"]
    assert report["ops"]["ragged"] >= 1 and report["ops"]["decode"] >= 1
    assert report["ops"]["encode"] == 1
    assert worker["steps"] == sum(v for k, v in report["ops"].items()
                                  if k != "decode_steps")
    # Rank 0's /metrics merges the worker's posted snapshot once.
    assert_federated(leader["metrics"], 1)
    # Two ranks on one host CPU: one device for MFU; each holds half the
    # KV pool of a one-rank engine.
    assert leader["n_chips"] == 1
    ids1, emb1 = _port_tp1(jax_checkpoint,
                           {"test-tiny": jax_checkpoint, "test-tiny-embed": None})
    assert leader["tokens"] == ids1
    np.testing.assert_allclose(leader["embedding"], emb1, rtol=1e-5, atol=1e-6)
    cfg = MODEL_CONFIGS["test-tiny"]
    assert leader["kv_bytes"] * 2 == (2 * cfg.num_layers * 32 * 8
                                      * cfg.num_kv_heads * cfg.head_dim * 4)

    # The JAX engine at tp 2 on the same (seed-0) weights.
    import jax.numpy as jnp

    from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
    from ollamamq_tpu.engine.engine import TPUEngine
    from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling

    jset = {k: v for k, v in SETTINGS.items() if k != "dtype"}
    eng = TPUEngine(JaxEngineConfig(prefill_buckets=(16,), tp=2, **jset),
                    models={"test-tiny": None}, blocklist_path=None,
                    dtype=jnp.float32)
    eng.start()
    try:
        assert eng.runtimes["test-tiny"].mesh.shape["tensor"] == 2
        tok = eng.runtimes["test-tiny"].tokenizer
        req = eng.enqueue_request("u", "", "test-tiny", prompt_tokens=tok.encode(PROMPT),
                                  sampling=JaxSampling(max_tokens=6, temperature=0.0))
        assert _wait(req).kind == "done"
        assert req.generated_ids == leader["tokens"]
    finally:
        eng.stop()


def test_spmd_spec_and_prefix_cache_replay_on_the_worker(tmp_path):
    """Verify spans ride OP_SPEC and prefix hits the ragged wire: the
    worker's digest of every output equals the leader's, and the ids are
    the port's at tp 1 with the same settings."""
    (rc0, leader, log0), (rc1, worker, log1) = _run_ranks(tmp_path, "spec")
    assert rc0 == 0 and leader is not None, log0[-3000:]
    assert rc1 == 0 and worker is not None, log1[-3000:]
    assert leader["done"] and leader["proposed"] >= 1
    (report,) = leader["workers"]
    assert report["ops"]["spec"] >= 1 and report["ops"] == leader["me"]["ops"]
    assert report["digest"] == leader["me"]["digest"]
    eng = TorchEngine(EngineConfig(**SETTINGS, **SPEC), device="cpu",
                      blocklist_path=None)
    eng.start()
    try:
        tok = eng.runtimes["test-tiny"].tokenizer
        ids = []
        for p in SPEC_PROMPTS:
            r = eng.enqueue_request("u", "", "test-tiny", prompt_tokens=tok.encode(p),
                                    sampling=SamplingParams(max_tokens=24,
                                                            temperature=0.0))
            assert _wait(r).kind == "done"
            ids.append(r.generated_ids)
    finally:
        eng.stop()
    assert leader["tokens"] == ids


def test_heartbeat_monitor_staleness_logic(monkeypatch):
    monkeypatch.setenv("OLLAMAMQ_SPMD_HB_STALE", "5")
    m = spmd._HeartbeatMonitor()
    # Never-written peers are alive (liveness is opt-in per rank).
    assert m.observe(1, None, now=0.0) is False
    assert m.observe(1, None, now=100.0) is False
    # A changing value is alive, however long between observations.
    assert m.observe(1, "0", now=0.0) is False
    assert m.observe(1, "1", now=50.0) is False
    # Unchanged value within the stale window: still alive.
    assert m.observe(1, "1", now=54.0) is False
    # Unchanged beyond the window (since FIRST seen at 50): stale.
    assert m.observe(1, "1", now=56.0) is True
    # Recovery: the value moves again => alive again.
    assert m.observe(1, "2", now=57.0) is False


def test_spmd_dead_worker_fails_requests_fast(tmp_path):
    (rc0, leader, log0), (rc1, _, _) = _run_ranks(tmp_path, "dead")
    assert rc1 == 7  # the worker died where it was told to
    assert rc0 == 0 and leader is not None, log0[-3000:]
    # Loud: the in-flight request errors rather than hanging or serving.
    assert leader["kind"] == "error", leader
    # Fast: the worker dies 2 decode ops in; detection is heartbeat-scale
    # (stale after 3 s) plus the transport's reaction, nowhere near the
    # 900 s status-sync timeout.
    assert leader["elapsed"] < 60, leader
    # /health still answers: the runtime is failed and the dead worker
    # raises the reference's worker_stale alert.
    assert leader["failed"] == [True]
    assert "worker_stale" in leader["alerts"]
    assert leader["health_status"] == "degraded"


def test_spmd_worker_desync_fails_loud_then_reloads(tmp_path):
    (rc0, leader, log0), (rc1, worker, log1) = _run_ranks(tmp_path, "desync")
    assert rc0 == 0 and leader is not None, log0[-3000:]
    assert rc1 == 0 and worker is not None, log1[-3000:]
    assert worker["tripped"], "sabotage never fired"
    # Loud: the worker's failed replay errors the in-flight request.
    assert leader["loud"] and "failed replaying" in leader["error1"]
    # OP_RELOAD rebuilt the runtime on both ranks; serving resumed.
    assert leader["recovered"] and leader["done2"]
    ids1, _ = _port_tp1(None)
    assert leader["tokens2"] == ids1
    # A model pulled at run time embeds on both ranks, then is evicted.
    assert leader["embed_ok"] and leader["embed_dim"] == 64
    assert leader["evicted"] is True and leader["models"] == ["test-tiny"]
    assert "injected worker decode failure" in log1
    assert "worker reloaded test-tiny" in log1


def _values(spec, rng):
    return [rng.integers(-1000, 1000, size=shape).astype(dt)
            if np.dtype(dt).kind in "iu" else rng.normal(size=shape).astype(dt)
            for shape, dt in spec]


@pytest.mark.parametrize("op,a,b", [
    (spmd.OP_RAGGED, 24, 0), (spmd.OP_SPEC, 32, 4), (spmd.OP_DECODE, 4, 0),
    (spmd.OP_EMBED, 8, 64), (spmd.OP_ENCODE, 1, 32), (spmd.OP_LOAD, 1, 0),
    (spmd.OP_EVICT, 0, 0), (spmd.OP_RELOAD, 0, 0), (spmd.OP_SHUTDOWN, 0, 0),
    (spmd.OP_PREFILL, 32, 4), (spmd.OP_CHUNK, 64, 0), (spmd.OP_PREFILL_SP, 64, 0),
], ids=["ragged", "spec", "decode", "embed", "encode", "load", "evict",
        "reload", "shutdown", "prefill", "chunk", "prefill_sp"])
def test_wire_payload_round_trips(op, a, b, monkeypatch):
    """payload_spec -> _send over a real TCPStore -> _recv_op ->
    _unpack_payload gives back the header and every value exactly; the
    prefill opcodes keep their numbers, the sp prefill's data op too."""
    S, MP, W = 4, 8, 16
    K = int(torch.Generator().get_state().numel())
    store = torch.distributed.TCPStore("127.0.0.1", 0, 1, is_master=True,
                                       timeout=datetime.timedelta(seconds=10),
                                       wait_for_workers=False)
    monkeypatch.setattr(spmd, "_client", lambda: store)
    spmd._reset_wire()
    spec = spmd.payload_spec(op, a, b, S, MP, W, K)
    rng = np.random.default_rng(op)
    values = _values(spec, rng)
    if op == spmd.OP_LOAD:
        values = [spmd._encode_str("test-tiny-embed", spmd.NAME_LEN),
                  spmd._encode_str("/ckpt/dir", spmd.PATH_LEN)]
    spmd._send(op, a, b, 3, 0, values, S, MP, W, K)
    header, raw = spmd._recv_op(0)
    assert header.tolist() == [op, a, b, 3, 0]
    got = spmd._unpack_payload(raw, spec)
    assert len(got) == len(values)
    for g, v in zip(got, values):
        assert g.dtype == v.dtype and np.array_equal(g, v)
    if op == spmd.OP_LOAD:
        assert spmd._decode_str(got[0]) == "test-tiny-embed"
        assert spmd._decode_str(got[1]) == "/ckpt/dir"
    assert len(spmd.payload_spec(spmd.OP_PREFILL_SP, 16, 0, S, MP, W, K)) == 12
    assert (spmd.OP_PREFILL, spmd.OP_CHUNK, spmd.OP_PREFILL_SP) == (1, 2, 5)
    assert spmd.OP_PREFILL_SP in spmd.DATA_OPS
