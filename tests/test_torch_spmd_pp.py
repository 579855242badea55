"""Pipeline parallelism across processes: the port's pp-2 engine on the
CPU, against the JAX package's.

The mirror of tests/test_spmd_pp.py and of tests/test_pipeline.py's
engine test. Rank 0 runs SPMDEngine on a (pipe 2) mesh and rank 1
run_worker, one stage each, over gloo on a fresh port, in float32, with
the JAX seed-0 test-tiny tree written as a safetensors checkpoint that
both ranks load (each its own layer). Every process is killed on the way
out and every wait is bounded.

  - the leader serves a short prompt (the bucketed prefill), a prompt
    past the largest bucket (the chunked path) and "pp across hosts"
    while the worker replays every OP_PREFILL, OP_CHUNK and OP_DECODE:
    the greedy ids equal a one-stage port engine's and the JAX
    TPUEngine's on the same weights, and "pp across hosts" gives the
    JAX single_device_greedy_tokens; both ranks' digests of every
    dispatch output are equal; the pp runtime serves generate only and
    /metrics reports pipe 2;
  - the last stage killed mid-stream: the request ends with an error
    within the heartbeat bound and /health raises worker_stale;
  - OP_PREFILL and OP_CHUNK payload specs equal the JAX payload_spec's
    for the same arguments but for the generator state, which rides in
    place of the JAX key.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.engine import spmd
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from testutil import free_port, single_device_greedy_tokens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_pipeline.py's engine settings.
SETTINGS = dict(model="test-tiny", max_slots=4, num_pages=64, page_size=8,
                max_pages_per_seq=16, prefill_buckets=(16, 32, 64),
                max_new_tokens=16, decode_steps_per_iter=4, dtype="float32")
PROMPTS = ["hello pipeline world", "long " * 20]  # 20 tokens; 100 > 64
HOSTS = "pp across hosts"

# argv: rank, port, scenario, checkpoint dir
CHILD = r"""
import json, os, sys, time
rank, port, scenario, ckpt = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
os.environ["OLLAMAMQ_SPMD_HB_EVERY"] = "0.5"
os.environ["OLLAMAMQ_SPMD_HB_STALE"] = "3"
import torch
torch.set_num_threads(1)
from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine import spmd
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.parallel import distributed
from ollamamq_tpu_torch.parallel.mesh import make_mesh

distributed.initialize(f"127.0.0.1:{port}", 2, rank, devices=["cpu", "cpu"],
                       timeout_s=60)
mesh = make_mesh(pp=2)
ecfg = EngineConfig(**SETTINGS)
MODELS = {"test-tiny": ckpt}


def result(obj):
    print("RESULT " + json.dumps(obj), flush=True)


def wait(req, budget=120):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        item = req.stream.get(timeout=0.5)
        if item and item.kind in ("done", "error"):
            return item
    return None


if rank == 0:
    eng = spmd.SPMDEngine(ecfg, mesh=mesh, blocklist_path=None, models=MODELS)
    rt = eng.runtimes["test-tiny"]
    tok = rt.tokenizer

    def generate(prompt, n, budget=120):
        req = eng.enqueue_request("u", "", "test-tiny", prompt_tokens=tok.encode(prompt),
                                  sampling=SamplingParams(max_tokens=n, temperature=0.0))
        t0 = time.monotonic()
        item = wait(req, budget)
        return req, item, time.monotonic() - t0

    eng.start()
    if scenario == "serve":
        out = [generate(p, n) for p, n in ((PROMPTS[0], 8), (PROMPTS[1], 8), (HOSTS, 6))]
        stats = eng.stats()
        embed = wait(eng.enqueue_request("u", "", "test-tiny",
                                         prompt_tokens=tok.encode("e"),
                                         sampling=SamplingParams(), kind="embed"), 30)
        eng.stop()
        result({"tokens": [r.generated_ids for r, _, _ in out],
                "kinds": [it.kind if it else "timeout" for _, it, _ in out],
                "serves": list(rt.SERVES), "mesh": stats["mesh"], "ragged": rt.ragged,
                "spec": rt.spec, "embed_kind": embed.kind if embed else "timeout",
                "prefill_dispatches": rt.prefill_dispatches,
                "chunk_dispatches": rt.chunk_dispatches,
                "ragged_dispatches": rt.ragged_dispatches,
                "kv_layers": rt.kc.shape[0], "layers": len(rt.params["layers"]),
                "pipe": dict(rt.pipe.stats),
                "me": eng.spmd_report(), "workers": eng.worker_reports})
    else:  # dead: the worker (the last stage) dies two decode ops in
        from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
        import urllib.request

        srv = serve_in_thread(eng)
        req, item, elapsed = generate(PROMPTS[0], 64, budget=240)
        time.sleep(3.5)  # the worker's heartbeat value now stale
        eng.health.check_once()
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{srv.server_address[1]}/health", timeout=30).read())
        stop_server(srv)
        eng.stop(report_timeout_s=1)
        result({"kind": item.kind if item else "timeout",
                "error": (item.error or "") if item else "", "elapsed": elapsed,
                "alerts": [a["name"] for a in health["alerts"]],
                "failed": [r["failed"] for r in health["runtimes"]]})
else:
    state = {"decodes": 0}
    orig = spmd._replay

    def replay(rt, op, a, b, payload):
        if scenario == "dead" and op == spmd.OP_DECODE:
            state["decodes"] += 1
            if state["decodes"] >= 2:
                os._exit(7)  # hard death: no cleanup, no status, no report
        return orig(rt, op, a, b, payload)

    spmd._replay = replay
    steps = spmd.run_worker(MODELS, ecfg, mesh)
    result({"steps": steps})
distributed.exit_process(0)  # never through torch's teardown of live groups
""".replace("SETTINGS", repr(SETTINGS)).replace("PROMPTS", repr(PROMPTS)).replace(
    "HOSTS", repr(HOSTS))


def _run_ranks(tmp_path, scenario, ckpt, timeout=240):
    """Both ranks of CHILD; their (return code, RESULT object or None,
    log). Each process is killed on the way out."""
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
                pytest.fail(f"{scenario}: ranks hung:\n" + paths[0].read_text()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    outs = []
    for p, path in zip(procs, paths):
        lines = [ln for ln in path.read_text().splitlines() if ln.startswith("RESULT ")]
        outs.append((p.returncode, json.loads(lines[-1][7:]) if lines else None,
                     path.read_text()))
    return outs


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


@pytest.fixture(scope="module")
def served(tmp_path_factory, jax_checkpoint):
    tmp = tmp_path_factory.mktemp("serve")
    (rc0, leader, log0), (rc1, worker, log1) = _run_ranks(tmp, "serve", jax_checkpoint)
    assert rc0 == 0 and leader is not None, log0[-3000:]
    assert rc1 == 0 and worker is not None, log1[-3000:]
    return leader, worker


def _wait(req, budget=120):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        item = req.stream.get(timeout=0.5)
        if item and item.kind in ("done", "error"):
            return item
    raise TimeoutError


def _port_pp1(ckpt):
    """The one-stage port engine (the ragged path) on the same weights."""
    eng = TorchEngine(EngineConfig(**SETTINGS), device="cpu", blocklist_path=None,
                      models={"test-tiny": ckpt})
    eng.start()
    try:
        rt = eng.runtimes["test-tiny"]
        out = []
        for prompt in PROMPTS:
            req = eng.enqueue_request("u", "", "test-tiny",
                                      prompt_tokens=rt.tokenizer.encode(prompt),
                                      sampling=SamplingParams(max_tokens=8))
            assert _wait(req).kind == "done"
            out.append(req.generated_ids)
        return out, rt.SERVES, eng.stats()["mesh"]
    finally:
        eng.stop()


def _jax_engine_ids():
    """The JAX TPUEngine at pp 1 (its seed-0 weights: the checkpoint)."""
    import jax.numpy as jnp

    from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
    from ollamamq_tpu.engine.engine import TPUEngine
    from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling

    jset = {k: v for k, v in SETTINGS.items() if k != "dtype"}
    eng = TPUEngine(JaxEngineConfig(**jset), blocklist_path=None,
                    models={"test-tiny": None}, dtype=jnp.float32)
    eng.start()
    try:
        tok = eng.runtimes["test-tiny"].tokenizer
        out = []
        for prompt in PROMPTS:
            req = eng.enqueue_request("u", "", "test-tiny", prompt_tokens=tok.encode(prompt),
                                      sampling=JaxSampling(max_tokens=8))
            assert _wait(req, 180).kind == "done"
            out.append(req.generated_ids)
        return out
    finally:
        eng.stop()


def test_pp_engine_serves_generate_and_long_prompt(served, jax_checkpoint):
    """Bucketed prefill, the chunked long-prompt path and the pipelined
    decode at pp 2 give the one-stage port engine's and the JAX engine's
    greedy ids; the pp runtime serves generate only (an embed is
    refused), holds one layer and its pool per stage, and reports pipe 2
    in /metrics."""
    leader, worker = served
    assert leader["kinds"] == ["done"] * 3
    ids_pp1, serves_pp1, mesh_pp1 = _port_pp1(jax_checkpoint)
    assert leader["tokens"][:2] == ids_pp1
    assert leader["tokens"][:2] == _jax_engine_ids()
    assert leader["serves"] == ["generate"] and serves_pp1 == ("generate", "embed")
    assert leader["embed_kind"] == "error"
    assert leader["mesh"]["pipe"] == 2 and mesh_pp1 is None
    assert not leader["ragged"] and not leader["spec"]
    assert leader["ragged_dispatches"] == 0
    assert leader["prefill_dispatches"] >= 2 and leader["chunk_dispatches"] == 2
    assert leader["kv_layers"] == leader["layers"] == 1
    # Stage 0 sends one microbatch a forward (B 1 prefills and chunks;
    # decode B 4 in 2 microbatches) and receives the hidden states back.
    assert leader["pipe"]["recvs"] == leader["pipe"]["forwards"] > 0


def test_spmd_pipeline_parallel_across_processes(served):
    """The worker replayed every dispatch with the same outputs, and the
    greedy ids of "pp across hosts" equal the JAX single-device engine's:
    cross-process pipeline parallelism is numerically transparent."""
    leader, worker = served
    (report,) = leader["workers"]
    assert report["rank"] == 1 and report["digest"] == leader["me"]["digest"]
    assert report["ops"] == leader["me"]["ops"]
    ops = report["ops"]
    assert ops["prefill"] >= 2 and ops["chunk"] == 2 and ops["decode"] >= 2
    assert ops["ragged"] == 0
    assert worker["steps"] == sum(v for k, v in ops.items() if k != "decode_steps")
    assert leader["tokens"][2] == single_device_greedy_tokens("test-tiny", HOSTS)


def test_spmd_pp_dead_last_stage_fails_requests_fast(tmp_path, jax_checkpoint):
    """kill of the last stage mid-stream: the leader's hand-off receive
    fails on the closed connection, the status sync's heartbeat poll
    names the dead rank, the request errors well inside the status
    sync's timeout, and /health raises worker_stale with the runtime
    failed."""
    (rc0, leader, log0), (rc1, _, _) = _run_ranks(tmp_path, "dead", jax_checkpoint)
    assert rc1 == 7
    assert rc0 == 0 and leader is not None, log0[-3000:]
    assert leader["kind"] == "error", leader
    assert leader["elapsed"] < 60, leader
    assert leader["failed"] == [True]
    assert "worker_stale" in leader["alerts"]


@pytest.mark.parametrize("op,a,b", [(spmd.OP_PREFILL, 32, 4), (spmd.OP_PREFILL, 16, 1),
                                    (spmd.OP_CHUNK, 64, 0)],
                         ids=["prefill-b4", "prefill-b1", "chunk"])
def test_pp_payload_specs_match_jax(op, a, b):
    """The same order, shapes and dtypes as the JAX wire for every value
    but the last: the JAX key is the port's generator state."""
    from ollamamq_tpu.engine import spmd as jspmd

    S, MP, W, K = 4, 8, 16, 16
    mine = spmd.payload_spec(op, a, b, S, MP, W, K)
    theirs = jspmd.payload_spec(op, a, b, S, MP, W)
    assert [(tuple(s), np.dtype(d)) for s, d in mine[:-1]] == \
        [(tuple(s), np.dtype(d)) for s, d in theirs[:-1]]
    assert mine[-1] == ((K,), np.uint8)
    assert (spmd.OP_PREFILL, spmd.OP_CHUNK) == (jspmd.OP_PREFILL, jspmd.OP_CHUNK) == (1, 2)
