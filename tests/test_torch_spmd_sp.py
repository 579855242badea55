"""The sequence-parallel prefill over the SPMD wire, on the CPU: the
mirror of tests/test_spmd_sp.py.

  - OP_PREFILL_SP's payload: the JAX wire's order, shapes and dtypes
    (its key is the port's generator state), and a round trip over a
    real TCPStore.
  - Two processes (rank 0 an SPMDEngine at sp 2, rank 1 run_worker, one
    gloo world started once for the module, float32, the JAX seed-0
    test-tiny tree as a safetensors checkpoint): a long prompt (past the
    largest bucket 16) goes out as one OP_PREFILL_SP with a = T, both
    ranks replay it and its greedy ids equal a one-rank port engine's
    and the JAX single_device_greedy_tokens. Then rank 1 kills itself
    (os._exit) in the middle of the next long prompt's ring: the request
    errors within the heartbeat bound, the runtime is failed, /health's
    worker_stale alert fires, and nothing hangs.
  - Four processes at sp 2 x ep 2 on test-tiny-moe (its JAX seed-0
    tree): a long prompt's OP_PREFILL_SP gives the one-rank port
    engine's greedy ids.
"""

import datetime
import json
import os
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
from testutil import collect, free_port, single_device_greedy_tokens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = dict(model="test-tiny", max_slots=2, num_pages=64, page_size=8,
                max_pages_per_seq=16, prefill_buckets=(16,), max_new_tokens=8,
                decode_steps_per_iter=2, dtype="float32")
PROMPT = "sequence parallel spmd " * 3  # ~70 tokens > bucket 16
NEW = 5
HB_STALE = 3.0
KILL_BOUND_S = HB_STALE + 12.0  # staleness + polls + transport slack

# argv: rank, port, checkpoint dir
CHILD = r"""
import json, os, sys, time
rank, port, ckpt = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["OLLAMAMQ_SPMD_HB_EVERY"] = "0.5"
os.environ["OLLAMAMQ_SPMD_HB_STALE"] = "HB_STALE"
import torch
torch.set_num_threads(1)
from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine import spmd
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.parallel import distributed
from ollamamq_tpu_torch.parallel.mesh import SeqGroup, make_mesh

distributed.initialize(f"127.0.0.1:{port}", 2, rank, devices=["cpu"] * 2,
                       timeout_s=60)
mesh = make_mesh(sp=2, tp=1)
ecfg = EngineConfig(**SETTINGS, sp=2)
MODELS = {"test-tiny": ckpt}
store = distributed.store()


def result(obj):
    print("RESULT " + json.dumps(obj), flush=True)


if rank == 0:
    sent = []
    send = spmd._Plane.send

    def recorded(self, op, a, b, *rest):
        sent.append([int(op), int(a), int(b)])
        return send(self, op, a, b, *rest)

    spmd._Plane.send = recorded
    eng = spmd.SPMDEngine(ecfg, mesh=mesh, blocklist_path=None, models=MODELS)
    eng.recover_interval = 3600.0  # the failed runtime stays failed
    rt = eng.runtimes["test-tiny"]
    tok = rt.tokenizer
    eng.start()

    def wait(req, budget=120):
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            item = req.stream.get(timeout=0.5)
            if item and item.kind in ("done", "error"):
                return item
        return None

    req = eng.enqueue_request("u", "", "test-tiny", prompt_tokens=tok.encode(PROMPT),
                              sampling=SamplingParams(max_tokens=NEW, temperature=0.0))
    item = wait(req)
    out = {"kind": item.kind if item else "timeout", "ids": req.generated_ids,
           "sp_prefills": rt.sp_prefill_dispatches,
           "sp_ops": [s for s in sent if s[0] == spmd.OP_PREFILL_SP],
           "prompt_len": len(tok.encode(PROMPT)), "seq": dict(mesh.seq.stats)}
    store.set("test/die", "1")
    t0 = time.monotonic()
    doomed = eng.enqueue_request("d", "", "test-tiny",
                                 prompt_tokens=tok.encode("ring " + PROMPT),
                                 sampling=SamplingParams(max_tokens=NEW,
                                                         temperature=0.0))
    item = wait(doomed)
    out["kill"] = {"kind": item.kind if item else "timeout",
                   "error": (item.error or "") if item else "",
                   "seconds": time.monotonic() - t0}
    time.sleep(HB_STALE + 1.0)
    out["kill"]["failed"] = rt._failed
    eng.health.check_once()
    out["kill"]["alerts"] = [a["name"] for a in eng.health.status()["alerts"]]
    eng.stop(report_timeout_s=2)
    result(out)
else:
    rotations = {"n": 0}
    rotate = SeqGroup.rotate

    def dying(self, x):
        if store.check(["test/die"]):
            rotations["n"] += 1
            if rotations["n"] == 2:  # the second layer's hand-off
                os._exit(7)  # hard death mid-ring: no status, no cleanup
        return rotate(self, x)

    SeqGroup.rotate = dying
    steps = spmd.run_worker(MODELS, ecfg, mesh)
    result({"steps": steps})
sys.stdout.flush()
os._exit(0)
""".replace("SETTINGS", repr(SETTINGS)).replace("PROMPT", repr(PROMPT)).replace(
    "NEW", str(NEW)).replace("HB_STALE", str(HB_STALE))


def _values(spec, rng):
    return [rng.integers(-1000, 1000, size=shape).astype(dt)
            if np.dtype(dt).kind in "iu" else rng.normal(size=shape).astype(dt)
            for shape, dt in spec]


@pytest.mark.parametrize("T", [192, 8192])
def test_prefill_sp_payload_matches_jax_and_round_trips(T, monkeypatch):
    """The JAX wire's order, shapes and dtypes for every value but the
    last (the JAX key is the port's generator state); the header and
    every value come back exactly over a real TCPStore."""
    from ollamamq_tpu.engine import spmd as jspmd

    S, MP, W = 4, 272, 64
    K = int(torch.Generator().get_state().numel())
    mine = spmd.payload_spec(spmd.OP_PREFILL_SP, T, 0, S, MP, W, K)
    theirs = jspmd.payload_spec(jspmd.OP_PREFILL_SP, T, 0, S, MP, W)
    assert [(tuple(s), np.dtype(d)) for s, d in mine[:-1]] == \
        [(tuple(s), np.dtype(d)) for s, d in theirs[:-1]]
    assert mine[-1] == ((K,), np.uint8)
    assert spmd.OP_PREFILL_SP == jspmd.OP_PREFILL_SP == 5
    assert spmd.OP_PREFILL_SP in spmd.DATA_OPS
    assert spmd._OP_SITE[spmd.OP_PREFILL_SP] == "sp_prefill"
    store = torch.distributed.TCPStore("127.0.0.1", 0, 1, is_master=True,
                                       timeout=datetime.timedelta(seconds=10),
                                       wait_for_workers=False)
    monkeypatch.setattr(spmd, "_client", lambda: store)
    spmd._reset_wire()
    values = _values(mine, np.random.default_rng(T))
    spmd._send(spmd.OP_PREFILL_SP, T, 0, 1, 0, values, S, MP, W, K)
    header, raw = spmd._recv_op(0)
    assert header.tolist() == [spmd.OP_PREFILL_SP, T, 0, 1, 0]
    got = spmd._unpack_payload(raw, mine)
    assert len(got) == len(values) == 12
    for g, v in zip(got, values):
        assert g.dtype == v.dtype and np.array_equal(g, v)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
    from ollamamq_tpu.models import weights as jweights
    from ollamamq_tpu_torch.models.weights import from_jax_numpy, save_safetensors

    jp = jweights.load_params(JAX_CONFIGS["test-tiny"], None, seed=0,
                              dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("ckpt"))
    save_safetensors(from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    MODEL_CONFIGS["test-tiny"]),
                     MODEL_CONFIGS["test-tiny"], path)
    return path


@pytest.fixture(scope="module")
def sp_world(tmp_path_factory, checkpoint):
    tmp = tmp_path_factory.mktemp("spmd_sp")
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    paths = [tmp / f"rank{r}.log" for r in range(2)]
    logs = [open(p, "w") for p in paths]
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(port),
                               checkpoint], cwd=REPO, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        deadline = time.monotonic() + 240
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail("ranks hung:\n" + paths[0].read_text()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    outs = []
    for p, path in zip(procs, paths):
        text = path.read_text()
        lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        outs.append((p.returncode, json.loads(lines[-1][7:]) if lines else None, text))
    (rc0, leader, log0), (rc1, _, log1) = outs
    assert rc0 == 0 and leader is not None, log0[-3000:]
    assert rc1 == 7, log1[-3000:]  # killed on purpose mid-ring
    return leader


def test_spmd_sp_prefill_two_processes(sp_world, checkpoint):
    """One OP_PREFILL_SP with a = T (the prompt padded to a multiple of
    the bucket rounded up to sp), one ring hand-off a layer, and the
    greedy ids of a one-rank port engine and of the JAX engine."""
    leader = sp_world
    assert leader["kind"] == "done" and leader["sp_prefills"] == 1
    n = leader["prompt_len"]
    assert [op[1] for op in leader["sp_ops"]] == [-(-n // 16) * 16]
    assert leader["seq"]["handoffs"] == MODEL_CONFIGS["test-tiny"].num_layers
    eng = TorchEngine(EngineConfig(**SETTINGS), device="cpu", blocklist_path=None,
                      models={"test-tiny": checkpoint})
    eng.start()
    try:
        tok = eng.runtimes["test-tiny"].tokenizer
        req = eng.enqueue_request("u", "", "test-tiny", prompt_tokens=tok.encode(PROMPT),
                                  sampling=SamplingParams(max_tokens=NEW,
                                                          temperature=0.0))
        assert collect(req)[-1].kind == "done"
        one_rank = req.generated_ids
    finally:
        eng.stop()
    assert leader["ids"] == one_rank
    assert one_rank == single_device_greedy_tokens(
        "test-tiny", PROMPT, max_tokens=NEW, num_pages=64, max_pages_per_seq=16)


def test_worker_killed_mid_ring_fails_the_request_loudly(sp_world):
    """Rank 1 dies in its second ring hand-off of a long prompt: the
    request errors within the heartbeat bound, the runtime is failed
    and worker_stale fires."""
    kill = sp_world["kill"]
    assert kill["kind"] == "error" and kill["seconds"] <= KILL_BOUND_S, kill
    assert "sp prefill failed" in kill["error"] or "stale" in kill["error"], kill
    assert kill["failed"] is True
    assert "worker_stale" in kill["alerts"]


MOE = "test-tiny-moe"
# argv: rank, port, checkpoint dir
SP_EP_CHILD = r"""
import json, os, sys, time
rank, port, ckpt = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import torch
torch.set_num_threads(1)
from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine import spmd
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.parallel import distributed
from ollamamq_tpu_torch.parallel.mesh import make_mesh

distributed.initialize(f"127.0.0.1:{port}", 4, rank, devices=["cpu"] * 4,
                       timeout_s=60)
mesh = make_mesh(sp=2, ep=2, tp=1)
ecfg = EngineConfig(**dict(SETTINGS, model="MOE"), sp=2, ep=2)
MODELS = {"MOE": ckpt}
if rank == 0:
    eng = spmd.SPMDEngine(ecfg, mesh=mesh, blocklist_path=None, models=MODELS)
    rt = eng.runtimes["MOE"]
    eng.start()
    req = eng.enqueue_request("u", "", "MOE",
                              prompt_tokens=rt.tokenizer.encode(PROMPT),
                              sampling=SamplingParams(max_tokens=NEW, temperature=0.0))
    deadline, item = time.monotonic() + 120, None
    while time.monotonic() < deadline:
        item = req.stream.get(timeout=0.5)
        if item and item.kind in ("done", "error"):
            break
    eng.stop(report_timeout_s=30)
    print("RESULT " + json.dumps({"kind": item.kind if item else "timeout",
                                  "ids": req.generated_ids,
                                  "sp_prefills": rt.sp_prefill_dispatches,
                                  "workers": eng.worker_reports,
                                  "me": eng.spmd_report()}), flush=True)
else:
    print("RESULT " + json.dumps({"steps": spmd.run_worker(MODELS, ecfg, mesh)}),
          flush=True)
sys.stdout.flush()
os._exit(0)
""".replace("SETTINGS", repr(SETTINGS)).replace("PROMPT", repr(PROMPT)).replace(
    "NEW", str(NEW)).replace("MOE", MOE)


def test_sp2_ep2_prefill_gives_one_ranks_ids(tmp_path):
    """sp 2 x ep 2 over four processes: a long prompt takes one
    OP_PREFILL_SP (the ring over seq, the experts over expert) and its
    greedy ids are the one-rank port engine's."""
    import jax
    import jax.numpy as jnp

    from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
    from ollamamq_tpu.models import weights as jweights
    from ollamamq_tpu_torch.models.weights import from_jax_numpy, save_safetensors

    jp = jweights.load_params(JAX_CONFIGS[MOE], None, seed=0, dtype=jnp.float32)
    ckpt = str(tmp_path / "ckpt")
    save_safetensors(from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    MODEL_CONFIGS[MOE]), MODEL_CONFIGS[MOE], ckpt)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    paths = [tmp_path / f"rank{r}.log" for r in range(4)]
    logs = [open(p, "w") for p in paths]
    procs = [subprocess.Popen([sys.executable, "-c", SP_EP_CHILD, str(r), str(port),
                               ckpt], cwd=REPO, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(4)]
    try:
        eng = TorchEngine(EngineConfig(**dict(SETTINGS, model=MOE)), device="cpu",
                          blocklist_path=None, models={MOE: ckpt})
        eng.start()
        try:
            tok = eng.runtimes[MOE].tokenizer
            req = eng.enqueue_request("u", "", MOE, prompt_tokens=tok.encode(PROMPT),
                                      sampling=SamplingParams(max_tokens=NEW,
                                                              temperature=0.0))
            assert collect(req)[-1].kind == "done"
            one_rank = req.generated_ids
        finally:
            eng.stop()
        deadline = time.monotonic() + 240
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    texts = [p.read_text() for p in paths]
    for p, text in zip(procs, texts):
        assert p.returncode == 0, text[-3000:]
    leader = json.loads([ln for ln in texts[0].splitlines()
                         if ln.startswith("RESULT ")][-1][7:])
    assert leader["kind"] == "done" and leader["sp_prefills"] == 1
    assert leader["ids"] == one_rank and len(one_rank) == NEW
    for w in leader["workers"]:
        assert w["ops"]["sp_prefill"] == 1
        assert w["digest"] == leader["me"]["digest"]
