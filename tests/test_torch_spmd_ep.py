"""Expert parallelism over the SPMD wire, on the CPU: the mirror of
tests/test_spmd_ep.py.

Each world is started once per module (rank 0 an SPMDEngine, the others
run_worker, one compute thread each, over gloo on a fresh port), in
float32, with the JAX seed-0 test-tiny-moe tree written as a safetensors
checkpoint that every rank loads. Every process is killed on the way out
and every wait is bounded.

  - ep 2 over two ranks (half the experts each): a prompt's greedy ids
    equal the JAX single_device_greedy_tokens and a one-rank port
    engine's, each rank holds half the expert bytes, both replayed the
    same ops to the same output digest; then rank 1 dies in an MoE
    layer's all_reduce of the next request: the request errors within
    the heartbeat bound, the runtime is failed and /health's
    worker_stale fires.
  - dp 2 x ep 2 over four ranks (replica 1 = ranks 2, 3, which do not
    include rank 0): the same prompt twice at once, one on each replica,
    both with the one-rank ids.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from testutil import collect, free_port, single_device_greedy_tokens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "test-tiny-moe"
SETTINGS = dict(model=NAME, max_slots=2, num_pages=32, page_size=8,
                max_pages_per_seq=8, prefill_buckets=(16,), max_new_tokens=8,
                decode_steps_per_iter=2, dtype="float32")
PROMPT = "experts apart"
NEW = 6
HB_STALE = 3.0
KILL_BOUND_S = HB_STALE + 12.0  # staleness + polls + transport slack

# argv: rank, port, world, dp, checkpoint dir
CHILD = r"""
import json, os, sys, time
rank, port, world, dp, ckpt = (int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]),
                               int(sys.argv[4]), sys.argv[5])
os.environ["OLLAMAMQ_SPMD_HB_EVERY"] = "0.5"
os.environ["OLLAMAMQ_SPMD_HB_STALE"] = "HB_STALE"
import torch
torch.set_num_threads(1)
from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine import spmd
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.parallel import distributed
from ollamamq_tpu_torch.parallel.mesh import ExpertGroup, make_mesh

distributed.initialize(f"127.0.0.1:{port}", world, rank, devices=["cpu"] * world,
                       timeout_s=60)
mesh = make_mesh(dp=dp, ep=2, tp=1)
ecfg = EngineConfig(**SETTINGS, dp=dp, ep=2)
MODELS = {"NAME": ckpt}
store = distributed.store()


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
    eng.recover_interval = 3600.0  # a failed runtime stays failed
    rs = eng.runtimes["NAME"]
    reps = getattr(rs, "replicas", [rs])
    tok = rs.tokenizer

    def enqueue(user):
        return eng.enqueue_request(user, "", "NAME", prompt_tokens=tok.encode(PROMPT),
                                   sampling=SamplingParams(max_tokens=NEW,
                                                           temperature=0.0))

    eng.start()
    before = [rt.tokens_generated for rt in reps]
    reqs = [enqueue(u) for u in ("a", "b")[:dp]]
    items = [wait(r) for r in reqs]
    out = {"kinds": [it.kind if it else "timeout" for it in items],
           "ids": [r.generated_ids for r in reqs],
           "per_replica": [rt.tokens_generated - b for rt, b in zip(reps, before)],
           "param_bytes": [rt.param_bytes for rt in reps],
           "expert_shape": list(reps[0].params["layers"][0]["we_gate"].shape)}
    if dp == 1:
        store.set("test/die", "1")
        t0 = time.monotonic()
        doomed = enqueue("d")
        item = wait(doomed)
        out["kill"] = {"kind": item.kind if item else "timeout",
                       "error": (item.error or "") if item else "",
                       "seconds": time.monotonic() - t0}
        time.sleep(HB_STALE + 1.0)
        out["kill"]["failed"] = rs._failed
        eng.health.check_once()
        out["kill"]["alerts"] = [a["name"] for a in eng.health.status()["alerts"]]
        eng.stop(report_timeout_s=2)
    else:
        eng.stop(report_timeout_s=30)
        out["workers"] = eng.worker_reports
        out["me"] = eng.spmd_report()
    result(out)
else:
    if dp == 1:
        calls = {"n": 0}
        reduce = ExpertGroup.all_reduce

        def dying(self, x):
            if store.check(["test/die"]):
                calls["n"] += 1
                if calls["n"] == 2:  # the second MoE layer's sum
                    os._exit(7)  # hard death mid-forward: no status, no cleanup
            return reduce(self, x)

        ExpertGroup.all_reduce = dying
    steps = spmd.run_worker(MODELS, ecfg, mesh)
    result({"steps": steps, "expert": mesh.coord["expert"]})
sys.stdout.flush()
os._exit(0)
""".replace("SETTINGS", repr(SETTINGS)).replace("PROMPT", repr(PROMPT)).replace(
    "NEW", str(NEW)).replace("HB_STALE", str(HB_STALE)).replace("NAME", NAME)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
    from ollamamq_tpu.models import weights as jweights
    from ollamamq_tpu_torch.models.weights import from_jax_numpy, save_safetensors

    jp = jweights.load_params(JAX_CONFIGS[NAME], None, seed=0, dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("ckpt"))
    save_safetensors(from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                    MODEL_CONFIGS[NAME]), MODEL_CONFIGS[NAME], path)
    return path


def _start(tmp, world, dp, ckpt):
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    paths = [tmp / f"rank{r}.log" for r in range(world)]
    logs = [open(p, "w") for p in paths]
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(port),
                               str(world), str(dp), ckpt], cwd=REPO, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]

    def wait():
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
            outs.append((p.returncode, json.loads(lines[-1][7:]) if lines else None,
                         text))
        return outs

    return wait


def _one_rank_ids(ckpt):
    eng = TorchEngine(EngineConfig(**SETTINGS), device="cpu", blocklist_path=None,
                      models={NAME: ckpt})
    eng.start()
    try:
        tok = eng.runtimes[NAME].tokenizer
        req = eng.enqueue_request("u", "", NAME, prompt_tokens=tok.encode(PROMPT),
                                  sampling=SamplingParams(max_tokens=NEW,
                                                          temperature=0.0))
        assert collect(req)[-1].kind == "done"
        return req.generated_ids, eng.runtimes[NAME].param_bytes
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, checkpoint):
    waits = {dp: _start(tmp_path_factory.mktemp(f"ep_dp{dp}"), 2 * dp, dp, checkpoint)
             for dp in (1, 2)}
    one = _one_rank_ids(checkpoint)
    return one, {dp: w() for dp, w in waits.items()}


def test_ep2_two_processes_match_single_device(worlds):
    """Half the experts a rank; greedy ids of the JAX single device
    engine and of a one-rank port engine; every rank replayed."""
    (one_ids, one_bytes), outs = worlds
    (rc0, leader, log0), (rc1, _, log1) = outs[1]
    assert rc0 == 0 and leader is not None, log0[-3000:]
    assert rc1 == 7, log1[-3000:]  # killed on purpose, after the first request
    assert leader["kinds"] == ["done"] and leader["ids"] == [one_ids]
    assert one_ids == single_device_greedy_tokens(NAME, PROMPT, max_tokens=NEW)
    cfg = MODEL_CONFIGS[NAME]
    assert leader["expert_shape"] == [cfg.num_experts // 2, cfg.hidden_size,
                                      cfg.intermediate_size]
    # Half of every expert stack: 3 stacks of E x D x F float32 a layer.
    half = cfg.num_layers * 3 * (cfg.num_experts // 2) * cfg.hidden_size \
        * cfg.intermediate_size * 4
    assert leader["param_bytes"] == [one_bytes - half]


def test_killed_expert_rank_fails_requests_within_the_bound(worlds):
    """Rank 1 dies in an MoE layer's all_reduce: the request errors
    within the heartbeat bound, the runtime is failed and worker_stale
    fires; nothing hangs."""
    _, outs = worlds
    kill = outs[1][0][1]["kill"]
    assert kill["kind"] == "error" and kill["seconds"] <= KILL_BOUND_S, kill
    assert kill["failed"] is True
    assert "worker_stale" in kill["alerts"]


def test_dp2_ep2_each_replica_gives_one_ranks_ids(worlds):
    """dp 2 x ep 2 over four ranks: one request on each replica, both
    with the one-rank ids; every rank exits cleanly and each worker
    replayed its own replica's ops."""
    (one_ids, _), outs = worlds
    for rc, res, text in outs[2]:
        assert rc == 0 and res is not None, text[-3000:]
    leader = outs[2][0][1]
    assert leader["kinds"] == ["done", "done"]
    assert leader["ids"] == [one_ids, one_ids]
    assert all(n > 0 for n in leader["per_replica"]), leader["per_replica"]
    assert [res["expert"] for _, res, _ in outs[2][1:]] == [1, 0, 1]
    reports = {w["rank"]: w for w in leader["workers"]}
    assert sorted(reports) == [1, 2, 3]
    assert reports[1]["digest"] == leader["me"]["digest"]
    assert reports[2]["digest"] == reports[3]["digest"]
