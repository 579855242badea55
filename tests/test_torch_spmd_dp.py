"""Data-parallel replicas over the rank world, on the CPU: the mirror of
tests/test_spmd_recovery.py::test_spmd_dp_replicas_across_hosts.

Each world is started once per module and runs every scenario in turn
(rank 0 SPMDEngine, the others run_worker, one compute thread each, over
gloo on a fresh port), in float32, with the JAX seed-0 test-tiny tree
written as a safetensors checkpoint that every rank loads. Every process
is killed on the way out and every wait is bounded.

dp 2 x tp 2 over four ranks (replica 0 = ranks 0, 1; replica 1 = ranks
2, 3, which do not include rank 0):

  - the same prompt twice at once: both replicas serve one, with
    identical greedy ids, equal to a one-rank port engine's and to the
    JAX single_device_greedy_tokens on the same weights; every worker
    replayed >= 4 ops of its own replica and none of the other's;
  - a failed replay on rank 3 (after its dispatch ran): the request on
    replica 1 errors loudly, OP_RELOAD rebuilds model 0's replica 1 on
    ranks 2 and 3 only, the request on replica 0 finishes, and after the
    reload both replicas serve the prompt's ids again;
  - rank 0's /metrics, scraped once every rank's posted snapshot has
    settled, merges the three other ranks' snapshots (replica 1's ranks
    keep registries of their own) once each.

dp 2 over two ranks (one rank a replica): the same prompt on both
replicas; a sampled request on replica 1, whose generator state comes
back to rank 0 after every op (rank 0's copy equals the worker's); then
rank 1 killed -9 mid-stream: replica 1's request errors within the
heartbeat bound while replica 0's finishes, and replica 0 serving on
reclaims the op keys of the wire (the dead rank's cursor no longer
holds them).
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
from test_torch_spmd import assert_federated
from testutil import collect, free_port, single_device_greedy_tokens

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTINGS = dict(model="test-tiny", max_slots=2, num_pages=64, page_size=8,
                max_pages_per_seq=16, max_new_tokens=8,
                decode_steps_per_iter=2, dtype="float32")
PROMPT = "dp across hosts"
NEW = 6
HB_STALE = 3.0
KILL_BOUND_S = HB_STALE + 12.0  # staleness + polls + transport slack

# argv: rank, port, world, dp, checkpoint dir
CHILD = r"""
import hashlib, json, os, sys, time
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
from ollamamq_tpu_torch.parallel.mesh import make_mesh

distributed.initialize(f"127.0.0.1:{port}", world, rank, devices=["cpu"] * world,
                       timeout_s=60)
mesh = make_mesh(dp=dp, tp=world // dp)
ecfg = EngineConfig(**SETTINGS, dp=dp)
MODELS = {"test-tiny": ckpt}
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
    eng.recover_interval = 0.5
    rs = eng.runtimes["test-tiny"]
    tok = rs.tokenizer

    def enqueue(user, n, temperature=0.0):
        return eng.enqueue_request(user, "", "test-tiny", prompt_tokens=tok.encode(PROMPT),
                                   sampling=SamplingParams(max_tokens=n,
                                                           temperature=temperature))

    def pair(n=NEW):
        before = [rt.tokens_generated for rt in rs.replicas]
        reqs = [enqueue(u, n) for u in ("a", "b")]
        items = [wait(r) for r in reqs]
        return {"ids": [r.generated_ids for r in reqs],
                "kinds": [it.kind if it else "timeout" for it in items],
                "per_replica": [rt.tokens_generated - b
                                for rt, b in zip(rs.replicas, before)]}

    def placed(reqs, budget=60):
        # {replica: request} once each request sits in a replica.
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            where = {i: r for i, rt in enumerate(rs.replicas)
                     for r in reqs if any(q is r for q in rt.held_requests())}
            if len(where) == len(reqs):
                return where
            time.sleep(0.002)
        raise TimeoutError("requests never placed")

    def outcome(req, t0=None):
        item = wait(req)
        out = [item.kind if item else "timeout", (item.error or "") if item else "",
               len(req.generated_ids)]
        return out + ([time.monotonic() - t0] if t0 is not None else [])

    eng.start()
    out = {"n_replicas": len(rs.replicas), "serve": pair(),
           "param_bytes": rs.param_bytes, "kv_bytes": rs.kv_bytes,
           "rep_bytes": [rt.param_bytes for rt in rs.replicas]}
    if world == 4:
        # A failed replay on rank 3 (replica 1) while each replica
        # decodes one request.
        store.set("test/trip", "1")
        where = placed([enqueue("x", 16), enqueue("y", 16)])
        out["desync"] = {str(i): outcome(r) for i, r in where.items()}
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if not any(rt._failed for rt in rs.replicas) and eng.journal.tail(kind="rebuild"):
                break
            time.sleep(0.1)
        out["recovered"] = not any(rt._failed for rt in rs.replicas)
        out["rebuilds"] = len(eng.journal.tail(kind="rebuild"))
        out["after"] = pair()
        # Rank 0's scrape once every rank's posted snapshot has settled.
        sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
        from test_torch_spmd import federated_scrape

        out["metrics"] = federated_scrape(eng, [eng._plane])
    else:
        # Sampled requests on both replicas: replica 1's generator state
        # comes back to rank 0 after every op.
        where = placed([enqueue("s0", 12, 0.9), enqueue("s1", 12, 0.9)])
        out["sampled"] = {str(i): outcome(r) for i, r in where.items()}
        out["gen"] = hashlib.sha256(
            rs.replicas[1].gen.get_state().numpy().tobytes()).hexdigest()
        # Decode chunks out on replica 1's rank and not collected yet.
        out["deferred_at_read"] = len(eng._deferred)
        # kill -9 of rank 1 (replica 1) while both replicas decode.
        store.set("test/die", "1")
        t0 = time.monotonic()
        where = placed([enqueue("k", 40), enqueue("l", 40)])
        out["kill"] = {str(i): outcome(r, t0) for i, r in where.items()}
        out["kill"]["failed"] = [rt._failed for rt in rs.replicas]
        # Rank 1's cursor froze at its death: the op keys sent since are
        # reclaimed all the same once the wire passes a cleanup point.
        dead_at = spmd._wire.seq
        while spmd._wire.seq <= dead_at + 2 * spmd.CURSOR_EVERY:
            assert wait(enqueue("z", 8)).kind == "done"
        out["wire"] = {"dead_at": dead_at, "deleted": spmd._wire.deleted,
                       "left": sum(store.check([f"ollamamq/op/{i}"])
                                   for i in range(spmd._wire.deleted))}
    eng.stop(report_timeout_s=5)
    out["me"] = eng.spmd_report()
    out["workers"] = eng.worker_reports
    result(out)
else:
    state = {"tripped": False, "decodes": 0}
    orig, orig_post = spmd._replay, spmd._post_result

    def replay(rt, op, a, b, payload):
        if world == 2 and op == spmd.OP_DECODE and store.check(["test/die"]):
            state["decodes"] += 1
            if state["decodes"] >= 2:
                os._exit(7)  # hard death: no cleanup, no status, no result
        out = orig(rt, op, a, b, payload)
        if (world == 4 and rank == 3 and op == spmd.OP_DECODE
                and not state["tripped"] and store.check(["test/trip"])):
            # Fail AFTER the dispatch ran: this rank's state is lost.
            state["tripped"] = True
            rt.recent.zero_()
            raise RuntimeError("injected worker decode failure")
        return out

    def post(seq, ok, rt, out):
        # The line goes out BEFORE the result does: once rank 0 holds the
        # result it may read its copy and set test/die at once, and a
        # check made after the post would then drop this op's line.
        if ok and not store.check(["test/die"]):
            print("GEN " + hashlib.sha256(
                rt.gen.get_state().numpy().tobytes()).hexdigest(), flush=True)
        orig_post(seq, ok, rt, out)

    spmd._replay, spmd._post_result = replay, post
    if world == 4:
        sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
        from test_torch_spmd import probe_worker_metrics

        probe_worker_metrics()
    steps = spmd.run_worker(MODELS, ecfg, mesh)
    result({"rank": rank, "steps": steps, "tripped": state["tripped"]})
sys.stdout.flush()
os._exit(0)
""".replace("SETTINGS", repr(SETTINGS)).replace("PROMPT", repr(PROMPT)).replace(
    "NEW", str(NEW)).replace("HB_STALE", str(HB_STALE))


def _run_world(tmp_path, world, dp, ckpt, timeout=180):
    """Every rank of CHILD; their (return code, RESULT object or None,
    log). Each process is killed on the way out."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    paths = [tmp_path / f"dp{world}_rank{r}.log" for r in range(world)]
    logs = [open(p, "w") for p in paths]
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(port),
                               str(world), str(dp), ckpt], cwd=REPO, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"world {world}: ranks hung:\n"
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
        text = path.read_text()
        lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        outs.append((p.returncode, json.loads(lines[-1][7:]) if lines else None,
                     text))
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
def one_rank_ids(jax_checkpoint):
    """The prompt's greedy ids from a one-rank port engine (dp 1) on the
    same checkpoint."""
    eng = TorchEngine(EngineConfig(**SETTINGS), device="cpu", blocklist_path=None,
                      models={"test-tiny": jax_checkpoint})
    eng.start()
    try:
        tok = eng.runtimes["test-tiny"].tokenizer
        req = eng.enqueue_request("u", "", "test-tiny", prompt_tokens=tok.encode(PROMPT),
                                  sampling=SamplingParams(max_tokens=NEW,
                                                          temperature=0.0))
        assert collect(req)[-1].kind == "done"
        return req.generated_ids
    finally:
        eng.stop()


@pytest.fixture(scope="module")
def dp_tp_world(tmp_path_factory, jax_checkpoint):
    outs = _run_world(tmp_path_factory.mktemp("dp2tp2"), 4, 2, jax_checkpoint)
    for rc, res, log in outs:
        assert rc == 0 and res is not None, log[-3000:]
    return [res for _, res, _ in outs], [log for _, _, log in outs]


@pytest.fixture(scope="module")
def dp_world(tmp_path_factory, jax_checkpoint):
    outs = _run_world(tmp_path_factory.mktemp("dp2"), 2, 2, jax_checkpoint)
    (rc0, leader, log0), (rc1, worker, log1) = outs
    assert rc0 == 0 and leader is not None, log0[-3000:]
    assert rc1 == 7, log1[-3000:]  # killed on purpose in the last scenario
    return leader, worker, log1


def test_dp_tp_replicas_serve_identical_ids(dp_tp_world, one_rank_ids):
    (leader, *workers), _ = dp_tp_world
    assert leader["n_replicas"] == 2
    serve = leader["serve"]
    assert serve["kinds"] == ["done", "done"]
    # Both replicas served one, and greedy decode of the same prompt on
    # either replica agrees exactly (the replica ordinal kept each
    # replica's ranks in step).
    assert all(n > 0 for n in serve["per_replica"]), serve
    assert serve["ids"][0] == serve["ids"][1] == one_rank_ids
    assert one_rank_ids == single_device_greedy_tokens("test-tiny", PROMPT,
                                                       max_tokens=NEW)
    # Rank 0 views replica 1 as host state: the bytes of its own slice.
    assert leader["rep_bytes"][0] == leader["rep_bytes"][1] > 0
    assert leader["param_bytes"] == 2 * leader["rep_bytes"][0]


def test_dp_tp_workers_replay_their_own_replica_only(dp_tp_world):
    (leader, *_), _ = dp_tp_world
    reports = {w["rank"]: w for w in leader["workers"]}
    assert sorted(reports) == [1, 2, 3]
    assert [reports[r]["replica"] for r in (1, 2, 3)] == [0, 1, 1]
    for r in (1, 2, 3):
        ops = reports[r]["ops"]
        assert ops["ragged"] + ops["decode"] >= 4, ops
    # Rank 1 computes replica 0 alongside rank 0: the same outputs.
    assert reports[1]["digest"] == leader["me"]["digest"]
    # Rank 0's own ops are replica 0's: those rank 1 replayed.
    assert leader["me"]["ops"] == reports[1]["ops"]


def test_dp_tp_leader_metrics_sum_every_rank(dp_tp_world):
    """Rank 0's /metrics merges every other rank's posted snapshot once,
    the ranks of replica 1 (which keep their own registries) included."""
    (leader, *_), _ = dp_tp_world
    assert_federated(leader["metrics"], 3)


def test_dp_tp_failed_replay_in_replica_1_is_loud_then_reloads(dp_tp_world,
                                                               one_rank_ids):
    (leader, *_), logs = dp_tp_world
    reports = {w["rank"]: w for w in leader["workers"]}
    d = leader["desync"]
    assert d["1"][0] == "error" and "failed replaying" in d["1"][1], d
    assert "replica 1" in d["1"][1]
    # Replica 0 kept serving its request through replica 1's failure.
    assert d["0"][0] == "done" and d["0"][2] == 16, d
    assert leader["recovered"] and leader["rebuilds"] >= 1
    # OP_RELOAD rebuilt model 0's replica 1 on its ranks, nothing else.
    assert reports[1]["reloads"] == []
    assert reports[2]["reloads"] == reports[3]["reloads"] == [[0, 1]]
    assert "injected worker decode failure" in logs[3]
    after = leader["after"]
    assert after["kinds"] == ["done", "done"]
    assert all(n > 0 for n in after["per_replica"]), after
    assert after["ids"] == [one_rank_ids, one_rank_ids]


def test_dp_over_two_ranks_serves_and_returns_the_generator(dp_world,
                                                            one_rank_ids):
    leader, _, log1 = dp_world
    serve = leader["serve"]
    assert serve["kinds"] == ["done", "done"]
    assert all(n > 0 for n in serve["per_replica"]), serve
    assert serve["ids"] == [one_rank_ids, one_rank_ids]
    s = leader["sampled"]
    assert [s[i][0] for i in ("0", "1")] == ["done", "done"], s
    assert all(s[i][2] > 0 for i in ("0", "1"))
    # The state of replica 1's generator that its rank last posted (before
    # the kill) is rank 0's copy: the next plan starts from it.
    posted = [ln[4:] for ln in log1.splitlines() if ln.startswith("GEN ")]
    assert leader["deferred_at_read"] == 0
    assert posted and posted[-1] == leader["gen"]


def test_dp_kill_of_replica_1_fails_its_requests_replica_0_serves(dp_world):
    leader, _, _ = dp_world
    kill = leader["kill"]
    kind, error, _, seconds = kill["1"]
    assert kind == "error" and seconds <= KILL_BOUND_S, kill
    assert "heartbeat went stale" in error
    assert kill["0"][0] == "done" and kill["0"][2] == 40, kill
    assert kill["failed"] == [False, True]
    # The dead replica's frozen cursor does not pin the op keys in rank
    # 0's store: those sent after its death are deleted too.
    wire = leader["wire"]
    assert wire["deleted"] > wire["dead_at"] and wire["left"] == 0, wire
