"""Data-parallel replicas in one process: the port's ReplicaSet against
the JAX package's.

The mirror of tests/test_dp_replicas.py, of the ReplicaSet cases of
tests/test_correctness_edges.py (:107, :113, :122) and of the dp mesh
shapes of tests/test_sharding.py:28. The port serves dp 2 in one process
on two CPU "devices" (one engine, module-scoped), in float32, with the
JAX package's seed-0 test-tiny-gqa tree bridged through from_jax_numpy;
the JAX TPUEngine serves dp 2 x tp 4 on the 8 virtual CPU devices from
the same seed. Greedy f32 ids must be identical.

  - the replicas hold separate weights and pools (no storage shared);
  - two concurrent requests land on different replicas, and each
    replica's ids equal the JAX engine's at dp 2;
  - placement, rotation, cancellation of a request a replica holds, and
    fairness counters shared across replicas;
  - both decode dispatches come before the first collect (event order);
  - the same stub replicas and load scripts give the same picks in both
    packages' ReplicaSet, and stats() / merge_prefix_cache_stats agree.

The mesh of tests/test_sharding.py's multi-host dp rule
(_pick_per_process) has no counterpart: a rank here owns one device, so
a replica is a set of ranks (parallel/mesh.py).
"""

import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.engine.engine import ReplicaSet as JaxReplicaSet
from ollamamq_tpu.engine.engine import TPUEngine
from ollamamq_tpu.engine.engine import \
    merge_prefix_cache_stats as jax_merge_prefix_cache_stats
from ollamamq_tpu.models import weights as jweights
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.engine.engine import (ModelRuntime, ReplicaSet,
                                              TorchEngine,
                                              merge_prefix_cache_stats)
from ollamamq_tpu_torch.engine.request import FinishReason, Request
from ollamamq_tpu_torch.models import weights
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.parallel.mesh import (AXES, make_mesh, replica_of,
                                              replica_ranks, replica_submesh)
from testutil import collect

MODEL = "test-tiny-gqa"
# tests/test_dp_replicas.py's dp_cfg, in float32 (tp 4 is the JAX side's).
SETTINGS = dict(model=MODEL, max_slots=2, num_pages=64, page_size=8,
                max_pages_per_seq=16, prefill_buckets=(16, 32, 64),
                max_new_tokens=8, decode_steps_per_iter=2, dp=2)
PROMPT = "same prompt"


@pytest.fixture(scope="module")
def jax_params_np():
    jp = jweights.load_params(JAX_CONFIGS[MODEL], None, seed=0,
                              dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jp)


@pytest.fixture(scope="module")
def dp_engine(jax_params_np):
    eng = TorchEngine(EngineConfig(**SETTINGS, dtype="float32"), device="cpu",
                      blocklist_path=None,
                      params=weights.from_jax_numpy(jax_params_np,
                                                    MODEL_CONFIGS[MODEL]))
    eng.start()
    yield eng
    eng.stop()


def _enqueue(eng, user, prompt, max_tokens, sampling=SamplingParams):
    tok = eng.runtimes[MODEL].tokenizer
    return eng.enqueue_request(user, "", MODEL, prompt_tokens=tok.encode(prompt),
                               sampling=sampling(max_tokens=max_tokens,
                                                 temperature=0.0))


def test_replicas_hold_separate_weights_and_pools(dp_engine):
    """dp=2 builds two runtimes, each on its own device of the in-process
    mesh, whose weights and KV pools share no storage (replication of the
    model, not of the work): the set's bytes are twice one replica's."""
    rs = dp_engine.runtimes[MODEL]
    assert isinstance(rs, ReplicaSet) and len(rs.replicas) == 2
    assert [rt.replica for rt in rs.replicas] == [0, 1]
    assert all(rt.device == torch.device("cpu") for rt in rs.replicas)
    ptrs = []
    for rt in rs.replicas:
        own = {t.data_ptr() for t in weights.leaves(rt.params)}
        own |= {rt.kc.data_ptr(), rt.vc.data_ptr(), rt.recent.data_ptr()}
        ptrs.append(own)
    assert ptrs[0] and ptrs[1] and ptrs[0].isdisjoint(ptrs[1])
    # Equal values: one tree, copied.
    for a, b in zip(weights.leaves(rs.replicas[0].params),
                    weights.leaves(rs.replicas[1].params)):
        assert torch.equal(a, b)
    one = rs.replicas[0]
    assert rs.param_bytes == 2 * one.param_bytes > 0
    assert rs.kv_bytes == 2 * one.kv_bytes > 0
    assert rs.stats()["replicas"] == 2


def _jax_dp_ids():
    """The JAX TPUEngine at dp 2 x tp 4 (its seed-0 weights), the same
    two concurrent requests."""
    eng = TPUEngine(JaxEngineConfig(**SETTINGS, tp=4), blocklist_path=None,
                    dtype=jnp.float32)
    eng.start()
    try:
        rs = eng.runtimes[MODEL]
        tok = rs.tokenizer
        reqs = [eng.enqueue_request(u, "", MODEL, prompt_tokens=tok.encode(PROMPT),
                                    sampling=JaxSampling(max_tokens=6,
                                                         temperature=0.0))
                for u in ("dp-a", "dp-b")]
        outs = [collect(r) for r in reqs]
        assert all(o[-1].kind == "done" for o in outs)
        return [r.generated_ids for r in reqs], [rt.tokens_generated
                                                 for rt in rs.replicas]
    finally:
        eng.stop()


def test_two_requests_land_on_different_replicas(dp_engine):
    """Least-loaded placement spreads concurrent requests across replicas,
    both generate correctly (greedy => identical outputs for identical
    prompts, which also pins the replicas' weights equal), and each
    replica's ids equal the JAX engine's at dp 2."""
    rs = dp_engine.runtimes[MODEL]
    reqs = [_enqueue(dp_engine, u, PROMPT, 6) for u in ("dp-a", "dp-b")]
    outs = [collect(r) for r in reqs]
    assert all(o[-1].kind == "done" for o in outs)
    assert all(rt.tokens_generated > 0 for rt in rs.replicas), [
        rt.tokens_generated for rt in rs.replicas]
    assert reqs[0].generated_ids == reqs[1].generated_ids
    jax_ids, jax_per_replica = _jax_dp_ids()
    assert all(n > 0 for n in jax_per_replica)
    assert [r.generated_ids for r in reqs] == jax_ids


class FakeReplica:
    """tests/test_dp_replicas.py's stub replica."""

    name = "fake"
    cfg = ecfg = None

    def __init__(self):
        self.pending_prefill = []
        self.chunking = []
        self.submitted = []
        self.capacity = True

    def has_capacity(self, kind=None):
        return self.capacity

    def active_count(self):
        return len(self.submitted)

    def submit(self, req):
        self.submitted.append(req.name)
        return True


def test_least_loaded_placement_and_rotation():
    """Placement picks the least-loaded replica; ties rotate (reference
    least-conn + rotate-after-last, dispatcher.rs:475-487)."""

    def _req(name):
        return SimpleNamespace(name=name, kind="generate")

    a, b, c = FakeReplica(), FakeReplica(), FakeReplica()
    rs = ReplicaSet([a, b, c])
    # All empty: rotation starts after index 0 => b, then ties rotate c, a.
    rs.submit(_req("r1"))
    assert b.submitted == ["r1"]
    rs.submit(_req("r2"))
    assert c.submitted == ["r2"]
    rs.submit(_req("r3"))
    assert a.submitted == ["r3"]
    # Load-based: make b busiest, c without capacity => a wins.
    b.submitted += ["x", "y"]
    c.capacity = False
    rs.submit(_req("r4"))
    assert a.submitted == ["r3", "r4"]


def test_cancel_reaches_replica_held_request(dp_engine):
    """engine.cancel() finds requests held INSIDE a replica (client
    disconnects must cancel and reclaim under dp > 1, not run to
    max_tokens)."""
    rs = dp_engine.runtimes[MODEL]
    eos = [rt.tokenizer.eos_id for rt in rs.replicas]
    for rt in rs.replicas:
        rt.tokenizer.eos_id = -1  # keep generating until cancelled
    try:
        free_before = [rt.alloc.free_pages for rt in rs.replicas]
        req = _enqueue(dp_engine, "dp-cancel", "cancel me", 10_000)
        deadline = time.monotonic() + 60
        while not req.stats.first_token_at and time.monotonic() < deadline:
            time.sleep(0.01)
        assert req.stats.first_token_at, "never started generating"
        dp_engine.cancel(req.req_id)
        items = collect(req)
        assert items[-1].finish_reason == FinishReason.CANCELLED
        deadline = time.monotonic() + 10
        while ([rt.alloc.free_pages for rt in rs.replicas] != free_before
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert [rt.alloc.free_pages for rt in rs.replicas] == free_before
    finally:
        for rt, e in zip(rs.replicas, eos):
            rt.tokenizer.eos_id = e


def test_fairness_counters_shared_across_replicas(dp_engine):
    """Replicas share ONE scheduler core: processed counts accumulate per
    user whichever replica served them."""
    snap = dp_engine.core.snapshot()
    assert snap["users"]["dp-a"]["processed"] >= 1
    assert snap["users"]["dp-b"]["processed"] >= 1


def test_journal_invariants_hold_across_replicas(dp_engine):
    """Both replicas number their slots from 0: the decision journal keys
    each slot record by its replica (replica 1's records carry it,
    replica 0's read as the one-replica journal), so four concurrent
    requests leave check_invariants clean."""
    from ollamamq_tpu_torch.telemetry.journal import check_invariants

    reqs = [_enqueue(dp_engine, f"dp-j{i}", f"journal {i}", 5) for i in range(4)]
    assert all(collect(r)[-1].kind == "done" for r in reqs)
    recs = dp_engine.journal.tail(n=None)
    installs = [r for r in recs if r["kind"] == "install"]
    assert {r.get("dp_replica", 0) for r in installs} == {0, 1}
    assert all(r.get("dp_replica") != 0 for r in recs)  # 0 is never written
    assert check_invariants(recs) == []


def test_dp_decode_dispatches_overlap_before_any_collect(jax_params_np):
    """The throughput point of dp: the engine loop dispatches EVERY
    replica's decode chunk before it blocks on any, so replicas on other
    devices run at once. Asserted structurally (dispatch / collect event
    order), not by wall clock."""
    eng = TorchEngine(EngineConfig(**SETTINGS, dtype="float32"), device="cpu",
                      blocklist_path=None,
                      params=weights.from_jax_numpy(jax_params_np,
                                                    MODEL_CONFIGS[MODEL]))
    rs = eng.runtimes[MODEL]
    tok = rs.tokenizer
    events = []
    orig_dispatch = ModelRuntime.step_decode_dispatch
    orig_collect = ModelRuntime.step_decode_collect

    def rec_dispatch(self, core, k_steps=1):
        h = orig_dispatch(self, core, k_steps=k_steps)
        if h is not None:
            events.append(("dispatch", self.replica))
        return h

    def rec_collect(self, handle, core):
        events.append(("collect", self.replica))
        return orig_collect(self, handle, core)

    ModelRuntime.step_decode_dispatch = rec_dispatch
    ModelRuntime.step_decode_collect = rec_collect
    try:
        # One request per replica, prefilled by hand (no loop thread: the
        # ticks are driven here for a deterministic order).
        for i, rep in enumerate(rs.replicas):
            req = Request(9000 + i, f"ovl{i}", MODEL, tok.encode("overlap probe"),
                          SamplingParams(max_tokens=64))
            assert rep.submit(req)
            assert rep.step_ragged(eng.core)
        events.clear()
        eng._loop_once()
        assert [e[0] for e in events] == ["dispatch", "dispatch",
                                          "collect", "collect"], events
        assert {e[1] for e in events[:2]} == {0, 1}
    finally:
        ModelRuntime.step_decode_dispatch = orig_dispatch
        ModelRuntime.step_decode_collect = orig_collect
        for rep in rs.replicas:
            for s, r in enumerate(rep.slot_req):
                if r is not None:
                    rep._finish_slot(s, FinishReason.CANCELLED, eng.core)


# --------------------------------------- ReplicaSet against the JAX class
class StubReplica:
    """tests/test_correctness_edges.py's stub, with a stats() row."""

    def __init__(self, capacity, load, failed=False, pending=0, chunking=0,
                 row=None):
        self.name = "stub"
        self.cfg = None
        self.ecfg = None
        self._capacity = capacity
        self._load_n = load
        self._failed = failed
        self.pending_prefill = [None] * pending
        self.pending_embed = []
        self.chunking = [None] * chunking
        self.submitted = []
        self.row = row or {}

    def has_capacity(self, kind=None):
        return self._capacity

    def active_count(self):
        return self._load_n

    def submit(self, req):
        self.submitted.append(req)
        self._load_n += 1
        return True

    def stats(self):
        return dict(self.row)


def _stubs(spec):
    return [StubReplica(*s) for s in spec]


@pytest.mark.parametrize("spec,script", [
    # (capacity, load, failed, pending, chunking) per replica; a script of
    # ("submit" | "force" | ("cap", i, bool) | ("load", i, n)) steps.
    ([(True, 0), (True, 0), (True, 0)], ["submit"] * 7),
    ([(True, 2), (True, 0, False, 1), (True, 0, False, 0, 2), (True, 1)],
     ["submit"] * 5 + [("cap", 1, False), "submit", "submit"]),
    ([(False, 1), (False, 0)], ["submit", "submit"]),
    ([(False, 3), (False, 1, True), (False, 2)], ["force", "force"]),
    ([(True, 0), (False, 0), (True, 5)],
     ["submit", ("cap", 1, True), ("load", 2, 0), "submit", "submit",
      ("cap", 0, False), ("cap", 1, False), ("cap", 2, False), "submit",
      "force"]),
], ids=["ties-rotate", "least-loaded", "refuses-when-full",
        "force-least-loaded-live", "mixed"])
def test_replicaset_picks_equal_the_jax_replicaset(spec, script):
    """The same stub replicas and the same load script give the same pick
    sequence in both packages' ReplicaSet: least-loaded with ties
    rotating after the last pick, False when no replica has capacity
    (nothing submitted), force_submit on the least-loaded live one."""
    picks = []
    for cls in (ReplicaSet, JaxReplicaSet):
        reps = _stubs(spec)
        rs = cls(reps)
        seq = []
        for step in script:
            if step == "submit":
                before = [len(r.submitted) for r in reps]
                ok = rs.submit(SimpleNamespace(kind="generate"))
                after = [len(r.submitted) for r in reps]
                seq.append((ok, [i for i in range(len(reps))
                                 if after[i] > before[i]]))
            elif step == "force":
                before = [len(r.submitted) for r in reps]
                rs.force_submit(SimpleNamespace(kind="generate"))
                seq.append(("force", [i for i, r in enumerate(reps)
                                      if len(r.submitted) > before[i]]))
            elif step[0] == "cap":
                reps[step[1]]._capacity = step[2]
            else:
                reps[step[1]]._load_n = step[2]
        picks.append(seq)
    assert picks[0] == picks[1] and len(picks[0]) == sum(
        step in ("submit", "force") for step in script)


def test_replicaset_submit_refuses_when_full():
    rs = ReplicaSet(_stubs([(False, 1), (False, 0)]))
    assert rs.submit(SimpleNamespace(kind="generate")) is False
    assert all(not r.submitted for r in rs.replicas)


def test_replicaset_force_submit_picks_least_loaded_live():
    a, b, c = _stubs([(False, 3), (False, 1, True), (False, 2)])
    rs = ReplicaSet([a, b, c])
    rs.force_submit(object())
    # b is failed; c is the least-loaded live replica.
    assert c.submitted and not a.submitted and not b.submitted


def test_place_requeues_when_replica_capacity_races_away():
    """A runtime that refuses at placement (the capacity raced away after
    the native gate) puts the request back at the FRONT of its user's
    queue under a fresh id: per-user FIFO survives the race."""
    eng = TorchEngine(EngineConfig(model="test-tiny", max_slots=2, num_pages=32,
                                   page_size=8, max_pages_per_seq=8,
                                   decode_steps_per_iter=2, dtype="float32"),
                      device="cpu", blocklist_path=None)
    rt = eng.runtimes["test-tiny"]
    rt.submit = lambda req: False
    req = eng.enqueue_request("edgeD", "", "test-tiny", prompt_tokens=[1, 2],
                              sampling=SamplingParams(max_tokens=2))
    popped = eng.core.next(eligible_models=["test-tiny"])
    assert popped is not None and popped[0] == req.req_id
    assert eng._place(req, "edgeD", "test-tiny") is False
    snap = eng.core.snapshot()
    assert snap["users"]["edgeD"]["queued"] == 1
    assert req.req_id in eng.pending and req.req_id != popped[0]
    req_b = eng.enqueue_request("edgeD", "", "test-tiny", prompt_tokens=[3, 4],
                                sampling=SamplingParams(max_tokens=2))
    nxt = eng.core.next(eligible_models=["test-tiny"])
    assert nxt is not None and nxt[0] == req.req_id  # A first
    nxt2 = eng.core.next(eligible_models=["test-tiny"])
    assert nxt2 is not None and nxt2[0] == req_b.req_id


def _stats_row(rng, cache):
    row = {"model": "stub", "weights_dtype": "bfloat16", "kv_dtype": "int8"}
    for k in ("active_slots", "max_slots", "pending_prefill", "pages_used",
              "pages_total", "tokens_generated", "preemptions", "retries",
              "stalled_slots", "param_bytes", "kv_bytes"):
        row[k] = int(rng.integers(0, 1000))
    for k in ("step_latency_ms", "step_p50_ms", "step_p99_ms",
              "prefill_latency_ms", "ttft_p50_ms", "ttft_p99_ms", "mfu"):
        row[k] = float(np.round(rng.random() * 50, 3))
    row["prefix_cache"] = ({k: int(rng.integers(0, 100)) for k in (
        "hits", "misses", "evictions", "tokens_saved", "cached_pages",
        "evictable_pages", "pinned_pages")} if cache else None)
    return row


@pytest.mark.parametrize("caches", [(True, True, False), (False, False),
                                    (True,), (False, True)],
                         ids=["two-of-three", "none", "one", "second"])
def test_stats_and_prefix_merge_equal_the_jax_versions(caches):
    """stats() (summed and max'd keys, the merged prefix cache and
    "replicas") and merge_prefix_cache_stats give the JAX versions' keys
    and values on the same inputs."""
    rng = np.random.default_rng(len(caches) * 7 + sum(caches))
    rows = [_stats_row(rng, c) for c in caches]
    ours = ReplicaSet(_stubs([(True, 0, False, 0, 0, r) for r in rows])).stats()
    theirs = JaxReplicaSet(_stubs([(True, 0, False, 0, 0, r)
                                   for r in rows])).stats()
    assert ours == theirs
    caches_in = [r["prefix_cache"] for r in rows]
    assert merge_prefix_cache_stats(caches_in) == \
        jax_merge_prefix_cache_stats(caches_in)


# ---------------------------------------------------------- mesh shapes
def test_mesh_shapes_with_a_data_axis():
    """tests/test_sharding.py:28's dp shapes: dp 2 with tp=-1 over 8 ranks
    gives data 2 x tensor 4; replica r holds ranks [4r, 4r + 4), and
    replica_submesh is THE derivation of a replica's ranks, this rank's
    place in them, or None for a replica it holds no rank of. In one
    process, dp 2 over two devices is two one-rank replicas."""
    mesh = make_mesh(dp=2, tp=-1, devices=["cpu"] * 8, rank=5)
    assert mesh.shape["data"] == 2 and mesh.shape["tensor"] == 4
    assert mesh.axis_names == AXES and mesh.ranks.shape == (2, 1, 1, 1, 4)
    assert replica_ranks(mesh, 1) == [4, 5, 6, 7] and replica_of(mesh) == 1
    assert mesh.tensor.rank == 1 and mesh.dp == 2
    mine = replica_submesh(mesh, 1)
    assert mine.rank == 5 and mine.tensor.rank == 1 and mine.dp == 1
    assert mine.ranks.reshape(-1).tolist() == [4, 5, 6, 7]
    other = replica_submesh(mesh, 0)
    assert other.rank is None and other.tensor is None and other.tp == 4
    assert make_mesh(dp=1, sp=1, tp=4, devices=["cpu"] * 4).shape["seq"] == 1
    # The expert axis inside each replica: dp 2 x ep 2 x tp 2, rank 6 is
    # replica 1's expert shard 1, tensor rank 0.
    ep = make_mesh(dp=2, ep=2, tp=2, devices=["cpu"] * 8, rank=6)
    assert ep.ranks.shape == (2, 1, 1, 2, 2) and replica_ranks(ep, 1) == [4, 5, 6, 7]
    assert replica_submesh(ep, 1).expert.index == 1 and replica_of(ep) == 1
    with pytest.raises(ValueError, match="span every rank"):
        make_mesh(dp=3, tp=2, devices=["cpu"] * 8)
    # pp inside each replica: dp 2 x pp 2 x tp 2, rank 6 is replica 1's
    # stage 1, tensor rank 0, its pipeline ranks 4 and 6.
    grid = make_mesh(dp=2, pp=2, tp=2, devices=["cpu"] * 8, rank=6)
    assert grid.ranks.shape == (2, 2, 1, 1, 2)
    sub = replica_submesh(grid, 1)
    assert sub.pipe.stage == 1 and sub.pipe.ranks == [4, 6] and sub.pp == 2
    # seq inside each replica: dp 2 x sp 2 x tp 2, rank 6 is replica 1's
    # shard 1, tensor rank 0, its ring ranks 4 and 6.
    ring = make_mesh(dp=2, sp=2, tp=2, devices=["cpu"] * 8, rank=6)
    assert ring.ranks.shape == (2, 1, 2, 1, 2)
    sub = replica_submesh(ring, 1)
    assert sub.sp == 2 and sub.seq.index == 1 and sub.seq.ranks == [4, 6]
    assert replica_submesh(ring, 0).seq is None
    local = make_mesh(dp=2, devices=["cpu", "cuda:1"])
    assert [replica_submesh(local, r).device for r in (0, 1)] == [
        torch.device("cpu"), torch.device("cuda:1")]
    assert all(replica_submesh(local, r).rank == 0 for r in (0, 1))
