"""Expert parallelism of the port against the JAX package's, on the CPU:
the mirror of tests/test_moe.py's expert-parallel cases.

In one process:

  - moe_mlp over each rank's experts (ep 2 and ep 4 on test-tiny-moe's 4
    experts, each with and without a tp 2 cut of F), summed, equals the
    whole layer within 1e-5 in float32 and the JAX moe_mlp within 2e-4,
    also where capacity binds and the `valid` mask is partial;
  - make_mesh's grid order at dp x ep x tp and each replica's submesh;
  - load_params' expert slices equal the same slices of the one-rank
    tree, seeded and from a safetensors checkpoint.

Over one gloo world of four CPU ranks, started once for the module
(float32, the JAX seed-0 test-tiny-moe tree as a checkpoint every rank
loads), while the test process computes the JAX references:

  - forward_ragged (padding between spans), forward_decode (parked slots
    ahead of the live rows in the capacity queue) and forward_embed at
    ep 2 x tp 2 and at ep 4, at capacity factor 0.5, against the JAX
    unsharded forwards within 2e-4, bit-identical on every rank, each
    rank's pool within 2e-4 of the JAX pool's heads it holds; the
    (expert, tensor) plane of each mesh spans the four ranks;
  - an SPMDEngine at ep 2 x tp 2 serving test-tiny-moe and the dense
    test-tiny side by side: the MoE ids equal the JAX TPUEngine's, the
    dense model builds on the ep mesh and gives the one-rank port
    engine's ids.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.engine.engine import TPUEngine
from ollamamq_tpu.engine.request import Request as JaxRequest
from ollamamq_tpu.models import llama as jllama
from ollamamq_tpu.models import moe as jmoe
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.models import moe, weights
from ollamamq_tpu_torch.models.weights import from_jax_numpy, save_safetensors
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.parallel.mesh import (make_mesh, replica_submesh,
                                              shard_range)
from ollamamq_tpu_torch.parallel.sharding import shard_layer
from test_torch_model import _np_params, _ragged_meta
from testutil import collect, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "test-tiny-moe"
CFG = MODEL_CONFIGS[NAME]
SHARD_TOL = dict(rtol=1e-5, atol=1e-5)
JAX_TOL = dict(rtol=2e-4, atol=2e-4)
PS, MP, NPAGES, B = 8, 8, 24, 4
CF = 0.5  # the forwards' capacity factor: capacity binds
# case -> (ep, tp) over the four ranks
MESHES = {"ep2xtp2": (2, 2), "ep4": (4, 1)}
SETTINGS = dict(max_slots=2, num_pages=32, page_size=8, max_pages_per_seq=8,
                prefill_buckets=(16,), max_new_tokens=8,
                decode_steps_per_iter=2, dtype="float32")
PROMPTS = {NAME: "experts apart", "test-tiny": "dense on experts"}
NEW = 6


# -- moe_mlp over expert shards -------------------------------------------
# (batch, tokens, capacity factor, padded rows or None)
MOE_CASES = {"n24": (2, 12, None, None),
             "capacity-0.5-valid": (2, 24, 0.5, (17, 24))}
SHARDS = {"ep2": (2, 1), "ep4": (4, 1), "ep2xtp2": (2, 2), "ep4xtp2": (4, 2)}


def _configs(cf=None):
    t, j = CFG, JAX_CONFIGS[NAME]
    if cf is not None:
        t = dataclasses.replace(t, moe_capacity_factor=cf)
        j = dataclasses.replace(j, moe_capacity_factor=cf)
    return t, j


@pytest.mark.parametrize("shards", list(SHARDS))
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_expert_shards_sum_to_the_whole_layer(case, shards):
    """Every (expert, tensor) rank's moe_mlp on its own stacks, summed,
    equals the one-rank layer within 1e-5 and the JAX layer within 2e-4:
    routing runs over all experts on every rank, so each rank's slots
    and drops are the whole layer's."""
    Bm, T, cf, pad = MOE_CASES[case]
    ep, tp = SHARDS[shards]
    tcfg, jcfg = _configs(cf)
    pnp = _np_params(NAME, seed=2)
    lnp = {k: v[0] for k, v in pnp["layers"].items()}
    lp = from_jax_numpy(pnp, CFG)["layers"][0]
    rng = np.random.default_rng(3)
    h = rng.normal(size=(Bm, T, CFG.hidden_size)).astype(np.float32)
    valid = None
    if pad is not None:
        valid = np.ones((Bm, T), bool)
        valid[:, pad[0]:pad[1]] = False
        h[:, pad[0]:pad[1]] = 1.0  # identical garbage rows
    tv = None if valid is None else torch.from_numpy(valid)
    whole = moe.moe_mlp(tcfg, lp, torch.from_numpy(h), tv)
    summed = torch.zeros_like(whole)
    for e in range(ep):
        experts = shard_range(CFG.num_experts, ep, e)
        for t in range(tp):
            mine = shard_layer(lp, tp, t, ep, e)
            assert mine["we_gate"].shape[0] == CFG.num_experts // ep
            summed += moe.moe_mlp(tcfg, mine, torch.from_numpy(h), tv,
                                  experts=experts)
    np.testing.assert_allclose(summed.numpy(), whole.numpy(), **SHARD_TOL)
    want = jmoe.moe_mlp(jcfg, jax.tree_util.tree_map(jnp.asarray, lnp),
                        jnp.asarray(h), None if valid is None else jnp.asarray(valid))
    np.testing.assert_allclose(summed.numpy(), np.asarray(want), **JAX_TOL)
    if cf is not None:  # capacity really binds: some routed entry dropped
        x = torch.from_numpy(h).reshape(1, -1, CFG.hidden_size)
        _, _, slot, C = moe.route(tcfg, lp, x, tv)
        routed = int((valid.sum()) * CFG.num_experts_per_tok)
        assert int((slot < C).sum()) < routed


# -- the mesh ------------------------------------------------------------------
def test_make_mesh_grid_order_dp_ep_tp():
    """(data, pipe, seq, expert, tensor): tensor varies fastest, expert
    next, and replica r holds ranks [r * ep * tp, (r + 1) * ep * tp)."""
    dp, ep, tp = 2, 2, 2
    for r in range(dp * ep * tp):
        mesh = make_mesh(dp=dp, ep=ep, tp=tp, devices=["cpu"] * 8, rank=r)
        assert mesh.shape == {"data": dp, "pipe": 1, "seq": 1, "expert": ep,
                              "tensor": tp}
        assert mesh.ranks.shape == (dp, 1, 1, ep, tp)
        want = {"data": r // (ep * tp), "pipe": 0, "seq": 0,
                "expert": (r // tp) % ep, "tensor": r % tp}
        assert mesh.coord == want
        assert mesh.ep == ep and mesh.expert.index == want["expert"]
        assert mesh.expert.expert_range(8) == (4 * want["expert"],
                                               4 * want["expert"] + 4)
        sub = replica_submesh(mesh, want["data"])
        assert sub.first == want["data"] * ep * tp and sub.size == ep * tp
        assert sub.shape["expert"] == ep and sub.expert.index == want["expert"]
    assert make_mesh(dp=2, ep=2, devices=["cpu"] * 8).tp == 2  # tp=-1: the rest
    with pytest.raises(ValueError, match="ep must be >= 1|must be >= 1"):
        make_mesh(ep=0, devices=["cpu"])
    with pytest.raises(ValueError, match="span every rank"):
        make_mesh(ep=3, tp=1, devices=["cpu"] * 4)


# -- weights -----------------------------------------------------------------
@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """The JAX engine's seed-0 test-tiny-moe and test-tiny trees (float32)
    as safetensors checkpoints."""
    out = {}
    for name in (NAME, "test-tiny"):
        path = str(tmp_path_factory.mktemp(name.replace(":", "_")))
        save_safetensors(from_jax_numpy(_jax_tree(name), MODEL_CONFIGS[name]),
                         MODEL_CONFIGS[name], path)
        out[name] = path
    return out


def _jax_tree(name):
    from ollamamq_tpu.models import weights as jweights

    jp = jweights.load_params(JAX_CONFIGS[name], None, seed=0, dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jp)


@pytest.mark.parametrize("source", ["seeded", "checkpoint"])
def test_load_params_expert_slices(source, checkpoint):
    """Each (expert, tensor) rank's tree equals the same slices of the
    one-rank tree: its experts' stacks cut on F, every other leaf as at
    ep 1 (the router whole; attention and vocab cut over tensor only)."""
    ckpt = checkpoint[NAME] if source == "checkpoint" else None
    full = weights.load_params(CFG, ckpt, 5, torch.float32)
    for ep, tp in ((2, 1), (2, 2), (4, 2)):
        for e in range(ep):
            lo, hi = shard_range(CFG.num_experts, ep, e)
            for t in range(tp):
                mine = weights.load_params(CFG, ckpt, 5, torch.float32, tp=tp,
                                           rank=t, ep=ep, expert_index=e)
                want = weights.tp_slice({**full, "layers": [
                    {k: (v[lo:hi] if k.startswith("we_") else v)
                     for k, v in lp.items()} for lp in full["layers"]]},
                    CFG, tp, t)
                got_leaves = list(weights.leaves(mine))
                want_leaves = list(weights.leaves(want))
                assert len(got_leaves) == len(want_leaves)
                for g, w in zip(got_leaves, want_leaves):
                    assert g.shape == w.shape and torch.equal(g, w)
                assert torch.equal(mine["layers"][0]["w_router"],
                                   full["layers"][0]["w_router"])
                # The same cut of a whole tree passed in (the engine's path).
                cut = weights.tp_slice(full, CFG, tp, t, ep, e)
                for g, w in zip(weights.leaves(cut), want_leaves):
                    assert torch.equal(g, w)
    # A dense model is replicated over the expert axis.
    dense = MODEL_CONFIGS["test-tiny"]
    one = weights.load_params(dense, None, 5, torch.float32)
    on_ep = weights.load_params(dense, None, 5, torch.float32, ep=2,
                                expert_index=1)
    for g, w in zip(weights.leaves(on_ep), weights.leaves(one)):
        assert torch.equal(g, w)


# -- the four-rank world -------------------------------------------------------
CHILD = r"""
import dataclasses, os, pickle, sys, time
rank, world, port, plan_file, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                         int(sys.argv[3]), sys.argv[4], sys.argv[5])
import torch
torch.set_num_threads(1)
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.engine import spmd
from ollamamq_tpu_torch.engine.kv_cache import local_kv_heads
from ollamamq_tpu_torch.models import llama
from ollamamq_tpu_torch.models.weights import load_params
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.parallel import distributed
from ollamamq_tpu_torch.parallel.mesh import make_mesh

with open(plan_file, "rb") as f:
    plan = pickle.load(f)
distributed.initialize(f"127.0.0.1:{port}", world, rank, devices=["cpu"] * world,
                       timeout_s=60)
out = {"forward": {}}
meshes = {key: make_mesh(ep=ep, tp=tp) for key, (ep, tp) in plan["meshes"].items()}
cfg = dataclasses.replace(MODEL_CONFIGS[plan["model"]],
                          moe_capacity_factor=plan["cf"])
for key, mesh in meshes.items():
    ep, tp = plan["meshes"][key]
    member = torch.zeros(world)
    member[rank] = 1.0
    mesh.expert.all_reduce(member)
    params = load_params(cfg, plan["ckpt"], 0, torch.float32, tp=tp,
                         rank=mesh.coord["tensor"], ep=ep,
                         expert_index=mesh.coord["expert"])
    shape = (cfg.num_layers, plan["slots"], local_kv_heads(cfg, tp), cfg.head_dim)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    logits = []
    for kind, arrays in plan["steps"]:
        a = {k: torch.from_numpy(v) for k, v in arrays.items()}
        if kind == "ragged":
            lg, _, _ = llama.forward_ragged(
                params, cfg, a["tokens"], a["tok_seq"], a["tok_pos"], a["ws"],
                a["out_idx"], kc, vc, a["pt"], a["q_start"], a["q_len"],
                a["kv_len"], plan["page_size"], attn_impl="plain",
                tp=mesh.tensor, ep=mesh.expert)
        elif kind == "decode":
            lg, _, _ = llama.forward_decode(
                params, cfg, a["tokens"], a["positions"], kc, vc, a["pt"],
                plan["page_size"], attn_impl="plain", active=a["active"],
                tp=mesh.tensor, ep=mesh.expert)
        else:
            lg = llama.forward_embed(params, cfg, a["tokens"], a["lens"],
                                     tp=mesh.tensor, ep=mesh.expert)
        logits.append(lg.numpy())
    out["forward"][key] = {"logits": logits, "k": kc.numpy(), "v": vc.numpy(),
                           "coord": mesh.coord, "plane": member.tolist()}
eng_plan = plan["engine"]
ecfg = EngineConfig(**eng_plan["settings"])
mesh = meshes["ep2xtp2"]
if rank == 0:
    eng = spmd.SPMDEngine(ecfg, mesh=mesh, blocklist_path=None, models=eng_plan["models"])
    eng.start()

    def wait(req, budget=240):
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            item = req.stream.get(timeout=0.5)
            if item and item.kind in ("done", "error"):
                return item.kind
        return "timeout"

    runs = {}
    for model, prompt in eng_plan["prompts"].items():
        req = eng.enqueue_request("u", "", model, prompt_tokens=prompt,
                                  sampling=SamplingParams(max_tokens=eng_plan["new"],
                                                          temperature=0.0))
        runs[model] = [wait(req), req.generated_ids]
    experts = {m: (rt.ep.index if rt.ep is not None else None, rt._ep,
                   rt.param_bytes) for m, rt in eng.runtimes.items()}
    eng.stop(report_timeout_s=30)
    out.update(runs=runs, experts=experts, me=eng.spmd_report(),
               workers=eng.worker_reports)
else:
    out["steps"] = spmd.run_worker(eng_plan["models"], ecfg, mesh)
with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
sys.stdout.flush()
os._exit(0)
"""


def _steps():
    """The forward cases' inputs: a ragged tick of two prompts with
    padding between them and at the tail, a ragged tick with a decode
    row beside a prefill span, three decode steps with two parked slots
    (row 0 ahead of both live rows in the capacity queue), then an
    embed batch with one padded row. Each with its rows to compare."""
    rng = np.random.default_rng(1)
    pt = np.zeros((B, MP), np.int32)
    pt[1, :3] = [1, 2, 3]
    pt[2, :2] = [7, 5]

    def ragged(tokens, spans, T, gap=0):
        tok_seq, tok_pos, q_start, q_len, kv_len = _ragged_meta(spans, T, B)
        if gap:
            n0 = spans[0][2]
            for a in (tok_seq, tok_pos):
                a[n0 + gap:] = a[n0:T - gap].copy()
            tok_pos[n0:n0 + gap] = -1
            q_start[[s for s, *_ in spans[1:]]] += gap
        ws = np.array([pt[s][p // PS] * PS + p % PS if p >= 0 else 0
                       for s, p in zip(tok_seq, tok_pos)], np.int32)
        out_idx = np.clip(q_start + q_len - 1, 0, T - 1).astype(np.int32)
        return ("ragged", dict(tokens=tokens, tok_seq=tok_seq, tok_pos=tok_pos,
                               ws=ws, out_idx=out_idx, pt=pt, q_start=q_start,
                               q_len=q_len, kv_len=kv_len)), [s for s, *_ in spans]

    steps = []
    toks = np.zeros(32, np.int32)
    toks[:13] = rng.integers(1, CFG.vocab_size, size=13)
    toks[17:28] = rng.integers(1, CFG.vocab_size, size=11)
    steps.append(ragged(toks, [(1, 0, 13, 13), (2, 0, 11, 11)], 32, gap=4))
    toks = np.zeros(16, np.int32)
    toks[0] = 42
    toks[1:5] = rng.integers(1, CFG.vocab_size, size=4)
    steps.append(ragged(toks, [(1, 13, 1, 14), (2, 11, 4, 15)], 16))
    active = np.array([0, 1, 1, 0], np.int32)
    for step in range(3):
        steps.append((("decode", dict(
            tokens=np.array([3, 7 + step, 9 + step, 3], np.int32),
            positions=np.array([0, 14 + step, 15 + step, 0], np.int32),
            pt=pt, active=active)), [1, 2]))
    etoks = rng.integers(1, CFG.vocab_size, size=(3, 12)).astype(np.int32)
    steps.append((("embed", dict(tokens=etoks, lens=np.array([12, 7, 12], np.int32))),
                  [0, 1, 2]))
    return steps


def _jax_forwards(steps):
    """The JAX unsharded forwards over the same steps (attn_impl "jnp",
    capacity factor CF): each step's logits / embeddings and the pools."""
    jcfg = dataclasses.replace(JAX_CONFIGS[NAME], moe_capacity_factor=CF)
    jp = jax.tree_util.tree_map(jnp.asarray, _jax_tree(NAME))
    shape = (CFG.num_layers, NPAGES * PS, CFG.num_kv_heads, CFG.head_dim)
    jk, jv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    outs = []
    for (kind, a), _ in steps:
        a = {k: jnp.asarray(v) for k, v in a.items()}
        if kind == "ragged":
            lg, jk, jv = jllama.forward_ragged(
                jp, jcfg, a["tokens"], a["tok_seq"], a["tok_pos"], a["ws"],
                a["out_idx"], jk, jv, a["pt"], a["q_start"], a["q_len"],
                a["kv_len"], PS, attn_impl="jnp")
        elif kind == "decode":
            lg, jk, jv = jllama.forward_decode(
                jp, jcfg, a["tokens"], a["positions"], jk, jv, a["pt"], PS,
                attn_impl="jnp", active=a["active"])
        else:
            lg = jllama.forward_embed(jp, jcfg, a["tokens"], a["lens"])
        outs.append(np.asarray(lg))
    return outs, np.asarray(jk), np.asarray(jv)


def _jax_engine_ids(prompt):
    eng = TPUEngine(JaxEngineConfig(model=NAME, **SETTINGS), blocklist_path=None,
                    dtype=jnp.float32)
    eng.start()
    try:
        rid = eng.core.enqueue("u", "", NAME)
        req = JaxRequest(rid, "u", NAME, list(prompt), JaxSampling(max_tokens=NEW))
        eng.submit(req)
        assert collect(req, timeout=300)[-1].kind == "done"
        return req.generated_ids
    finally:
        eng.stop()


def _port_ids(ckpt, model, prompt):
    eng = TorchEngine(EngineConfig(model=model, **SETTINGS), device="cpu",
                      blocklist_path=None, models={model: ckpt})
    eng.start()
    try:
        req = eng.enqueue_request("u", "", model, prompt_tokens=prompt,
                                  sampling=SamplingParams(max_tokens=NEW,
                                                          temperature=0.0))
        assert collect(req, timeout=300)[-1].kind == "done"
        return req.generated_ids
    finally:
        eng.stop()


def launch_world(world, child, plan, tmp, budget=300):
    """Start `world` gloo ranks running `child` on `plan`; returns a
    wait() giving every rank's pickled output."""
    plan_file = os.path.join(tmp, "plan.pkl")
    with open(plan_file, "wb") as f:
        pickle.dump(plan, f)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    logs = [open(os.path.join(tmp, f"r{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", child, str(r), str(world),
                               str(port), plan_file, tmp], cwd=REPO, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]

    def wait():
        try:
            deadline = time.monotonic() + budget
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            assert p.returncode == 0, open(os.path.join(tmp, f"r{r}.log")).read()[-3000:]
        outs = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs

    return wait


@pytest.fixture(scope="module")
def ep_world(tmp_path_factory, checkpoint):
    from ollamamq_tpu_torch.engine.tokenizer import load_tokenizer

    tok = load_tokenizer(None)
    prompts = {m: tok.encode(p) for m, p in PROMPTS.items()}
    steps = _steps()
    plan = {"model": NAME, "cf": CF, "ckpt": checkpoint[NAME], "meshes": MESHES,
            "page_size": PS, "slots": NPAGES * PS, "steps": [s for s, _ in steps],
            "engine": {"settings": dict(SETTINGS, model=NAME, ep=2, tp=2),
                       "models": {NAME: checkpoint[NAME],
                                  "test-tiny": checkpoint["test-tiny"]},
                       "prompts": prompts, "new": NEW}}
    wait = launch_world(4, CHILD, plan, str(tmp_path_factory.mktemp("ep4")))
    refs = {"forward": _jax_forwards(steps), "rows": [r for _, r in steps],
            "jax_moe": _jax_engine_ids(prompts[NAME]),
            "port_dense": _port_ids(checkpoint["test-tiny"], "test-tiny",
                                    prompts["test-tiny"]),
            "port_moe": _port_ids(checkpoint[NAME], NAME, prompts[NAME])}
    return refs, wait()


@pytest.mark.parametrize("key", list(MESHES))
def test_forwards_at_ep_match_jax_unsharded(key, ep_world):
    """forward_ragged / forward_decode / forward_embed over the (expert,
    tensor) mesh against the JAX unsharded forwards at capacity factor
    0.5: within 2e-4, bit-identical on every rank (the expert ranks'
    hidden states, and so their routing, agree exactly); each rank's
    pool holds its KV heads of the JAX pool; the plane spans the four
    ranks."""
    refs, outs = ep_world
    want, jk, jv = refs["forward"]
    ep, tp = MESHES[key]
    first = outs[0]["forward"][key]
    coords = set()
    for o in outs:
        r = o["forward"][key]
        coords.add((r["coord"]["expert"], r["coord"]["tensor"]))
        assert r["plane"] == [1.0] * 4
        for got, w, same, rows in zip(r["logits"], want, first["logits"],
                                      refs["rows"]):
            np.testing.assert_allclose(got[rows], w[rows], **JAX_TOL)
            np.testing.assert_array_equal(got, same)
        hk = r["k"].shape[2]
        t = r["coord"]["tensor"]
        for mine, full in ((r["k"], jk), (r["v"], jv)):
            np.testing.assert_allclose(mine[:, PS:], full[:, PS:, t * hk:(t + 1) * hk],
                                       **JAX_TOL)
    assert coords == {(e, t) for e in range(ep) for t in range(tp)}


def test_engine_serves_moe_end_to_end(ep_world):
    """An SPMDEngine at ep 2 x tp 2 streams the JAX TPUEngine's greedy
    ids (and the one-rank port engine's) on test-tiny-moe; every rank
    replayed the same ops to the same output digest."""
    refs, outs = ep_world
    leader = outs[0]
    kind, ids = leader["runs"][NAME]
    assert kind == "done" and len(ids) == NEW
    assert ids == refs["jax_moe"] == refs["port_moe"]
    index, ep, nbytes = leader["experts"][NAME]
    assert (index, ep) == (0, 2)
    assert len(leader["workers"]) == 3
    for w in leader["workers"]:
        assert w["digest"] == leader["me"]["digest"], w


def test_dense_model_allowed_on_ep_mesh(ep_world):
    """A dense model on an ep mesh builds (replicated over the expert
    axis) and gives the ep 1 ids."""
    refs, outs = ep_world
    kind, ids = outs[0]["runs"]["test-tiny"]
    assert kind == "done" and ids == refs["port_dense"]
    index, ep, _ = outs[0]["experts"]["test-tiny"]
    assert (index, ep) == (None, 1)


def test_ep_not_dividing_experts_is_refused():
    """The runtime refuses an MoE model whose experts ep does not divide,
    with the reference's words, before any device work."""
    from ollamamq_tpu_torch.engine.engine import ModelRuntime

    mesh = make_mesh(ep=3, tp=1, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match=r"ep=3 must divide num_experts=4 "
                                         r"\(test-tiny-moe\)"):
        ModelRuntime(NAME, CFG, EngineConfig(model=NAME, **SETTINGS),
                     mesh=mesh)


def test_parked_decode_rows_carry_identical_inputs():
    """A finished slot's decode row keeps running parked (position 0, the
    trash page): its last token goes to 0 with its position, so all
    parked rows write the same K/V to the trash slot they share and the
    ranks of a world hold the same bytes there."""
    eng = TorchEngine(EngineConfig(model=NAME, **SETTINGS), device="cpu",
                      blocklist_path=None)
    eng.start()
    try:
        rt = eng.runtimes[NAME]
        tok = rt.tokenizer
        reqs = [eng.enqueue_request(f"u{i}", "", NAME,
                                    prompt_tokens=tok.encode("park " * (i + 1)),
                                    sampling=SamplingParams(max_tokens=3 + i,
                                                            temperature=0.0))
                for i in range(2)]
        for r in reqs:
            assert collect(r, timeout=120)[-1].kind == "done"
            assert r.generated_ids
        assert rt.last_tokens.tolist() == [0] * SETTINGS["max_slots"]
        assert rt.seq_lens.tolist() == [0] * SETTINGS["max_slots"]
    finally:
        eng.stop()
