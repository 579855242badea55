"""Sequence-parallel prefill of the port against the JAX package's, on the
CPU: the mirror of tests/test_sp_prefill.py and of the long-context
serving of tests/test_long_context.py.

Two gloo worlds start once for the module (one compute thread a rank,
float32, the JAX seed-0 trees written as safetensors checkpoints that
every rank loads), while the test process computes the JAX references:

  - 2 ranks (sp 2): forward_prefill_sp on two padded prompts against
    the JAX forward_prefill_sp under the virtual CPU mesh (logits within
    2e-4 on every rank; every rank's pool within 1e-5 of the JAX K/V
    stacks scattered as the JAX runtime scatters them, outside the trash
    page); then an SPMDEngine at sp 2 over both ranks: a long prompt
    (past the largest bucket 64), two long prompts that must diverge,
    and test_long_context.py's 2,048-token prompt; each takes one
    OP_PREFILL_SP, and their greedy ids equal the JAX TPUEngine(sp=2)'s,
    the port's at sp 1 and, for the 2,048-token prompt, a one-shot JAX
    forward and greedy decode.
  - the same at sp 2 on test-tiny-moe at capacity factor 0.5, where the
    reference routes the whole [2, 64] stream as one group whose
    capacity binds (a shard's own [2, 32] chunk would be a group of its
    own with half the capacity), and an SPMDEngine's long prompt on it
    against the JAX TPUEngine(sp=2)'s ids;
  - 8 ranks: forward_prefill_sp at sp 4 x tp 2 and inside the replicas
    of dp 2 x sp 2 x tp 2 on test-tiny-gqa (same bounds), then an
    SPMDEngine at dp 2 x sp 2 x tp 2 serving one long prompt on each
    replica: both replicas give the one-rank port engine's ids.
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

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.engine import kv_cache as jkvc
from ollamamq_tpu.engine.engine import TPUEngine
from ollamamq_tpu.engine.request import Request as JaxRequest
from ollamamq_tpu.models import llama as jllama
from ollamamq_tpu.models import weights as jweights
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.models.weights import from_jax_numpy, save_safetensors
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from testutil import collect, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
PS, NPAGES, MP = 8, 40, 12  # the forward cases' pools
T_LONG, GEN_LONG = 2048, 8
SETTINGS = dict(max_slots=2, num_pages=192, page_size=16, max_pages_per_seq=160,
                prefill_buckets=(16, 64), max_new_tokens=8,
                decode_steps_per_iter=2, dtype="float32")
TEXTS = {"long": "long prompt " * 12, "alpha": "alpha " * 30,
         "omega": "omega " * 30, "mesh": "full mesh " * 15}
NEW = 6

# The MoE cases' capacity factor: capacity binds.
MOE_CF = 0.5
MOE_CAP = "test-tiny-moe-cap"  # test-tiny-moe at MOE_CF, registered by name
# case -> (model, sp, tp, dp, world)
FWD_CASES = {"sp2": ("test-tiny", 2, 1, 1, 2),
             "moe-sp2": (MOE_CAP, 2, 1, 1, 2),
             "sp4xtp2": ("test-tiny-gqa", 4, 2, 1, 8),
             "dp2xsp2xtp2": ("test-tiny-gqa", 2, 2, 2, 8)}
FWD_T, FWD_LENS = 64, (64, 41)

CHILD = r"""
import dataclasses, json, os, pickle, sys, time
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
from ollamamq_tpu_torch.parallel.mesh import make_mesh, replica_submesh, replica_of

with open(plan_file, "rb") as f:
    plan = pickle.load(f)
MODEL_CONFIGS["test-tiny-long"] = dataclasses.replace(
    MODEL_CONFIGS["test-tiny"], name="test-tiny-long", max_seq_len=4096)
MODEL_CONFIGS["MOE_CAP"] = dataclasses.replace(
    MODEL_CONFIGS["test-tiny-moe"], name="MOE_CAP", moe_capacity_factor=MOE_CF)
distributed.initialize(f"127.0.0.1:{port}", world, rank, devices=["cpu"] * world,
                       timeout_s=60)
out = {"forward": {}}
meshes = {}
for key, c in plan["forward"].items():
    shape = (c["dp"], c["sp"], c["tp"])
    if shape not in meshes:  # every rank builds the meshes in one order
        meshes[shape] = make_mesh(dp=c["dp"], sp=c["sp"], tp=c["tp"])
    mesh = meshes[shape]
    sub = replica_submesh(mesh, replica_of(mesh))
    cfg = MODEL_CONFIGS[c["model"]]
    params = load_params(cfg, c["ckpt"], 0, torch.float32, "bfloat16", "cpu",
                         tp=c["tp"], rank=sub.coord["tensor"])
    shape_kv = (cfg.num_layers, c["slots"], local_kv_heads(cfg, c["tp"]), cfg.head_dim)
    kc, vc = torch.zeros(shape_kv), torch.zeros(shape_kv)
    a = {k: torch.from_numpy(v) for k, v in c["arrays"].items()}
    before = dict(sub.seq.stats)
    logits, _, _ = llama.forward_prefill_sp(params, cfg, a["tokens"], a["lens"], kc, vc,
                                            a["pt"], c["page_size"], sub.seq,
                                            tp=sub.tensor)
    out["forward"][key] = {"logits": logits.numpy(), "k": kc.numpy(), "v": vc.numpy(),
                           "tensor": sub.coord["tensor"],
                           "stats": {n: sub.seq.stats[n] - before[n] for n in before}}
eng_plan = plan["engine"]
ecfg = EngineConfig(**eng_plan["settings"])
mesh = make_mesh(dp=ecfg.dp, sp=ecfg.sp, tp=ecfg.tp)
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
    for name, (model, prompt, n, together) in eng_plan["runs"].items():
        reqs = [eng.enqueue_request(f"{name}{i}", "", model, prompt_tokens=prompt,
                                    sampling=SamplingParams(max_tokens=n,
                                                            temperature=0.0))
                for i in range(together)]
        runs[name] = [[wait(r), r.generated_ids] for r in reqs]
    stats = {}
    for model, rt in eng.runtimes.items():
        reps = getattr(rt, "replicas", [rt])
        stats[model] = [{"sp_prefill": r.sp_prefill_dispatches,
                         "ragged": r.ragged_dispatches,
                         "tokens": r.tokens_generated} for r in reps]
    eng.stop(report_timeout_s=30)
    out.update(runs=runs, stats=stats, me=eng.spmd_report(), workers=eng.worker_reports)
else:
    out["steps"] = spmd.run_worker(eng_plan["models"], ecfg, mesh)
with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
sys.stdout.flush()
os._exit(0)
""".replace("MOE_CAP", MOE_CAP).replace("MOE_CF", repr(MOE_CF))


def _moe_cap_configs():
    """Register test-tiny-moe at MOE_CF under MOE_CAP in both packages'
    tables (the test's own entry; removed by the fixture)."""
    JAX_CONFIGS[MOE_CAP] = dataclasses.replace(
        JAX_CONFIGS["test-tiny-moe"], name=MOE_CAP, moe_capacity_factor=MOE_CF)
    MODEL_CONFIGS[MOE_CAP] = dataclasses.replace(
        MODEL_CONFIGS["test-tiny-moe"], name=MOE_CAP, moe_capacity_factor=MOE_CF)


def _np_tree(model, seed=0):
    jp = jweights.load_params(JAX_CONFIGS[model], None, seed=seed, dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jp)


def _checkpoint(tmp, model):
    """The JAX engine's seed-0 tree of `model` (float32) as a safetensors
    checkpoint directory."""
    path = str(tmp.mktemp(model))
    save_safetensors(from_jax_numpy(_np_tree(model), MODEL_CONFIGS[model]),
                     MODEL_CONFIGS[model], path)
    return path


def _fwd_arrays(model, sp):
    """Two prompts padded to FWD_T (one full, one ragged) with page
    tables covering each prompt's real tokens plus one; the rest point
    at the trash page."""
    rng = np.random.default_rng(sp)
    B = len(FWD_LENS)
    pt = np.zeros((B, MP), np.int32)
    nxt = 1
    for b, n in enumerate(FWD_LENS):
        need = -(-(n + 1) // PS)
        pt[b, :need] = np.arange(nxt, nxt + need)
        nxt += need
    return {"tokens": rng.integers(1, MODEL_CONFIGS[model].vocab_size,
                                   size=(B, FWD_T)).astype(np.int32),
            "lens": np.asarray(FWD_LENS, np.int32), "pt": pt}


def _jax_forward(model, sp, tp, arrays):
    """The JAX forward_prefill_sp's logits and its K/V stacks scattered
    into a pool as the JAX runtime's sp prefill scatters them
    (positions at or past seq_lens to the trash page)."""
    cfg = JAX_CONFIGS[model]
    mesh = jax_make_mesh(dp=1, sp=sp, tp=tp, devices=jax.devices()[:sp * tp])
    jp = jax.tree_util.tree_map(jnp.asarray, _np_tree(model))
    with jax.set_mesh(mesh):
        logits, ks, vs = jllama.forward_prefill_sp(
            jp, cfg, jnp.asarray(arrays["tokens"]), jnp.asarray(arrays["lens"]), mesh)
    ks, vs = np.asarray(ks), np.asarray(vs)  # [L, B, T, Hk, hd]
    shape = (cfg.num_layers, NPAGES * PS, cfg.num_kv_heads, cfg.head_dim)
    k, v = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    t = np.arange(FWD_T)
    for b, n in enumerate(arrays["lens"]):
        page = np.where(t < n, arrays["pt"][b, np.minimum(t // PS, MP - 1)],
                        jkvc.TRASH_PAGE)
        dest = page * PS + t % PS
        k[:, dest], v[:, dest] = ks[:, b], vs[:, b]
    return np.asarray(logits), k, v


def _launch(world, plan, tmp):
    plan_file = os.path.join(tmp, "plan.pkl")
    with open(plan_file, "wb") as f:
        pickle.dump(plan, f)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    logs = [open(os.path.join(tmp, f"r{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(world),
                               str(port), plan_file, tmp], cwd=REPO, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]

    def wait():
        try:
            deadline = time.monotonic() + 420
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


def _long_prompt():
    rng = np.random.RandomState(11)
    return rng.randint(3, MODEL_CONFIGS["test-tiny"].vocab_size, size=T_LONG).tolist()


def _tok():
    from ollamamq_tpu_torch.engine.tokenizer import load_tokenizer

    return load_tokenizer(None)  # the seeded models' tokenizer


def _port_ids(ckpt, model, runs, **kw):
    """Greedy ids of a one-rank port engine on the checkpoint, each run
    alone."""
    eng = TorchEngine(EngineConfig(model=model, **{**SETTINGS, **kw}), device="cpu",
                      blocklist_path=None, models={model: ckpt})
    eng.start()
    try:
        out = {}
        for name, (prompt, n) in runs.items():
            req = eng.enqueue_request("u", "", model, prompt_tokens=prompt,
                                      sampling=SamplingParams(max_tokens=n,
                                                              temperature=0.0))
            assert collect(req, timeout=300)[-1].kind == "done"
            out[name] = req.generated_ids
        return out
    finally:
        eng.stop()


def _jax_sp2_ids(runs, model="test-tiny"):
    """Greedy ids of the JAX TPUEngine at sp 2 (seed-0 weights, float32)."""
    eng = TPUEngine(JaxEngineConfig(model=model, sp=2, max_slots=2,
                                    num_pages=128, page_size=8, max_pages_per_seq=32,
                                    prefill_buckets=(16, 32, 64), max_new_tokens=8,
                                    decode_steps_per_iter=2),
                    blocklist_path=None, dtype=jnp.float32)
    eng.start()
    try:
        assert eng.runtimes[model]._sp
        out = {}
        for name, (prompt, n) in runs.items():
            rid = eng.core.enqueue("u", "", model)
            req = JaxRequest(rid, "u", model, list(prompt), JaxSampling(max_tokens=n))
            eng.submit(req)
            assert collect(req, timeout=300)[-1].kind == "done"
            out[name] = req.generated_ids
        return out
    finally:
        eng.stop()


def _oneshot_ids(prompt, gen):
    """test_long_context.py's reference: one JAX forward_prefill over the
    whole prompt, then greedy decode steps (seed-0 weights, float32)."""
    cfg = dataclasses.replace(JAX_CONFIGS["test-tiny"], max_seq_len=4096)
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    ps, pages_n, mp = 16, 192, 160
    kc = jnp.zeros((cfg.num_layers, pages_n * ps, cfg.num_kv_heads, cfg.head_dim),
                   jnp.float32)
    vc = jnp.zeros_like(kc)
    alloc = jkvc.PageAllocator(pages_n, ps, mp)
    pt = jnp.asarray(np.stack([jkvc.make_page_table_row(
        alloc.alloc(len(prompt) + gen + 1), mp)]))
    logits, kc, vc = jllama.forward_prefill(params, cfg, jnp.asarray([prompt], jnp.int32),
                                            jnp.array([len(prompt)]), kc, vc, pt, ps)
    out = []
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    pos = jnp.array([len(prompt)], jnp.int32)
    for _ in range(gen):
        out.append(int(tok[0]))
        logits, kc, vc = jllama.forward_decode(params, cfg, tok, pos, kc, vc, pt, ps)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        pos = pos + 1
    return out


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    _moe_cap_configs()
    try:
        yield _sp_runs(tmp_path_factory)
    finally:
        JAX_CONFIGS.pop(MOE_CAP, None)
        MODEL_CONFIGS.pop(MOE_CAP, None)


def _sp_runs(tmp_path_factory):
    ckpt = {m: _checkpoint(tmp_path_factory, m)
            for m in ("test-tiny", "test-tiny-gqa", MOE_CAP)}
    tok = _tok()
    prompts = {k: tok.encode(t) for k, t in TEXTS.items()}
    assert all(len(p) > 64 for p in prompts.values())
    long_prompt = _long_prompt()
    fwd = {key: {"model": m, "sp": sp, "tp": tp, "dp": dp, "ckpt": ckpt[m],
                 "page_size": PS, "slots": NPAGES * PS, "arrays": _fwd_arrays(m, sp)}
           for key, (m, sp, tp, dp, _) in FWD_CASES.items()}
    sp2_runs = {"long": ("test-tiny", prompts["long"], NEW, 1),
                "alpha": ("test-tiny", prompts["alpha"], NEW, 1),
                "omega": ("test-tiny", prompts["omega"], NEW, 1),
                "2k": ("test-tiny-long", long_prompt, GEN_LONG, 1),
                "moe": (MOE_CAP, prompts["long"], NEW, 1)}
    plans = {
        2: {"forward": {k: v for k, v in fwd.items() if FWD_CASES[k][4] == 2},
            "engine": {"settings": dict(SETTINGS, model="test-tiny", sp=2),
                       "models": {"test-tiny": ckpt["test-tiny"],
                                  "test-tiny-long": ckpt["test-tiny"],
                                  MOE_CAP: ckpt[MOE_CAP]},
                       "runs": sp2_runs}},
        8: {"forward": {k: v for k, v in fwd.items() if FWD_CASES[k][4] == 8},
            "engine": {"settings": dict(SETTINGS, model="test-tiny-gqa", dp=2, sp=2,
                                        tp=2),
                       "models": {"test-tiny-gqa": ckpt["test-tiny-gqa"]},
                       "runs": {"mesh": ("test-tiny-gqa", prompts["mesh"], NEW, 2)}}},
    }
    waits = {w: _launch(w, plan, str(tmp_path_factory.mktemp(f"sp{w}")))
             for w, plan in plans.items()}
    refs = {"forward": {key: _jax_forward(m, sp, tp, fwd[key]["arrays"])
                        for key, (m, sp, tp, dp, _) in FWD_CASES.items()},
            "jax_sp2": _jax_sp2_ids({k: (prompts[k], NEW) for k in ("long", "alpha",
                                                                    "omega")}),
            "jax_sp2_moe": _jax_sp2_ids({"moe": (prompts["long"], NEW)},
                                        model=MOE_CAP)["moe"],
            "oneshot": _oneshot_ids(long_prompt, GEN_LONG),
            "port_sp1": _port_ids(ckpt["test-tiny"], "test-tiny",
                                  {k: (prompts[k], NEW) for k in ("long", "alpha",
                                                                  "omega")}),
            "port_gqa": _port_ids(ckpt["test-tiny-gqa"], "test-tiny-gqa",
                                  {"mesh": (prompts["mesh"], NEW)})}
    MODEL_CONFIGS["test-tiny-long"] = dataclasses.replace(
        MODEL_CONFIGS["test-tiny"], name="test-tiny-long", max_seq_len=4096)
    try:
        refs["port_sp1_2k"] = _port_ids(ckpt["test-tiny"], "test-tiny-long",
                                        {"2k": (long_prompt, GEN_LONG)})["2k"]
    finally:
        MODEL_CONFIGS.pop("test-tiny-long", None)
    return refs, {w: wait() for w, wait in waits.items()}


@pytest.mark.parametrize("key", list(FWD_CASES))
def test_forward_prefill_sp_matches_jax(key, sp_runs):
    """Logits within 2e-4 of the JAX forward_prefill_sp and bit-identical
    on every rank; every rank's pool within 1e-5 of the JAX stacks
    scattered into pages (its own KV heads), outside the trash page;
    sp - 1 ring hand-offs a layer."""
    refs, outs = sp_runs
    model, sp, tp, dp, world = FWD_CASES[key]
    logits, k, v = refs["forward"][key]
    ranks = [o["forward"][key] for o in outs[world]]
    layers = MODEL_CONFIGS[model].num_layers
    for r in ranks:
        np.testing.assert_allclose(r["logits"], logits, **LOGIT_TOL)
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])
        hk = r["k"].shape[2]
        t = r["tensor"]
        for mine, full in ((r["k"], k), (r["v"], v)):
            np.testing.assert_allclose(mine[:, PS:], full[:, PS:, t * hk:(t + 1) * hk],
                                       **KV_TOL)
        assert r["stats"]["handoffs"] == layers * (sp - 1)
        assert r["stats"]["prefills"] == 1


def test_sp2_engine_matches_jax_engine_and_sp1(sp_runs):
    """An SPMDEngine at sp 2 over two ranks: each long prompt took one
    OP_PREFILL_SP on both ranks, and its greedy ids equal the JAX
    TPUEngine(sp=2)'s and the port's at sp 1."""
    refs, outs = sp_runs
    leader = outs[2][0]
    runs = leader["runs"]
    for name in ("long", "alpha", "omega"):
        (kind, ids), = runs[name]
        assert kind == "done" and len(ids) == NEW
        assert ids == refs["jax_sp2"][name] == refs["port_sp1"][name], name
    assert leader["stats"]["test-tiny"][0]["sp_prefill"] == 3
    (w,) = leader["workers"]
    # Four test-tiny / test-tiny-long prompts and the MoE case's one.
    assert w["ops"]["sp_prefill"] == leader["me"]["ops"]["sp_prefill"] == 5
    assert w["digest"] == leader["me"]["digest"]
    # The ring is the rank's (every model's runtime shares it).
    assert w["runtimes"]["test-tiny"]["seq"]["prefills"] == 5


def test_sp2_decode_reads_the_prefilled_pages(sp_runs):
    """Two different long prompts diverge after the sp prefill: decode
    reads the pages the ring wrote."""
    _, outs = sp_runs
    runs = outs[2][0]["runs"]
    assert runs["alpha"][0][1] != runs["omega"][0][1]


def test_2k_prompt_at_sp1_and_sp2_matches_oneshot(sp_runs):
    """test_long_context.py's 2,048-token prompt: the port at sp 2 (one
    ring prefill) and at sp 1 (the ragged path's spans) give the greedy
    ids of a one-shot JAX forward and greedy decode."""
    refs, outs = sp_runs
    (kind, ids), = outs[2][0]["runs"]["2k"]
    assert kind == "done"
    assert ids == refs["oneshot"] == refs["port_sp1_2k"]
    assert outs[2][0]["stats"]["test-tiny-long"][0]["sp_prefill"] == 1


def test_dp2_sp2_tp2_serves_one_ranks_ids(sp_runs):
    """dp 2 x sp 2 x tp 2 over eight ranks: the same long prompt twice,
    one on each replica, each through its own ring, both with the
    one-rank port engine's ids."""
    refs, outs = sp_runs
    leader = outs[8][0]
    runs = leader["runs"]["mesh"]
    assert [k for k, _ in runs] == ["done", "done"]
    assert [ids for _, ids in runs] == [refs["port_gqa"]["mesh"]] * 2
    assert [s["sp_prefill"] for s in leader["stats"]["test-tiny-gqa"]] == [1, 1]
    reports = {w["rank"]: w for w in leader["workers"]}
    assert sorted(reports) == list(range(1, 8))
    for r in range(1, 8):
        assert reports[r]["ops"]["sp_prefill"] == 1, reports[r]["ops"]


def test_sp2_moe_routes_the_whole_stream(sp_runs):
    """test-tiny-moe at capacity factor 0.5 under sp 2: the forward's
    logits and pools match the JAX forward_prefill_sp, which routes the
    whole [B, T] stream (test_forward_prefill_sp_matches_jax[moe-sp2]),
    and a long prompt through an SPMDEngine at sp 2 streams the JAX
    TPUEngine(sp=2)'s greedy ids after one OP_PREFILL_SP."""
    refs, outs = sp_runs
    leader = outs[2][0]
    (kind, ids), = leader["runs"]["moe"]
    assert kind == "done" and len(ids) == NEW
    assert ids == refs["jax_sp2_moe"]
    assert leader["stats"][MOE_CAP][0]["sp_prefill"] == 1
