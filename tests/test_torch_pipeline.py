"""Pipeline parallelism of the port against the JAX package's, on the CPU.

The mirror of tests/test_pipeline.py, in two parts.

In process, float32, on the same numpy inputs and weights (bridged with
from_jax_numpy): flat_slot_indices (exact), paged_chunk_attention and
paged_chunk_attention_blockwise (1e-5; the blockwise walk over several
blocks, a partial last block and an empty chunk row) against the JAX
functions; forward_prefill and forward_prefill_chunk against the JAX
forwards on every dense test-tiny config (logits within 2e-4, pools
within 1e-5 outside the trash page); chained chunks against one whole
prefill; n_microbatches against the JAX helper; a stage's seeded and
checkpoint weights against the same layers of a one-stage tree (bit for
bit).

In gloo processes, one world per width (2 and 4 ranks, one compute
thread each), every rank running every case of its width: the port's
pp_forward_prefill, then pp_forward_decode, then
pp_forward_prefill_chunk on top, against the JAX pp forwards jitted on
the test session's virtual CPU devices, with test_pipeline.py's
tolerances (logits 2e-4 on every rank, each rank's pools within 1e-5 of
its layers and heads of the JAX pools, outside the trash page). Cases:
pp 2 on test-tiny, pp 4 on a 4-layer test-tiny, pp 2 x tp 2 on
test-tiny-gqa and on test-tiny-qwen3 (q/k norms), and B 6 at pp 4
(3 microbatches). The pp-2 decode also runs on the plain path (the
kernel dispatch on CPU tensors and "plain") against the JAX pp decode
through the Pallas kernel in interpret mode
(test_pp2_decode_pallas_interpret_matches_reference).
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
from ollamamq_tpu.models import llama as jllama
from ollamamq_tpu.ops import attention as jattn
from ollamamq_tpu.parallel import pipeline as jpipeline
from ollamamq_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ollamamq_tpu_torch.config import MODEL_CONFIGS
from ollamamq_tpu_torch.models import llama as tllama
from ollamamq_tpu_torch.models import weights
from ollamamq_tpu_torch.ops import attention as tattn
from ollamamq_tpu_torch.parallel import pipeline as tpipeline
from ollamamq_tpu_torch.parallel.sharding import stage_layers
from test_torch_model import DENSE_TINY
from testutil import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PS = 8
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(model, num_layers=None):
    """(JAX config, port config), optionally at another depth."""
    jcfg, tcfg = JAX_CONFIGS[model], MODEL_CONFIGS[model]
    if num_layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=num_layers)
        tcfg = dataclasses.replace(tcfg, num_layers=num_layers)
    return jcfg, tcfg


def _np_params(jcfg, seed=0):
    """JAX init_params as numpy, biases and q/k norms randomised so those
    branches carry real numbers."""
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(seed),
                                       dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    for key in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if key in params["layers"]:
            a = params["layers"][key]
            params["layers"][key] = (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
    return params


# -------------------------------------------------------------- the ops
@pytest.mark.parametrize("H,Hk,block_pages", [(4, 2, 2), (8, 8, 3), (4, 1, 8)],
                         ids=["gqa-blocks2", "mha-partial-block", "mqa-one-block"])
def test_chunk_attention_ops_match_jax(H, Hk, block_pages):
    """flat_slot_indices exactly; the dense and blockwise chunk attentions
    within 1e-5 of the JAX functions, over a pool whose other slots hold
    noise, a row whose chunk starts mid-page after a prefix, a row with
    an empty chunk, and (block_pages 2, 3) several blocks with a partial
    last one (max_pages 7)."""
    rng = np.random.default_rng(H * 10 + Hk)
    B, C, hd, MP, S = 3, 6, 16, 7, 64 * PS
    kc = rng.normal(size=(S, Hk, hd)).astype(np.float32)
    vc = rng.normal(size=(S, Hk, hd)).astype(np.float32)
    q = rng.normal(size=(B, C, H, hd)).astype(np.float32)
    pt = rng.permutation(np.arange(1, 64))[:B * MP].reshape(B, MP).astype(np.int32)
    start = np.array([0, 13, 37], np.int32)
    clen = np.array([6, 4, 0], np.int32)
    pos = (start[:, None] + np.arange(C)[None, :]).astype(np.int32)
    np.testing.assert_array_equal(
        tattn.flat_slot_indices(torch.from_numpy(pt), torch.from_numpy(pos), PS).numpy(),
        np.asarray(jattn.flat_slot_indices(jnp.asarray(pt), jnp.asarray(pos), PS)))
    t = [torch.from_numpy(a) for a in (q, kc, vc, pt, start, clen)]
    j = [jnp.asarray(a) for a in (q, kc, vc, pt, start, clen)]
    dense_t = tattn.paged_chunk_attention(*t, PS).numpy()
    dense_j = np.asarray(jattn.paged_chunk_attention(*j, PS))
    block_t = tattn.paged_chunk_attention_blockwise(*t, PS, block_pages=block_pages).numpy()
    block_j = np.asarray(jattn.paged_chunk_attention_blockwise(
        *j, PS, block_pages=block_pages))
    # Rows past each chunk's length are padding: compare the real ones.
    for b in range(B):
        n = int(clen[b])
        np.testing.assert_allclose(dense_t[b, :n], dense_j[b, :n], **KV_TOL)
        np.testing.assert_allclose(block_t[b, :n], block_j[b, :n], **KV_TOL)
        np.testing.assert_allclose(block_t[b, :n], dense_t[b, :n], **KV_TOL)


def _prefill_inputs(tcfg, B=3, T=16, MP=6, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, tcfg.vocab_size, size=(B, T)).astype(np.int32)
    lens = np.array([T, T // 2 + 1, 5][:B], np.int32)
    pt = np.arange(1, 1 + B * MP, dtype=np.int32).reshape(B, MP)[:, ::-1].copy()
    return tokens, lens, pt


@pytest.mark.parametrize("name", DENSE_TINY)
def test_prefill_forwards_match_jax(name):
    """forward_prefill, then a chunk on top of it (forward_prefill_chunk),
    against the JAX forwards: logits within 2e-4, pools within 1e-5
    outside the trash page."""
    jcfg, tcfg = _cfgs(name)
    pnp = _np_params(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, pnp)
    tp = weights.from_jax_numpy(pnp, tcfg)
    tokens, lens, pt = _prefill_inputs(tcfg)
    B, NP = tokens.shape[0], 24
    shape = (tcfg.num_layers, NP * PS, tcfg.num_kv_heads, tcfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    jl, jk, jv = jllama.forward_prefill(jp, jcfg, jnp.asarray(tokens), jnp.asarray(lens),
                                        jk, jv, jnp.asarray(pt), PS)
    tl, _, _ = tllama.forward_prefill(tp, tcfg, torch.from_numpy(tokens),
                                      torch.from_numpy(lens), tk, tv,
                                      torch.from_numpy(pt), PS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tk[:, PS:].numpy(), np.asarray(jk)[:, PS:], **KV_TOL)
    np.testing.assert_allclose(tv[:, PS:].numpy(), np.asarray(jv)[:, PS:], **KV_TOL)
    rng = np.random.default_rng(7)
    C = 8
    chunk = rng.integers(1, tcfg.vocab_size, size=(B, C)).astype(np.int32)
    clen = np.array([8, 3, 6][:B], np.int32)
    jl2, jk, jv = jllama.forward_prefill_chunk(
        jp, jcfg, jnp.asarray(chunk), jnp.asarray(lens), jnp.asarray(clen), jk, jv,
        jnp.asarray(pt), PS)
    tl2, _, _ = tllama.forward_prefill_chunk(
        tp, tcfg, torch.from_numpy(chunk), torch.from_numpy(lens),
        torch.from_numpy(clen), tk, tv, torch.from_numpy(pt), PS)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **LOGIT_TOL)
    np.testing.assert_allclose(tk[:, PS:].numpy(), np.asarray(jk)[:, PS:], **KV_TOL)
    np.testing.assert_allclose(tv[:, PS:].numpy(), np.asarray(jv)[:, PS:], **KV_TOL)


def test_chained_chunks_match_one_prefill():
    """A 21-token prompt prefilled whole and as chunks of 8, 8 and 5: the
    final logits within 2e-4 and the prompt's K/V within 1e-5."""
    _, tcfg = _cfgs("test-tiny-gqa")
    params = weights.load_params(tcfg, seed=3, dtype=torch.float32)
    rng = np.random.default_rng(5)
    n, MP = 21, 4
    prompt = torch.from_numpy(rng.integers(1, tcfg.vocab_size, size=(1, 32)).astype(np.int32))
    pt = torch.tensor([[3, 1, 4, 2]], dtype=torch.int32)
    shape = (tcfg.num_layers, 8 * PS, tcfg.num_kv_heads, tcfg.head_dim)
    k1, v1, k2, v2 = (torch.zeros(shape) for _ in range(4))
    whole, _, _ = tllama.forward_prefill(params, tcfg, prompt, torch.tensor([n]),
                                         k1, v1, pt, PS)
    for start in (0, 8, 16):
        cl = min(8, n - start)
        toks = torch.zeros((1, 8), dtype=torch.int32)
        toks[0, :cl] = prompt[0, start:start + cl]
        last, _, _ = tllama.forward_prefill_chunk(
            params, tcfg, toks, torch.tensor([start], dtype=torch.int32),
            torch.tensor([cl], dtype=torch.int32), k2, v2, pt, PS)
    np.testing.assert_allclose(last.numpy(), whole.numpy(), **LOGIT_TOL)
    slots = tattn.flat_slot_indices(pt, torch.arange(n)[None], PS)[0]
    for a, b in ((k1, k2), (v1, v2)):
        np.testing.assert_allclose(a[:, slots].numpy(), b[:, slots].numpy(), **KV_TOL)


def test_n_microbatches_helper():
    for args in ((8, 4), (6, 4), (1, 4), (7, 4), (8, 4, 2), (4, 8), (8, 2, 3),
                 (6, 2, 4)):
        assert tpipeline.n_microbatches(*args) == jpipeline.n_microbatches(*args)
    assert tpipeline.n_microbatches(8, 2, 3) == 2  # rounded down to a divisor


@pytest.mark.parametrize("pp,tp,int8", [(2, 1, False), (4, 1, True), (2, 2, False)],
                         ids=["pp2", "pp4-int8", "pp2xtp2"])
def test_stage_weights_equal_the_one_stage_tree(pp, tp, int8, tmp_path):
    """Each stage's seeded weights, and its weights read from a checkpoint
    (only its layers), equal the same layers of the one-stage tree bit for
    bit; the embedding, final norm and head are whole on every stage."""
    _, tcfg = _cfgs("test-tiny", num_layers=4)
    wd = "int8" if int8 else "bfloat16"
    full = weights.load_params(tcfg, seed=5, dtype=torch.float32, weights_dtype=wd)
    ckpt = str(tmp_path / "ckpt")
    weights.save_safetensors(weights.load_params(tcfg, seed=5, dtype=torch.float32),
                             tcfg, ckpt)

    def leaves(p):
        out = [p[k] for k in sorted(p) if k != "layers"]
        out += [lp[k] for lp in p["layers"] for k in sorted(lp)]
        return [x for t in out for x in ((t.q, t.s) if hasattr(t, "q") else (t,))]

    for stage in range(pp):
        for r in range(tp):
            want = weights.tp_slice(weights.stage_slice(full, tcfg, pp, stage), tcfg, tp, r)
            lo, hi = stage_layers(tcfg.num_layers, pp, stage)
            assert len(want["layers"]) == hi - lo
            for src in (None, ckpt):
                got = weights.load_params(tcfg, src, seed=5, dtype=torch.float32,
                                          weights_dtype=wd, tp=tp, rank=r, pp=pp,
                                          stage=stage)
                a, b = leaves(got), leaves(want)
                assert len(a) == len(b)
                assert all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------ the pp forwards, gloo
# case -> (model, depth override, pp, tp, batch)
CASES = {
    "pp2": ("test-tiny", None, 2, 1, 4),
    "pp4": ("test-tiny", 4, 4, 1, 4),
    "pp2xtp2": ("test-tiny-gqa", None, 2, 2, 4),
    "pp2xtp2-qwen3": ("test-tiny-qwen3", None, 2, 2, 4),
    "pp4-b6": ("test-tiny", 4, 4, 1, 6),
}
T, C, NPAGES = 16, 8, 64

CHILD = r"""
import dataclasses, os, pickle, sys
rank, world, port, case_file, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                         int(sys.argv[3]), sys.argv[4], sys.argv[5])
import torch
torch.set_num_threads(1)
from ollamamq_tpu_torch.config import MODEL_CONFIGS
from ollamamq_tpu_torch.engine.kv_cache import local_kv_heads
from ollamamq_tpu_torch.models.weights import from_jax_numpy, tp_slice
from ollamamq_tpu_torch.parallel import distributed, pipeline
from ollamamq_tpu_torch.parallel.mesh import make_mesh
from ollamamq_tpu_torch.parallel.sharding import stage_layers

distributed.initialize(f"127.0.0.1:{port}", world, rank, devices=["cpu"] * world,
                       timeout_s=60)
with open(case_file, "rb") as f:
    cases = pickle.load(f)
meshes = {}
out = {}
for key, c in cases.items():
    pp, tp = c["pp"], c["tp"]
    if (pp, tp) not in meshes:  # every rank builds the meshes in one order
        meshes[(pp, tp)] = make_mesh(pp=pp, tp=tp)
    mesh = meshes[(pp, tp)]
    cfg = MODEL_CONFIGS[c["model"]]
    if c["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=c["layers"])
    stage, t = mesh.pipe.stage, mesh.coord["tensor"]
    lo, hi = stage_layers(cfg.num_layers, pp, stage)
    params = tp_slice(from_jax_numpy(c["params"], cfg, layers=(lo, hi)), cfg, tp, t)
    shape = (hi - lo, c["slots"], local_kv_heads(cfg, tp), cfg.head_dim)
    kc, vc = torch.zeros(shape), torch.zeros(shape)
    a = {k: torch.from_numpy(v) for k, v in c["arrays"].items()}
    before = dict(mesh.pipe.stats)
    ps = c["page_size"]
    pre, _, _ = pipeline.pp_forward_prefill(params, cfg, a["tokens"], a["lens"], kc, vc,
                                            a["pt"], ps, mesh)
    dec, _, _ = pipeline.pp_forward_decode(params, cfg, a["next"], a["lens"], kc, vc,
                                           a["pt"], ps, mesh)
    res = {"prefill": pre.numpy(), "decode": dec.numpy()}
    if c["plain_decode"]:
        # The same step again on the plain path: it rewrites the same K/V.
        res["decode_plain"] = pipeline.pp_forward_decode(
            params, cfg, a["next"], a["lens"], kc, vc, a["pt"], ps, mesh,
            attn_impl="plain")[0].numpy()
    chk, _, _ = pipeline.pp_forward_prefill_chunk(params, cfg, a["chunk"], a["start"],
                                                  a["clen"], kc, vc, a["pt"], ps, mesh)
    res.update(chunk=chk.numpy(), k=kc.numpy(), v=vc.numpy(), stage=stage, tensor=t,
               layers=(lo, hi),
               stats={k: v - before[k] for k, v in mesh.pipe.stats.items()})
    out[key] = res
with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
distributed.exit_process(0)  # never through torch's teardown of live groups
"""


def _case(model, layers, pp, tp, B):
    """A case's weights and inputs: a prefill batch, the decode step on
    top (its tokens set from the JAX prefill's argmax), a chunk after
    it."""
    jcfg, tcfg = _cfgs(model, layers)
    rng = np.random.default_rng(B * 7 + pp)
    MP = (T + 1 + C) // PS + 1
    lens = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
    arrays = {"tokens": rng.integers(1, tcfg.vocab_size, size=(B, T)).astype(np.int32),
              "lens": lens,
              "pt": (1 + np.arange(B * MP, dtype=np.int32)).reshape(B, MP),
              "chunk": rng.integers(1, tcfg.vocab_size, size=(B, C)).astype(np.int32),
              "start": (lens + 1).astype(np.int32),
              "clen": rng.integers(1, C + 1, size=B).astype(np.int32)}
    return {"model": model, "layers": layers, "pp": pp, "tp": tp,
            "params": _np_params(jcfg), "page_size": PS, "slots": NPAGES * PS,
            "plain_decode": tp == 1 and pp == 2, "arrays": arrays}


def _jax_reference(case):
    """The JAX pp forwards on a (pp, tp) mesh of virtual CPU devices:
    prefill, one decode step, a chunk; with plain_decode, the decode
    through the Pallas kernel in interpret mode too."""
    jcfg, _ = _cfgs(case["model"], case["layers"])
    jp = jax.tree_util.tree_map(jnp.asarray, case["params"])
    a = {k: jnp.asarray(v) for k, v in case["arrays"].items()}
    mesh = jax_make_mesh(dp=1, pp=case["pp"], tp=case["tp"])
    shape = (jcfg.num_layers, NPAGES * PS, jcfg.num_kv_heads, jcfg.head_dim)
    jk = jv = jnp.zeros(shape, jnp.float32)
    pre, jk, jv = jpipeline.pp_forward_prefill(jp, jcfg, a["tokens"], a["lens"], jk,
                                               jv, a["pt"], PS, mesh)
    assert np.array_equal(np.asarray(jnp.argmax(pre, axis=-1)), case["arrays"]["next"])
    dec_in = (jk, jv)
    dec, jk, jv = jpipeline.pp_forward_decode(jp, jcfg, a["next"], a["lens"], jk, jv,
                                              a["pt"], PS, mesh)
    pallas = None
    if case["plain_decode"]:
        pallas = np.asarray(jpipeline.pp_forward_decode(
            jp, jcfg, a["next"], a["lens"], *dec_in, a["pt"], PS, mesh,
            attn_impl="pallas", interpret=True)[0])
    chk, jk, jv = jpipeline.pp_forward_prefill_chunk(jp, jcfg, a["chunk"], a["start"],
                                                     a["clen"], jk, jv, a["pt"], PS,
                                                     mesh)
    return {"prefill": np.asarray(pre), "decode": np.asarray(dec),
            "chunk": np.asarray(chk), "pallas": pallas,
            "k": np.asarray(jk), "v": np.asarray(jv)}


def _launch(world, cases, tmp):
    """Start CHILD in `world` gloo processes over `cases`; returns a
    function that waits for them and gives each rank's outputs. Every
    process is killed on the way out."""
    case_file = os.path.join(tmp, f"cases{world}.pkl")
    with open(case_file, "wb") as f:
        pickle.dump(cases, f)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    logs = [open(os.path.join(tmp, f"w{world}r{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(world),
                               str(port), case_file, tmp], cwd=REPO, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]

    def wait():
        try:
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
        for r, p in enumerate(procs):
            assert p.returncode == 0, open(os.path.join(
                tmp, f"w{world}r{r}.log")).read()[-3000:]
        outs = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                outs.append(pickle.load(f))
        return outs

    return wait


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    """Every case's inputs, then one gloo world per width started at
    once, and the JAX references computed while the worlds run."""
    cases, by_world = {}, {}
    for key, args in CASES.items():
        cases[key] = _case(*args)
        # The decode step's tokens: the prefill's greedy ids (from the
        # port's single-stage forward; the JAX prefill must agree).
        c, (_, tcfg) = cases[key], _cfgs(args[0], args[1])
        a = {k: torch.from_numpy(v) for k, v in c["arrays"].items()}
        shape = (tcfg.num_layers, NPAGES * PS, tcfg.num_kv_heads, tcfg.head_dim)
        logits, _, _ = tllama.forward_prefill(
            weights.from_jax_numpy(c["params"], tcfg), tcfg, a["tokens"], a["lens"],
            torch.zeros(shape), torch.zeros(shape), a["pt"], PS)
        c["arrays"]["next"] = logits.argmax(-1).to(torch.int32).numpy()
        by_world.setdefault(args[2] * args[3], {})[key] = c
    waits = {world: _launch(world, group, str(tmp_path_factory.mktemp(f"pp{world}")))
             for world, group in sorted(by_world.items())}
    refs = {key: _jax_reference(c) for key, c in cases.items()}
    return refs, {world: wait() for world, wait in waits.items()}


@pytest.mark.parametrize("key", list(CASES))
def test_pp_forwards_match_jax_pipeline(key, pp_runs):
    """Prefill, decode and chunk logits within 2e-4 of the JAX pp
    forwards and bit-identical on every rank; each rank's pools within
    1e-5 of its stage's layers and its heads of the JAX pools, outside
    the trash page; every stage handed off per microbatch."""
    refs, outs = pp_runs
    model, layers, pp, tp, B = CASES[key]
    ref = refs[key]
    ranks = [o[key] for o in outs[pp * tp]]
    M = tpipeline.n_microbatches(B, pp)
    for r in ranks:
        for what in ("prefill", "decode", "chunk"):
            np.testing.assert_allclose(r[what], ref[what], **LOGIT_TOL)
            np.testing.assert_array_equal(r[what], ranks[0][what])
        lo, hi = r["layers"]
        hk = r["k"].shape[2]
        t = r["tensor"]
        for mine, full in ((r["k"], ref["k"]), (r["v"], ref["v"])):
            np.testing.assert_allclose(mine[:, PS:], full[lo:hi, PS:, t * hk:(t + 1) * hk],
                                       **KV_TOL)
        # Three forwards: M microbatches to the next stage, or the
        # gathered hidden states to every other stage from the last.
        sends = 3 * (pp - 1) if r["stage"] == pp - 1 else 3 * M
        assert r["stats"]["forwards"] == 3 + ("decode_plain" in r)
        assert r["stats"]["sends"] == sends + ("decode_plain" in r) * sends // 3


def test_pp2_decode_pallas_interpret_matches_reference(pp_runs):
    """The pp-2 decode on the port's plain path (the kernel dispatch with
    CPU tensors, and "plain") against the JAX pp decode through the
    Pallas kernel in interpret mode, within 2e-4."""
    refs, outs = pp_runs
    pallas = refs["pp2"]["pallas"]
    assert pallas is not None
    np.testing.assert_allclose(pallas, refs["pp2"]["decode"], **LOGIT_TOL)
    for o in outs[2]:
        np.testing.assert_allclose(o["pp2"]["decode"], pallas, **LOGIT_TOL)
        np.testing.assert_allclose(o["pp2"]["decode_plain"], pallas, **LOGIT_TOL)
