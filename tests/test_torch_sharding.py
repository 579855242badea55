"""Tensor parallelism of the port against the JAX package's, on the CPU.

The mirror of tests/test_sharding.py: mesh shapes and tp=-1, the
partition rule of every leaf (QuantTensor scales and MoE experts
included) against the JAX package's PartitionSpecs, each rank's slice of
the weights against the JAX tree sharded on its tensor-parallel mesh,
validate_tp_for_model, and the port's tensor-parallel forwards in gloo
processes (one per rank, one compute thread each) against the JAX
forwards jitted on a tp mesh of the test session's virtual CPU devices,
on the same numpy weights: forward_ragged over two ticks of prefill
spans and decode rows, then two forward_decode steps. Logits within
atol = rtol = 1e-4 in float32 and bit-identical on every rank; each
rank's K/V pool equals its heads of the JAX pool (int8: dequantized
within one quantization step). Cases: test-tiny, test-tiny-qwen
(biases), test-tiny-moe (each expert's F cut, the router replicated),
test-tiny with int8 weights and int8 KV, all at tp 2, and test-tiny-gqa
at tp 8 over its 4 KV heads (replicated groups: every rank holds one
duplicated head).

tests/test_sharding.py::test_multihost_dp_picks_devices_from_every_process
has no counterpart here: a rank owns one device, so a data-parallel
replica is a set of ranks (tests/test_torch_dp_replicas.py).
"""

import os
import pickle
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.models import llama as jllama
from ollamamq_tpu.models import weights as jweights
from ollamamq_tpu.ops.quant import QuantKV as JaxQuantKV
from ollamamq_tpu.ops.quant import QuantTensor as JaxQuantTensor
from ollamamq_tpu.parallel import make_mesh as jax_make_mesh
from ollamamq_tpu.parallel import param_partition_specs as jax_specs
from ollamamq_tpu.parallel import shard_params as jax_shard_params
from ollamamq_tpu.parallel.sharding import kv_cache_spec as jax_kv_spec
from ollamamq_tpu.parallel.sharding import kv_scale_spec as jax_scale_spec
from ollamamq_tpu_torch.config import MODEL_CONFIGS
from ollamamq_tpu_torch.models.weights import from_jax_numpy, tp_slice
from ollamamq_tpu_torch.ops.quant import QuantTensor
from ollamamq_tpu_torch.parallel import make_mesh, param_partition_specs
from ollamamq_tpu_torch.parallel.mesh import (AXES, RankMesh, shard_range,
                                              validate_tp_for_model)
from ollamamq_tpu_torch.parallel.sharding import kv_cache_spec, kv_scale_spec
from test_torch_model import MP, NPAGES, PS, TOL, _np_params, _ragged_meta
from testutil import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# case -> (model, tp, int8)
CASES = {
    "test-tiny": ("test-tiny", 2, False),
    "test-tiny-qwen": ("test-tiny-qwen", 2, False),
    "test-tiny-moe": ("test-tiny-moe", 2, False),
    "test-tiny-int8": ("test-tiny", 2, True),
    "test-tiny-gqa-tp8": ("test-tiny-gqa", 8, False),
}

# One gloo world per width: every rank runs every case of its width and
# pickles its logits and pools.
CHILD = r"""
import os, pickle, sys
rank, world, port, case_file, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                         int(sys.argv[3]), sys.argv[4], sys.argv[5])
import torch
torch.set_num_threads(1)
from ollamamq_tpu_torch.config import MODEL_CONFIGS
from ollamamq_tpu_torch.engine.kv_cache import local_kv_heads
from ollamamq_tpu_torch.models import llama
from ollamamq_tpu_torch.models.weights import from_jax_numpy, tp_slice
from ollamamq_tpu_torch.ops.quant import QuantKV
from ollamamq_tpu_torch.parallel import distributed
from ollamamq_tpu_torch.parallel.mesh import make_mesh

distributed.initialize(f"127.0.0.1:{port}", world, rank, devices=["cpu"] * world,
                       timeout_s=60)
mesh = make_mesh(tp=world)
assert mesh.tp == world and mesh.tensor.rank == rank and mesh.n_devices == 1
with open(case_file, "rb") as f:
    cases = pickle.load(f)
out = {}
for key, c in cases.items():
    cfg = MODEL_CONFIGS[c["model"]]
    params = tp_slice(from_jax_numpy(c["params"], cfg), cfg, world, rank)
    shape = (cfg.num_layers, c["slots"], local_kv_heads(cfg, world), cfg.head_dim)

    def pool():
        if c["int8"]:
            return QuantKV(torch.zeros(shape, dtype=torch.int8),
                           torch.ones(shape[:-1], dtype=torch.float32))
        return torch.zeros(shape)

    kc, vc = pool(), pool()
    pt = torch.from_numpy(c["pt"])
    logits = []
    for kind, arrays in c["steps"]:
        t = [torch.from_numpy(a) for a in arrays]
        if kind == "ragged":
            lg, _, _ = llama.forward_ragged(params, cfg, *t[:5], kc, vc, pt,
                                            *t[5:], c["page_size"], tp=mesh.tensor)
        else:
            lg, _, _ = llama.forward_decode(params, cfg, *t, kc, vc, pt,
                                            c["page_size"], tp=mesh.tensor)
        logits.append(lg.numpy())

    def host(p):
        return (p.q.numpy(), p.s.numpy()) if c["int8"] else p.numpy()

    out[key] = {"logits": logits, "k": host(kc), "v": host(vc)}
with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
distributed.exit_process(0)  # never through torch's teardown of live groups
"""


def _plain(tree):
    """A numpy params tree with the JAX QuantTensor leaves as plain (q, s)
    namespaces, so the JAX-free child processes can unpickle it."""
    def leaf(a):
        if isinstance(a, JaxQuantTensor):
            return types.SimpleNamespace(q=np.asarray(a.q), s=np.asarray(a.s))
        return np.asarray(a)

    out = {k: leaf(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: leaf(v) for k, v in tree["layers"].items()}
    return out


def _steps(cfg, B=3):
    """The test_torch_model ticks: two ragged dispatches, two decode
    steps. Returns (page table, [(kind, arrays)], real rows per step)."""
    rng = np.random.default_rng(1)
    pt = np.zeros((B, MP), np.int32)
    pt[0, :3] = [1, 2, 3]
    pt[1, :2] = [7, 5]
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (18, 11)]

    def ragged(tokens, spans, T):
        tok_seq, tok_pos, q_start, q_len, kv_len = _ragged_meta(spans, T, B)
        ws = np.array([pt[s][p // PS] * PS + p % PS if p >= 0 else 0
                       for s, p in zip(tok_seq, tok_pos)], np.int32)
        out_idx = np.clip(q_start + q_len - 1, 0, T - 1).astype(np.int32)
        return ("ragged", [tokens, tok_seq, tok_pos, ws, out_idx, q_start,
                           q_len, kv_len]), [s for s, *_ in spans]

    toks1 = np.zeros(24, np.int32)
    toks1[:18], toks1[18:22] = prompts[0], prompts[1][:4]
    toks2 = np.zeros(16, np.int32)
    toks2[0], toks2[1:8] = 42, prompts[1][4:]
    ticks = [ragged(toks1, [(0, 0, 18, 18), (1, 0, 4, 4)], 24),
             ragged(toks2, [(0, 18, 1, 19), (1, 4, 7, 11)], 16)]
    steps = [st for st, _ in ticks]
    real = [rows for _, rows in ticks]
    for step in range(2):
        steps.append(("decode", [np.array([7 + step, 9 + step, 0], np.int32),
                                 np.array([19 + step, 11 + step, 0], np.int32)]))
        real.append([0, 1])
    return pt, steps, real


def _jax_reference(model, tp, int8):
    """The JAX forwards on a tp mesh of virtual CPU devices: logits per
    step and the final (global) pools."""
    jcfg = JAX_CONFIGS[model]
    pnp = _np_params(model)
    jparams = jax.tree_util.tree_map(jnp.asarray, pnp)
    if int8:
        jparams = jweights.quantize_params_int8(jparams, jcfg)
    host = _plain(jax.tree_util.tree_map(np.asarray, jparams))
    run_cfg = jcfg
    if tp > jcfg.num_kv_heads:  # the JAX runtime's replicated-group load
        jparams = jweights.replicate_kv_heads(jparams, jcfg,
                                              tp // jcfg.num_kv_heads)
        import dataclasses

        run_cfg = dataclasses.replace(jcfg, num_kv_heads=tp)
    mesh = jax_make_mesh(dp=1, tp=tp, devices=jax.devices()[:tp])
    sparams = jax_shard_params(jparams, mesh)
    shape = (run_cfg.num_layers, NPAGES * PS, run_cfg.num_kv_heads,
             run_cfg.head_dim)
    kvs = NamedSharding(mesh, jax_kv_spec())

    def pool():
        if int8:
            return JaxQuantKV(
                jax.device_put(jnp.zeros(shape, jnp.int8), kvs),
                jax.device_put(jnp.ones(shape[:-1], jnp.float32),
                               NamedSharding(mesh, jax_scale_spec())))
        return jax.device_put(jnp.zeros(shape, jnp.float32), kvs)

    jk, jv = pool(), pool()
    pt, steps, real = _steps(MODEL_CONFIGS[model])

    @jax.jit
    def ragged(p, kc, vc, *a):
        return jllama.forward_ragged(p, run_cfg, *a[:5], kc, vc, jnp.asarray(pt),
                                     *a[5:], PS, attn_impl="jnp")

    @jax.jit
    def decode(p, kc, vc, tokens, positions):
        return jllama.forward_decode(p, run_cfg, tokens, positions, kc, vc,
                                     jnp.asarray(pt), PS, attn_impl="jnp")

    logits = []
    with jax.set_mesh(mesh):
        for kind, arrays in steps:
            fn = ragged if kind == "ragged" else decode
            lg, jk, jv = fn(sparams, jk, jv, *map(jnp.asarray, arrays))
            logits.append(np.asarray(lg))

    def host_pool(p):
        return (np.asarray(p.q), np.asarray(p.s)) if int8 else np.asarray(p)

    case = {"model": model, "int8": int8, "params": host, "pt": pt,
            "steps": steps, "page_size": PS, "slots": NPAGES * PS}
    return case, logits, real, host_pool(jk), host_pool(jv)


def _launch(world, cases, tmp):
    """Run CHILD in `world` gloo processes over `cases`; returns each
    rank's outputs. Every process is killed on the way out."""
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
    try:
        deadline = time.monotonic() + 150
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
        assert p.returncode == 0, open(os.path.join(tmp, f"w{world}r{r}.log")).read()[-3000:]
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """JAX references for every case, then one gloo world per width."""
    refs, by_world = {}, {}
    for key, (model, tp, int8) in CASES.items():
        case, logits, real, jk, jv = _jax_reference(model, tp, int8)
        refs[key] = (logits, real, jk, jv)
        by_world.setdefault(tp, {})[key] = case
    outs = {}
    for world, cases in by_world.items():
        tmp = str(tmp_path_factory.mktemp(f"tp{world}"))
        outs[world] = _launch(world, cases, tmp)
    return refs, outs


@pytest.mark.parametrize("key", list(CASES))
def test_tp_forwards_match_jax_mesh(key, tp_runs):
    refs, outs = tp_runs
    model, tp, int8 = CASES[key]
    logits, real, jk, jv = refs[key]
    ranks = [o[key] for o in outs[tp]]
    for i, (ref, rows) in enumerate(zip(logits, real)):
        got = ranks[0]["logits"][i]
        np.testing.assert_allclose(got[rows], ref[rows], **TOL)
        # Every rank holds the same full logits (it samples the same ids).
        for other in ranks[1:]:
            assert np.array_equal(other["logits"][i], got)
    heads = (jk[0] if int8 else jk).shape[2]
    for r, out in enumerate(ranks):
        lo, hi = shard_range(heads, tp, r)
        for got, ref in ((out["k"], jk), (out["v"], jv)):
            if int8:
                deq_t = got[0][:, PS:].astype(np.float32) * got[1][:, PS:, :, None]
                rq, rs = ref[0][:, PS:, lo:hi], ref[1][:, PS:, lo:hi]
                deq_j = rq.astype(np.float32) * rs[..., None]
                step = np.maximum(got[1][:, PS:], rs)[..., None] * (1 + 1e-5)
                assert (np.abs(deq_t - deq_j) <= step).all()
            else:
                np.testing.assert_allclose(got[:, PS:], ref[:, PS:, lo:hi], **TOL)


def test_mesh_shapes():
    mesh = make_mesh(tp=-1, devices=["cpu"] * 4)
    assert mesh.shape["tensor"] == 4 and mesh.shape["data"] == 1
    assert mesh.axis_names == AXES == ("data", "pipe", "seq", "expert", "tensor")
    assert mesh.ranks.shape == (1, 1, 1, 1, 4)
    assert mesh.tensor.size == 4 and mesh.n_devices == 1
    assert make_mesh().tp == 1 and make_mesh().tensor is None
    two = RankMesh({"tensor": 2}, 1, ["cuda:0", "cuda:1"])
    assert two.device == torch.device("cuda:1") and two.n_devices == 2
    shared = RankMesh({"tensor": 2}, 0, ["cuda:0", "cuda:0"])
    assert shared.n_devices == 1  # two ranks on one card: one card's peak
    # The expert axis is ported: ep 2 x tp 2, rank 3 is expert shard 1's
    # tensor rank 1 (see tests/test_torch_ep.py for its groups).
    ep = make_mesh(devices=["cpu"] * 4, ep=2, rank=3)
    assert ep.ranks.shape == (1, 1, 1, 2, 2) and ep.ep == 2 and ep.tp == 2
    assert ep.expert.index == 1 and ep.tensor.rank == 1
    # The seq axis is ported: sp 2 x tp 2, rank 3 is shard 1's tensor
    # rank 1, its ring ranks 1 and 3.
    seq = make_mesh(sp=2, devices=["cpu"] * 4, rank=3)
    assert seq.ranks.shape == (1, 1, 2, 1, 2) and seq.sp == 2 and seq.tp == 2
    assert seq.seq.index == 1 and seq.seq.ranks == [1, 3] and seq.seq.next == 0
    # The data axis is ported: replicas over ranks (see
    # tests/test_torch_dp_replicas.py for its shapes).
    assert make_mesh(dp=2, devices=["cpu"] * 4).shape["data"] == 2
    with pytest.raises(ValueError, match="span every rank"):
        make_mesh(tp=2, devices=["cpu"] * 4)
    # The pipe axis: ranks in (data, pipe, seq, expert, tensor) order,
    # tp=-1 filling what pp leaves; rank 3 is stage 1's tensor rank 1.
    pp = make_mesh(pp=2, devices=["cpu"] * 4, rank=3)
    assert pp.ranks.shape == (1, 2, 1, 1, 2) and pp.tp == 2 and pp.pp == 2
    assert pp.pipe.stage == 1 and pp.pipe.ranks == [1, 3] and pp.pipe.last
    assert pp.tensor.rank == 1 and pp.n_devices == 1
    assert make_mesh(pp=2, devices=["cpu"] * 2).tensor is None
    assert make_mesh().pipe is None
    with pytest.raises(ValueError, match="span every rank"):
        make_mesh(pp=3, devices=["cpu"] * 4)


def _tensor_dim(spec, ndim, stacked):
    """The dim a JAX PartitionSpec puts on "tensor", in this package's
    per-layer numbering (negative from the right for stacked layer
    leaves), or None."""
    dims = list(spec) + [None] * (ndim - len(spec))
    if "tensor" not in dims:
        return None
    i = dims.index("tensor")
    return i - ndim if stacked else i


@pytest.mark.parametrize("model,int8", [("test-tiny", False),
                                        ("test-tiny-qwen", False),
                                        ("test-tiny-qwen3", False),
                                        ("test-tiny-moe", False),
                                        ("test-tiny", True)],
                         ids=["tiny", "qwen", "qwen3", "moe", "int8"])
def test_partition_specs_match_jax(model, int8):
    """Every leaf's cut dim (and a QuantTensor's scales') is the JAX
    PartitionSpec's tensor dim."""
    jcfg = JAX_CONFIGS[model]
    jparams = jax.tree_util.tree_map(jnp.asarray, _np_params(model))
    if int8:
        jparams = jweights.quantize_params_int8(jparams, jcfg)
    jspecs = jax_specs(jparams)
    tparams = from_jax_numpy(_plain(jax.tree_util.tree_map(np.asarray, jparams)),
                             MODEL_CONFIGS[model])
    specs = param_partition_specs(tparams)

    def check(jspec, jleaf, spec, stacked):
        if isinstance(jleaf, JaxQuantTensor):
            assert isinstance(spec, QuantTensor)
            check(jspec.q, jleaf.q, spec.q, stacked)
            check(jspec.s, jleaf.s, spec.s, stacked)
            return
        assert spec == _tensor_dim(jspec, jleaf.ndim, stacked)

    for name, leaf in jparams.items():
        if name != "layers":
            check(jspecs[name], leaf, specs[name], False)
    seen = set()
    for name, leaf in jparams["layers"].items():
        for lp in specs["layers"]:
            check(jspecs["layers"][name], leaf, lp[name], True)
        seen.add(name)
    assert {"wq", "wo", "w_gate" if not jcfg.num_experts else "we_gate"} <= seen
    assert specs["final_norm"] is None
    assert specs["embed"] == (QuantTensor(0, 0) if int8 else 0)
    assert kv_cache_spec() == list(jax_kv_spec()).index("tensor")
    assert kv_scale_spec() == list(jax_scale_spec()).index("tensor")


@pytest.mark.parametrize("model,int8,tp", [("test-tiny", False, 2),
                                           ("test-tiny-moe", False, 2),
                                           ("test-tiny", True, 2),
                                           ("test-tiny-qwen", False, 2),
                                           ("test-tiny-gqa", False, 8)],
                         ids=["tiny", "moe", "int8", "qwen", "gqa-tp8"])
def test_rank_slices_match_jax_shards(model, int8, tp):
    """Each rank's slice of the weights equals its device's shard of the
    JAX tree placed on the tp mesh (replicated KV heads first where tp >
    kv heads, as both runtimes load them)."""
    jcfg = JAX_CONFIGS[model]
    jparams = jax.tree_util.tree_map(jnp.asarray, _np_params(model))
    if int8:
        jparams = jweights.quantize_params_int8(jparams, jcfg)
    whole = from_jax_numpy(_plain(jax.tree_util.tree_map(np.asarray, jparams)),
                           MODEL_CONFIGS[model])
    if tp > jcfg.num_kv_heads:
        jparams = jweights.replicate_kv_heads(jparams, jcfg,
                                              tp // jcfg.num_kv_heads)
    mesh = jax_make_mesh(dp=1, tp=tp, devices=jax.devices()[:tp])
    sharded = jax_shard_params(jparams, mesh)
    devices = list(mesh.devices.flatten())

    def shard_of(arr, r):
        return np.asarray(next(s.data for s in arr.addressable_shards
                               if s.device == devices[r]))

    def same(t, arr, r, layer=None):
        if isinstance(t, QuantTensor):
            same(t.q, arr.q, r, layer)
            same(t.s, arr.s, r, layer)
            return
        ref = shard_of(arr, r)
        ref = ref[layer] if layer is not None else ref
        np.testing.assert_array_equal(t.numpy(), ref)

    for r in range(tp):
        mine = tp_slice(whole, MODEL_CONFIGS[model], tp, r)
        for name, t in mine.items():
            if name != "layers":
                same(t, sharded[name], r)
        for i, lp in enumerate(mine["layers"]):
            for name, t in lp.items():
                same(t, sharded["layers"][name], r, layer=i)


@pytest.mark.parametrize("model", ["test-tiny", "test-tiny-qwen3"])
def test_pipeline_specs_match_jax(model):
    """The PP(xTP) layout against the JAX package's pipeline_param_specs
    and kv_cache_spec(pp=True): exactly the layer leaves are cut over
    pipe (on their layer index), every leaf keeps its tensor-axis spec,
    and the pool's layer dim is on pipe with kv_heads on tensor."""
    from ollamamq_tpu.parallel.sharding import pipeline_param_specs as jax_pp_specs
    from ollamamq_tpu_torch.parallel import kv_pipe_spec, pipeline_param_specs

    jparams = jax.tree_util.tree_map(jnp.asarray, _np_params(model))
    jspecs = jax_pp_specs(jparams)
    tspecs = pipeline_param_specs(from_jax_numpy(_np_params(model), MODEL_CONFIGS[model]))
    cut = {k for k, v in jspecs.items()
           if any("pipe" in tuple(sp) for sp in jax.tree_util.tree_leaves(
               v, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))}
    assert set(tspecs["pipe"]) == cut == {"layers"}
    for name, sp in jspecs["layers"].items():
        assert tuple(sp)[0] == "pipe"
    assert tspecs["layers"] == param_partition_specs(
        from_jax_numpy(_np_params(model), MODEL_CONFIGS[model]))["layers"]
    assert kv_pipe_spec() == list(jax_kv_spec(pp=True)).index("pipe")
    assert kv_cache_spec() == list(jax_kv_spec(pp=True)).index("tensor")


def test_validate_tp_for_model():
    validate_tp_for_model(2, 8, 32)  # llama3:8b at tp 2
    with pytest.raises(ValueError, match="num_heads"):
        validate_tp_for_model(8, 4, 28)  # qwen2.5's 28 heads at tp 8
    with pytest.raises(ValueError, match="num_heads"):
        validate_tp_for_model(3, 2, 4)
    validate_tp_for_model(8, 4, 32)  # replicated groups
    with pytest.raises(ValueError, match="replicated groups"):
        validate_tp_for_model(6, 4, 24)
    validate_tp_for_model(4, 2, 4)


def test_runtime_refuses_tp_that_does_not_divide_heads():
    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.engine.engine import ModelRuntime

    mesh = RankMesh({"tensor": 3}, 0, ["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        ModelRuntime("test-tiny", MODEL_CONFIGS["test-tiny"],
                     EngineConfig(model="test-tiny", num_pages=8), mesh=mesh)
