"""The port's mixture-of-experts family against the JAX package's, on the
CPU in float32 (tests/test_moe.py without its expert-parallel cases).

- moe_mlp (ollamamq_tpu_torch/models/moe.py) against the JAX moe_mlp on
  the same numpy-seeded inputs, within rtol = atol = 1e-5: one group of
  10 tokens, 600 tokens in two groups of 300, a `valid` mask with
  padding rows, and capacity factor 0.5, where the capacity-slot tensor
  (which (token, k-slot) won which place in which expert's queue, and
  which were dropped) must be equal; the JAX one is read from the
  arguments of its own one-hot call;
- the per-token reference of tests/test_moe.py, overflow to the
  residual, invalid rows claiming no capacity, grouped routing;
- forward_ragged / forward_decode (plain attention) on test-tiny-moe
  against the JAX forwards (attn_impl "jnp") with padding rows and
  parked decode slots, at capacity factors 2.0 and 0.5 (tolerance of
  test_torch_model.py);
- TorchEngine and TPUEngine built from one Mixtral-layout checkpoint:
  identical greedy ids and /api/embed vectors within 1e-5;
- the port's runtime in lockstep with the JAX runtime (the lockstep helpers of
  test_torch_prefix_cache.py) with speculation, the prefix cache and
  preemption on, at capacity factors 2.0 and 0.5;
- chat_family against the JAX package's for every registered config and
  for unregistered encoder / MoE configs (the guard of
  ollamamq_tpu/server/templates.py:36).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.config import ModelConfig as JaxModelConfig
from ollamamq_tpu.engine.engine import TPUEngine
from ollamamq_tpu.models import llama as jllama
from ollamamq_tpu.models import moe as jmoe
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu.server.templates import chat_family as jax_chat_family
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig, ModelConfig
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.models import llama as tllama
from ollamamq_tpu_torch.models import moe
from ollamamq_tpu_torch.models.weights import from_jax_numpy, save_safetensors
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.templates import chat_family
from test_moe import _reference_moe
from test_torch_model import _np_params, _ragged_meta
from test_torch_prefix_cache import jax_runtime, lockstep, torch_runtime
from testutil import collect

NAME = "test-tiny-moe"
CFG = MODEL_CONFIGS[NAME]
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)  # test_torch_model.py's


def _configs(cf=None):
    """(port, JAX) configs of test-tiny-moe, at capacity factor `cf`."""
    t, j = CFG, JAX_CONFIGS[NAME]
    if cf is not None:
        t = dataclasses.replace(t, moe_capacity_factor=cf)
        j = dataclasses.replace(j, moe_capacity_factor=cf)
    return t, j


def _layer(seed=0):
    """Layer 0 of the JAX init (float32) as numpy, and as the port's
    layer dict."""
    pnp = _np_params(NAME, seed)
    lnp = {k: v[0] for k, v in pnp["layers"].items()}
    return lnp, from_jax_numpy(pnp, CFG)["layers"][0]


def _jax_moe(monkeypatch, cfg, lnp, h, valid=None):
    """The JAX moe_mlp, run eagerly, and the capacity-slot tensor it
    built: the indices of its second jax.nn.one_hot call (the first is
    over the routed experts)."""
    calls = []
    orig = jax.nn.one_hot

    def recording(x, n, **kw):
        calls.append(np.asarray(x))
        return orig(x, n, **kw)

    monkeypatch.setattr(jax.nn, "one_hot", recording)
    out = jmoe.moe_mlp(cfg, jax.tree_util.tree_map(jnp.asarray, lnp),
                       jnp.asarray(h),
                       None if valid is None else jnp.asarray(valid))
    monkeypatch.setattr(jax.nn, "one_hot", orig)
    assert len(calls) == 2
    return np.asarray(out), calls[1]


# (batch, tokens, capacity factor, valid rows: None or (pad_from, pad_to))
MOE_CASES = {
    "n10": (2, 5, None, None),
    "n600-groups-of-300": (1, 600, None, None),
    "valid-padding": (2, 12, None, (7, 12)),
    "capacity-0.5": (1, 48, 0.5, None),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_mlp_matches_jax(monkeypatch, case):
    B, T, cf, pad = MOE_CASES[case]
    tcfg, jcfg = _configs(cf)
    lnp, lp = _layer(seed=2)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(B, T, CFG.hidden_size)).astype(np.float32)
    valid = None
    if pad is not None:
        valid = np.ones((B, T), bool)
        valid[:, pad[0]:pad[1]] = False
        h[:, pad[0]:pad[1]] = 1.0  # identical garbage rows
    want, want_slot = _jax_moe(monkeypatch, jcfg, lnp, h, valid)
    got = moe.moe_mlp(tcfg, lp, torch.from_numpy(h),
                      None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    N = B * T
    G = moe.group_size(N)
    assert G == jmoe.group_size(N)
    _, idx, slot, C = moe.route(tcfg, lp, torch.from_numpy(h).reshape(N // G, G, -1),
                                None if valid is None else torch.from_numpy(valid))
    assert C == jmoe.expert_capacity(G, jcfg)
    np.testing.assert_array_equal(slot.numpy(), want_slot)
    if case == "n600-groups-of-300":
        assert G == 300
    if valid is not None:  # padding rows hold no place in any queue
        assert (slot.reshape(B, T, -1)[torch.from_numpy(~valid)] == C).all()
    if cf is not None:  # capacity pressure: some routed entries dropped
        routed = torch.nn.functional.one_hot(idx, CFG.num_experts) > 0
        assert (slot[routed] == C).any() and (slot[routed] < C).any()


def test_route_breaks_ties_by_lower_expert():
    """Equal router probabilities (a zero hidden) pick experts 0..K-1 in
    order, as jax.lax.top_k does."""
    _, lp = _layer()
    gates, idx, _, _ = moe.route(CFG, lp, torch.zeros(1, 3, CFG.hidden_size))
    assert idx.tolist() == [[[0, 1]] * 3]
    _, jidx = jax.lax.top_k(jnp.full((4,), 0.25), 2)
    assert jidx.tolist() == [0, 1]
    np.testing.assert_allclose(gates.numpy(), 0.5)


def test_moe_matches_per_token_reference():
    lnp, lp = _layer()
    h = np.random.default_rng(1).normal(size=(2, 5, CFG.hidden_size)).astype(np.float32)
    got = moe.moe_mlp(CFG, lp, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), _reference_moe(CFG, lnp, h),
                               rtol=2e-4, atol=2e-4)


def test_capacity_overflow_drops_to_residual():
    cfg = dataclasses.replace(CFG, moe_capacity_factor=1e-9)
    lnp, lp = _layer()
    h = torch.ones(1, 6, cfg.hidden_size)
    assert moe.expert_capacity(6, cfg) == 1
    out = moe.moe_mlp(cfg, lp, h).numpy()
    ref_one = _reference_moe(cfg, lnp, h[:, :1].numpy())
    np.testing.assert_allclose(out[0, 0], ref_one[0, 0], rtol=2e-4, atol=2e-4)
    # The identical later tokens lost their experts' places: no delta.
    np.testing.assert_array_equal(out[0, 1:], 0.0)
    assert np.isfinite(out).all()


def test_invalid_tokens_do_not_claim_capacity():
    cfg = dataclasses.replace(CFG, moe_capacity_factor=1.0)
    lnp, lp = _layer(seed=5)
    real = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 2, cfg.hidden_size)).astype(np.float32))
    h = torch.cat([torch.ones(1, 14, cfg.hidden_size), real], dim=1)
    valid = torch.cat([torch.zeros(1, 14, dtype=torch.bool),
                       torch.ones(1, 2, dtype=torch.bool)], dim=1)
    want = _reference_moe(cfg, lnp, real.numpy())
    out = moe.moe_mlp(cfg, lp, h, valid=valid)
    np.testing.assert_allclose(out[:, 14:].numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(out[:, :14].numpy(), 0.0)
    out_nomask = moe.moe_mlp(cfg, lp, h)
    assert not np.allclose(out_nomask[:, 14:].numpy(), want, rtol=2e-4, atol=2e-4)


def test_grouped_routing_matches_reference_across_groups(monkeypatch):
    lnp, lp = _layer(seed=7)
    h = np.random.default_rng(8).normal(size=(1, 16, CFG.hidden_size)).astype(np.float32)
    orig = moe.group_size
    monkeypatch.setattr(moe, "group_size", lambda n, cap=8: orig(n, cap=8))
    got = moe.moe_mlp(CFG, lp, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), _reference_moe(CFG, lnp, h),
                               rtol=2e-4, atol=2e-4)
    assert moe.group_size(16) == 8  # really 2 groups


def test_init_params_and_config():
    """MoE layers carry the router and expert stacks and no dense FFN;
    the registry entries and param_count equal the JAX package's."""
    for name in ("mixtral:8x7b", NAME):
        assert dataclasses.asdict(MODEL_CONFIGS[name]) == \
            dataclasses.asdict(JAX_CONFIGS[name])
        assert MODEL_CONFIGS[name].param_count() == JAX_CONFIGS[name].param_count()
    gen = torch.Generator().manual_seed(0)
    params = tllama.init_params(CFG, gen, dtype=torch.float32)
    d, f, E = CFG.hidden_size, CFG.intermediate_size, CFG.num_experts
    shapes = {k: tuple(v.shape) for k, v in params["layers"][1].items()}
    assert shapes["w_router"] == (d, E)
    assert shapes["we_gate"] == shapes["we_up"] == (E, d, f)
    assert shapes["we_down"] == (E, f, d)
    assert not {"w_gate", "w_up", "w_down"} & set(shapes)
    n = sum(t.numel() for lp in params["layers"] for t in lp.values())
    n += sum(t.numel() for k, t in params.items() if k != "layers")
    assert n == CFG.param_count()


# -- the forwards ------------------------------------------------------------
PS, MP, NPAGES = 8, 8, 24


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_forwards_match_jax(cf):
    """A ragged tick (two prompts, padding between them and at the
    tail), a ragged tick with a decode row beside a prefill span, then
    decode steps with two parked slots (garbage tokens on the trash
    page, active 0), one of them ahead of both live rows in the capacity
    queue: padding and parked rows must claim no capacity."""
    tcfg, jcfg = _configs(cf)
    pnp = _np_params(NAME)
    jparams = jax.tree_util.tree_map(jnp.asarray, pnp)
    tparams = from_jax_numpy(pnp, tcfg)
    rng = np.random.default_rng(1)
    shape = (CFG.num_layers, NPAGES * PS, CFG.num_kv_heads, CFG.head_dim)
    jk, jv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    B = 4
    pt = np.zeros((B, MP), np.int32)
    pt[1, :3] = [1, 2, 3]  # rows 1 and 2 live, 0 and 3 parked
    pt[2, :2] = [7, 5]
    prompts = [rng.integers(1, CFG.vocab_size, size=n).astype(np.int32)
               for n in (13, 11)]

    def slots_of(tok_seq, tok_pos):
        return np.array([pt[s][p // PS] * PS + p % PS if p >= 0 else 0
                         for s, p in zip(tok_seq, tok_pos)], np.int32)

    def ragged(tokens, spans, T, gap=0):
        """`gap` padding rows sit between the first span and the rest."""
        nonlocal jk, jv
        tok_seq, tok_pos, q_start, q_len, kv_len = _ragged_meta(spans, T, B)
        if gap:
            n0 = spans[0][2]
            for a in (tok_seq, tok_pos):
                a[n0 + gap:] = a[n0:T - gap].copy()
            tok_pos[n0:n0 + gap] = -1
            q_start[[s for s, *_ in spans[1:]]] += gap
        ws = slots_of(tok_seq, tok_pos)
        out_idx = np.clip(q_start + q_len - 1, 0, T - 1).astype(np.int32)
        args = (tokens, tok_seq, tok_pos, ws, out_idx)
        meta = (pt, q_start, q_len, kv_len)
        jl, jk, jv = jllama.forward_ragged(
            jparams, jcfg, *map(jnp.asarray, args), jk, jv,
            *map(jnp.asarray, meta), PS, attn_impl="jnp")
        tl, _, _ = tllama.forward_ragged(
            tparams, tcfg, *map(torch.from_numpy, args), tk, tv,
            *map(torch.from_numpy, meta), PS, attn_impl="plain")
        real = [s for s, *_ in spans]
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], **MODEL_TOL)

    def pools_match():
        for t, j in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(t.numpy()[:, PS:], np.asarray(j)[:, PS:],
                                       **MODEL_TOL)

    # 4 padding rows between the spans (ahead of the second span in the
    # capacity queue) and 4 at the tail.
    toks = np.zeros(32, np.int32)
    toks[:13], toks[17:28] = prompts[0], prompts[1]
    ragged(toks, [(1, 0, 13, 13), (2, 0, 11, 11)], 32, gap=4)
    pools_match()
    toks = np.zeros(16, np.int32)
    toks[0] = 42
    toks[1:5] = rng.integers(1, CFG.vocab_size, size=4)
    ragged(toks, [(1, 13, 1, 14), (2, 11, 4, 15)], 16)
    pools_match()
    active = np.array([0, 1, 1, 0], np.int32)
    for step in range(3):
        tokens = np.array([3, 7 + step, 9 + step, 3], np.int32)
        positions = np.array([0, 14 + step, 15 + step, 0], np.int32)
        jl, jk, jv = jllama.forward_decode(
            jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), jk, jv,
            jnp.asarray(pt), PS, attn_impl="jnp", active=jnp.asarray(active))
        tl, _, _ = tllama.forward_decode(
            tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
            tk, tv, torch.from_numpy(pt), PS, attn_impl="plain",
            active=torch.from_numpy(active))
        np.testing.assert_allclose(tl.numpy()[1:3], np.asarray(jl)[1:3], **MODEL_TOL)
        pools_match()


# -- the engines ---------------------------------------------------------------
ENGINE = dict(model=NAME, max_slots=4, num_pages=64, page_size=8,
              max_pages_per_seq=16, max_new_tokens=16, decode_steps_per_iter=2,
              max_batch_tokens=48, token_granule=8)
PROMPTS = ["route me", "mixture of experts " * 3, "x" * 40]
TEXTS = ["a", "retrieval indexes embed documents", "x" * 40]


@pytest.fixture(scope="module")
def engine_runs(tmp_path_factory):
    """One Mixtral-layout checkpoint (the port's writer, the JAX init of
    test-tiny-moe in float32) served by TPUEngine and by TorchEngine:
    greedy ids of PROMPTS and embeddings of TEXTS from each."""
    d = tmp_path_factory.mktemp("moe")
    pnp = jax.tree_util.tree_map(np.asarray, jllama.init_params(
        JAX_CONFIGS[NAME], jax.random.PRNGKey(4), dtype=jnp.float32))
    save_safetensors(from_jax_numpy(pnp, CFG), CFG, str(d))
    engines = [
        (TPUEngine(JaxEngineConfig(prefill_buckets=(16, 64), **ENGINE),
                   models={NAME: str(d)}, blocklist_path=None,
                   dtype=jnp.float32), JaxSampling),
        (TorchEngine(EngineConfig(**ENGINE), device="cpu", dtype=torch.float32,
                     models={NAME: str(d)}), SamplingParams)]
    runs = []
    for eng, sp in engines:
        tok = eng.runtimes[NAME].tokenizer
        tok.eos_id = -1  # full-length streams
        eng.start()
        try:
            gens = [eng.enqueue_request(f"u{i}", "", NAME,
                                        prompt_tokens=tok.encode(p),
                                        sampling=sp(max_tokens=12))
                    for i, p in enumerate(PROMPTS)]
            embeds = [eng.enqueue_request(f"rag-{i}", "", NAME,
                                          prompt_tokens=tok.encode(t),
                                          sampling=sp(), kind="embed")
                      for i, t in enumerate(TEXTS)]
            for req in gens + embeds:
                assert collect(req, timeout=120)[-1].kind == "done"
            runs.append(([list(r.generated_ids) for r in gens],
                         [np.asarray(r.embedding, np.float32) for r in embeds]))
        finally:
            eng.stop()
    return runs


def test_engine_greedy_ids_match_tpu_engine(engine_runs):
    (want, _), (got, _) = engine_runs
    assert got == want
    assert all(len(s) == 12 for s in got)


def test_engine_embeddings_match_tpu_engine(engine_runs):
    (_, want), (_, got) = engine_runs
    for g, w in zip(got, want):
        assert g.shape == w.shape == (CFG.hidden_size,)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_runtime_lockstep_with_jax(cf):
    """Speculation (k 4), the prefix cache and preemption on a 20-page
    pool: every tick of the two runtimes makes the same dispatch, page
    decisions and tokens. Four prompts share an 11-token prefix; two
    repeat a pattern, so drafts are proposed."""
    _, jcfg = _configs(cf)
    rng = np.random.default_rng(31)
    shared = rng.integers(3, 500, size=11).tolist()
    pat = rng.integers(3, 500, size=5).tolist()
    prompts = [shared + (pat * 6)[:20], shared + rng.integers(3, 500, size=9).tolist(),
               shared + (pat * 4)[:14], shared + rng.integers(3, 500, size=30).tolist()]
    kw = dict(num_pages=20, max_pages_per_seq=32, max_new_tokens=96,
              max_batch_tokens=64, token_granule=8, spec_k=4,
              spec_min_accept=0.0, retry_backoff_s=0.0, prefix_cache=True)
    jrt = jax_runtime(cfg=jcfg, spec=True, **kw)
    trt = torch_runtime(jrt, spec=True, **kw)
    assert trt.cfg.moe_capacity_factor == cf
    lockstep(jrt, trt, prompts, max_ticks=8000, max_tokens=32)
    assert trt.spec_proposed > 0 and trt.prefix_cache.hits > 0
    assert trt.preempt_count > 0, "pool never pressured: test is vacuous"
    assert trt.alloc.used_pages == 0
    trt.prefix_cache.check()


# -- templates -------------------------------------------------------------------
def test_chat_family_matches_jax():
    """Every registered config, and unregistered ones the architecture
    markers decide: a large-vocab encoder and a large-vocab MoE model are
    'plain', a large-vocab dense decoder 'llama3'."""
    assert set(MODEL_CONFIGS) <= set(JAX_CONFIGS)
    for name, cfg in MODEL_CONFIGS.items():
        assert chat_family(cfg) == jax_chat_family(JAX_CONFIGS[name]), name
    base = dict(name="custom", vocab_size=200_000, hidden_size=64,
                intermediate_size=96, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=16)
    for extra, want in (({}, "llama3"), ({"is_encoder": True}, "plain"),
                        ({"num_experts": 4}, "plain")):
        assert chat_family(ModelConfig(**base, **extra)) == want
        assert jax_chat_family(JaxModelConfig(**base, **extra)) == want
    assert chat_family(MODEL_CONFIGS["mixtral:8x7b"]) == "mistral"
    assert chat_family(None) == jax_chat_family(None) == "plain"
