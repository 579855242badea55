"""Embeddings in the port against the JAX package on the CPU: the plain
bidirectional attention, forward_embed / forward_encoder on every dense
test architecture (float32, the tolerances of tests/test_model.py), and
the engine's embed paths (TorchEngine against TPUEngine, a generative
and an encoder model, mixed with generation), plus the reference's
engine behaviours: an embed is admitted while decode is saturated, and
an input that is too long errors only its own request."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.engine.engine import TPUEngine
from ollamamq_tpu.models import llama as jllama
from ollamamq_tpu.ops import attention as jattn
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.engine.request import FinishReason
from ollamamq_tpu_torch.models import llama
from ollamamq_tpu_torch.models.weights import from_jax_numpy, save_safetensors
from ollamamq_tpu_torch.ops import attention
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from testutil import collect

ARCHS = ["test-tiny", "test-tiny-gqa", "test-tiny-qwen3", "test-tiny-embed"]


def _params(name, seed=0):
    """The JAX init in float32 and its bridge into the port."""
    jp = jllama.init_params(JAX_CONFIGS[name], jax.random.PRNGKey(seed),
                            dtype=jnp.float32)
    pnp = jax.tree_util.tree_map(np.asarray, jp)
    return jp, from_jax_numpy(pnp, MODEL_CONFIGS[name])


@pytest.mark.parametrize("hk", [4, 2, 1])
def test_bidirectional_attention_matches_jax(hk):
    rng = np.random.default_rng(hk)
    q = rng.normal(size=(3, 9, 4, 16)).astype(np.float32)
    k = rng.normal(size=(3, 9, hk, 16)).astype(np.float32)
    v = rng.normal(size=(3, 9, hk, 16)).astype(np.float32)
    lens = np.array([9, 4, 0], np.int32)  # full, padded and empty rows
    want = np.asarray(jattn.bidirectional_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    got = attention.bidirectional_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fn", ["forward_embed", "forward_encoder"])
@pytest.mark.parametrize("name", ARCHS)
def test_embedding_forwards_match_jax(name, fn):
    """Both pooled forwards on every architecture, with a padded row and
    a zero-length padding row (pools to zeros, no NaN)."""
    jp, tp = _params(name)
    rng = np.random.default_rng(1)
    toks = rng.integers(3, 512, size=(3, 11)).astype(np.int32)
    lens = np.array([5, 11, 0], np.int32)
    want = np.asarray(getattr(jllama, fn)(jp, JAX_CONFIGS[name],
                                          jnp.asarray(toks), jnp.asarray(lens)))
    got = getattr(llama, fn)(tp, MODEL_CONFIGS[name], torch.from_numpy(toks),
                             torch.from_numpy(lens)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, MODEL_CONFIGS[name].hidden_size)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got[:2], axis=-1), 1.0, rtol=1e-5)
    assert np.isfinite(got).all() and not got[2].any()


@pytest.mark.parametrize("fn", ["forward_embed", "forward_encoder"])
def test_embedding_padding_invariance(fn):
    """Same tokens, different pad width: the same embedding."""
    name = "test-tiny-embed" if fn == "forward_encoder" else "test-tiny"
    _, tp = _params(name)
    cfg = MODEL_CONFIGS[name]
    wide = getattr(llama, fn)(tp, cfg, torch.tensor([[1, 2, 3, 0, 0], [4, 5, 6, 7, 8]],
                                                    dtype=torch.int32),
                              torch.tensor([3, 5]))
    tight = getattr(llama, fn)(tp, cfg, torch.tensor([[1, 2, 3]], dtype=torch.int32),
                               torch.tensor([3]))
    np.testing.assert_allclose(wide[0].numpy(), tight[0].numpy(), rtol=1e-4, atol=1e-5)


def test_encoder_tree_bridges_both_ways():
    """An encoder's JAX tree (no lm_head) crosses the weight bridge and
    comes back equal."""
    from ollamamq_tpu_torch.models.weights import to_jax_numpy

    jp, tp = _params("test-tiny-embed")
    back = to_jax_numpy(tp)
    pnp = jax.tree_util.tree_map(np.asarray, jp)
    assert "lm_head" not in tp and set(back) == set(pnp)
    for k in ("embed", "final_norm"):
        np.testing.assert_array_equal(back[k], pnp[k])
    for k, stack in pnp["layers"].items():
        np.testing.assert_array_equal(back["layers"][k], stack)


def test_encoder_params_have_no_lm_head():
    gen = torch.Generator().manual_seed(0)
    params = llama.init_params(MODEL_CONFIGS["test-tiny-embed"], gen,
                               dtype=torch.float32)
    assert "lm_head" not in params
    assert "lm_head" in llama.init_params(MODEL_CONFIGS["test-tiny"], gen,
                                          dtype=torch.float32)


ENGINE = dict(model="test-tiny", max_slots=4, num_pages=64, page_size=8,
              max_pages_per_seq=16, max_new_tokens=8, decode_steps_per_iter=2,
              max_batch_tokens=48, token_granule=8)
TEXTS = ["a", "retrieval indexes embed documents", "x" * 40,
         "while other users' streams decode " * 3]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """HF checkpoints of the JAX init of test-tiny and test-tiny-embed
    (float32): both engines load the same weights."""
    dirs = {}
    for name in ("test-tiny", "test-tiny-embed"):
        d = tmp_path_factory.mktemp(name)
        save_safetensors(_params(name, seed=3)[1], MODEL_CONFIGS[name], str(d))
        dirs[name] = str(d)
    return dirs


def _embed_all(eng, sp, make_tokens):
    """Enqueue a generation on test-tiny, then every text on both models
    as embeds; returns {(model, text): vector} and the generation's ids."""
    gen = eng.enqueue_request("chat", "", "test-tiny",
                              prompt_tokens=make_tokens("test-tiny", "a chat turn"),
                              sampling=sp(max_tokens=8))
    reqs = {(m, t): eng.enqueue_request(f"rag-{i}", "", m,
                                        prompt_tokens=make_tokens(m, t),
                                        sampling=sp(), kind="embed")
            for m in ("test-tiny", "test-tiny-embed") for i, t in enumerate(TEXTS)}
    out = {}
    for key, req in reqs.items():
        items = collect(req, timeout=120)
        assert items[-1].kind == "done", items[-1]
        out[key] = np.asarray(req.embedding, np.float32)
    assert collect(gen, timeout=120)[-1].kind == "done"
    return out, list(gen.generated_ids)


def test_engine_embeddings_match_tpu_engine(checkpoints):
    """The same checkpoints through TPUEngine and TorchEngine, both on the
    CPU in float32: every embedding agrees within 1e-5."""
    jeng = TPUEngine(JaxEngineConfig(prefill_buckets=(16, 64), **ENGINE),
                     models=checkpoints, blocklist_path=None, dtype=jnp.float32)
    teng = TorchEngine(EngineConfig(**ENGINE), device="cpu", dtype=torch.float32,
                       models=checkpoints)
    results = []
    for eng, sp in ((jeng, JaxSampling), (teng, SamplingParams)):
        eng.start()
        try:
            results.append(_embed_all(
                eng, sp, lambda m, t: eng.runtimes[m].tokenizer.encode(t)))
        finally:
            eng.stop()
    (want, _), (got, _) = results
    assert want.keys() == got.keys()
    for key in want:
        assert got[key].shape == want[key].shape == (64,)
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=0)


def _saturated_engine(**over):
    eng = TorchEngine(EngineConfig(**{**ENGINE, "max_slots": 1,
                                      "decode_steps_per_iter": 1, **over}),
                      device="cpu", dtype=torch.float32)
    eng.start()
    return eng


def test_embed_admitted_while_decode_saturated():
    """The only decode slot is busy: an embed is still served before the
    generation ends (its own capacity pool)."""
    eng = _saturated_engine()
    try:
        rt = eng.runtimes["test-tiny"]
        tok = rt.tokenizer
        gen = eng.enqueue_request("genuser", "", "test-tiny",
                                  prompt_tokens=tok.encode("long"),
                                  sampling=SamplingParams(max_tokens=100))
        deadline = time.monotonic() + 60
        while rt.active_count() == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rt.active_count() == 1 and not rt.has_capacity("generate")
        assert rt.has_capacity("embed")
        emb = eng.enqueue_request("embuser", "", "test-tiny",
                                  prompt_tokens=tok.encode("embed me"),
                                  sampling=SamplingParams(), kind="embed")
        items = collect(emb, timeout=60)
        assert items[-1].kind == "done" and emb.embedding is not None
        assert len(emb.embedding) == 64 and not emb.generated_ids
        assert gen.stats.finished_at == 0.0, \
            "generation finished first: embed waited on a decode slot"
        gen.cancelled.set()
        assert collect(gen)[-1].finish_reason == FinishReason.CANCELLED
    finally:
        eng.stop()


def test_embed_input_too_long_errors_only_that_request():
    eng = TorchEngine(EngineConfig(**{**ENGINE, "model": "test-tiny-embed"}),
                      device="cpu", dtype=torch.float32)
    eng.start()
    try:
        max_len = eng.runtimes["test-tiny-embed"].cfg.max_seq_len  # 512
        big = eng.enqueue_request("big", "", "test-tiny-embed",
                                  prompt_tokens=list(range(3, 3 + max_len + 10)),
                                  kind="embed")
        small = eng.enqueue_request("ok", "", "test-tiny-embed",
                                    prompt_tokens=[3, 4, 5], kind="embed")
        i1, i2 = collect(big), collect(small)
        assert i1[-1].kind == "error" and "exceeds" in i1[-1].error
        assert i2[-1].kind == "done" and small.embedding
    finally:
        eng.stop()


def test_generate_on_encoder_errors_and_embed_needs_no_model_name():
    """A generate request named for an encoder errors (never parks); an
    embed request with no model lands on a runtime that serves embeds."""
    eng = TorchEngine(EngineConfig(**ENGINE), device="cpu", dtype=torch.float32,
                      models={"test-tiny-embed": None})
    eng.start()
    try:
        bad = eng.enqueue_request("u", "", "test-tiny-embed", prompt_tokens=[1, 5],
                                  sampling=SamplingParams(max_tokens=2))
        last = collect(bad)[-1]
        assert last.kind == "error" and "embedding-only" in last.error
        anon = eng.enqueue_request("u", "", "", prompt_tokens=[1, 5], kind="embed")
        assert collect(anon)[-1].kind == "done" and len(anon.embedding) == 64
        assert eng.resolve_runtime("", kind="generate") is None
    finally:
        eng.stop()


def test_embed_fault_is_retried_then_poisoned():
    """An injected embed-dispatch fault on a generative runtime retries the
    batch once; the runtime keeps serving (no rebuild)."""
    from ollamamq_tpu_torch.testing.faults import FaultPlan

    eng = _saturated_engine(retry_backoff_s=0.0, fault_plan=FaultPlan(
        [{"site": "embed", "kind": "exception", "at": [1]}]))
    try:
        rt = eng.runtimes["test-tiny"]
        req = eng.enqueue_request("u", "", "test-tiny", prompt_tokens=[1, 5, 6],
                                  kind="embed")
        assert collect(req)[-1].kind == "done" and req.retries == 1
        assert eng.runtimes["test-tiny"] is rt and rt.retry_count == 1
    finally:
        eng.stop()
