"""The PyTorch port's model forwards against the JAX package's, on the
test-tiny dense configs, with the same weights bridged through
from_jax_numpy.

Float32 on the CPU; tolerance atol = rtol = 1e-4 (the two frameworks sum
matmuls in different orders). The pools are compared everywhere except
the trash page, where padding tokens' writes collide in an unspecified
order in both frameworks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.models import llama as jllama
from ollamamq_tpu_torch.config import MODEL_CONFIGS
from ollamamq_tpu_torch.models import llama as tllama
from ollamamq_tpu_torch.models.weights import from_jax_numpy, to_jax_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
PS, MP, NPAGES = 8, 8, 24
DENSE_TINY = ["test-tiny", "test-tiny-gqa", "test-tiny-qwen", "test-tiny-qwen3"]


def _np_params(name, seed=0):
    """JAX init_params as numpy, with biases and q/k-norm weights
    randomised so those branches carry real numbers."""
    cfg = JAX_CONFIGS[name]
    params = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(cfg, jax.random.PRNGKey(seed),
                                       dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    for key in ("bq", "bk", "bv", "q_norm", "k_norm"):
        if key in params["layers"]:
            a = params["layers"][key]
            params["layers"][key] = (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
    return params


def _ragged_meta(spans, T, B):
    """spans: [(seq, start_pos, n_tokens, kv_len)] in stream order, with
    page table rows pt. Returns per-token and per-seq metadata."""
    tok_seq = np.full(T, B - 1, np.int32)
    tok_pos = np.full(T, -1, np.int32)
    q_start = np.full(B, T, np.int32)
    q_len = np.zeros(B, np.int32)
    kv_len = np.zeros(B, np.int32)
    off = 0
    for s, start, n, kv in spans:
        tok_seq[off:off + n] = s
        tok_pos[off:off + n] = np.arange(start, start + n)
        q_start[s], q_len[s], kv_len[s] = off, n, kv
        off += n
    return tok_seq, tok_pos, q_start, q_len, kv_len


@pytest.mark.parametrize("name", DENSE_TINY)
def test_forwards_match_jax(name):
    cfg = MODEL_CONFIGS[name]
    pnp = _np_params(name)
    jparams = jax.tree_util.tree_map(jnp.asarray, pnp)
    tparams = from_jax_numpy(pnp, cfg)
    rng = np.random.default_rng(1)
    shape = (cfg.num_layers, NPAGES * PS, cfg.num_kv_heads, cfg.head_dim)
    jk, jv = jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    B = 3
    pt = np.zeros((B, MP), np.int32)
    pt[0, :3] = [1, 2, 3]   # sequence 0: 18-token prompt
    pt[1, :2] = [7, 5]      # sequence 1: 11-token prompt, pages out of order
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (18, 11)]

    def slots_of(tok_seq, tok_pos):
        return np.array([pt[s][p // PS] * PS + p % PS if p >= 0 else 0
                         for s, p in zip(tok_seq, tok_pos)], np.int32)

    def ragged(tokens, spans, T):
        nonlocal jk, jv
        tok_seq, tok_pos, q_start, q_len, kv_len = _ragged_meta(spans, T, B)
        ws = slots_of(tok_seq, tok_pos)
        out_idx = np.clip(q_start + q_len - 1, 0, T - 1).astype(np.int32)
        args = (tokens, tok_seq, tok_pos, ws, out_idx)
        meta = (pt, q_start, q_len, kv_len)
        jl, jk, jv = jllama.forward_ragged(
            jparams, JAX_CONFIGS[name], *map(jnp.asarray, args), jk, jv,
            *map(jnp.asarray, meta), PS, attn_impl="jnp")
        tl, _, _ = tllama.forward_ragged(
            tparams, cfg, *map(torch.from_numpy, args), tk, tv,
            *map(torch.from_numpy, meta), PS)
        real = [s for s, *_ in spans]
        np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], **TOL)

    def pools_match():
        for t, j in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(t.numpy()[:, PS:], np.asarray(j)[:, PS:], **TOL)

    # Tick 1: all of prompt 0 and the head of prompt 1, stream padded to 24.
    toks = np.zeros(24, np.int32)
    toks[:18], toks[18:22] = prompts[0], prompts[1][:4]
    ragged(toks, [(0, 0, 18, 18), (1, 0, 4, 4)], 24)
    pools_match()
    # Tick 2: a decode row for sequence 0 beside the rest of prompt 1.
    toks = np.zeros(16, np.int32)
    toks[0], toks[1:8] = 42, prompts[1][4:]
    ragged(toks, [(0, 18, 1, 19), (1, 4, 7, 11)], 16)
    pools_match()
    # Two decode steps for both sequences (row 2 idle on the trash page).
    for step in range(2):
        tokens = np.array([7 + step, 9 + step, 0], np.int32)
        positions = np.array([19 + step, 11 + step, 0], np.int32)
        jl, jk, jv = jllama.forward_decode(
            jparams, JAX_CONFIGS[name], jnp.asarray(tokens),
            jnp.asarray(positions), jk, jv, jnp.asarray(pt), PS,
            attn_impl="jnp")
        tl, _, _ = tllama.forward_decode(
            tparams, cfg, torch.from_numpy(tokens), torch.from_numpy(positions),
            tk, tv, torch.from_numpy(pt), PS)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **TOL)
        pools_match()


@pytest.mark.parametrize("name", DENSE_TINY)
def test_bridge_round_trip(name):
    """from_jax_numpy then to_jax_numpy gives back the JAX arrays
    exactly, and the layer dicts carry every stacked key."""
    cfg = MODEL_CONFIGS[name]
    pnp = _np_params(name)
    back = to_jax_numpy(from_jax_numpy(pnp, cfg))
    flat_a = jax.tree_util.tree_leaves_with_path(pnp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)
    assert (("lm_head" in pnp) == (not cfg.tie_embeddings))


def test_bridge_casts_to_bf16_and_rejects_wrong_depth():
    cfg = MODEL_CONFIGS["test-tiny"]
    pnp = _np_params("test-tiny")
    p16 = from_jax_numpy(pnp, cfg, dtype=torch.bfloat16)
    assert p16["layers"][0]["wq"].dtype == torch.bfloat16
    assert p16["layers"][1]["wq"].shape == (cfg.hidden_size, cfg.q_dim)
    with pytest.raises(ValueError):
        from_jax_numpy(pnp, dataclasses.replace(cfg, num_layers=3))
