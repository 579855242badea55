"""The port's forwards with int8 weights and int8 KV pools against the
JAX package's, on the test-tiny dense configs, float32 activations, the
JAX int8 tree carried across the weight bridge.

Logits agree within atol = rtol = 1e-4 (matmul sums in other orders). The
pools are compared outside the trash page, where padding tokens' writes
collide in an unspecified order: dequantized values within one
quantization step of JAX's per element, and int8 payloads equal on at
least 99.9% of the elements. Exact equality may fail where the f32
quotient v / s of K/V that differ in the last bits lands on a rounding
half-point; the assertion message counts such elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.models import llama as jllama
from ollamamq_tpu.models import weights as jweights
from ollamamq_tpu.ops.quant import QuantKV as JaxQuantKV
from ollamamq_tpu_torch.config import MODEL_CONFIGS
from ollamamq_tpu_torch.models import llama as tllama
from ollamamq_tpu_torch.models.weights import from_jax_numpy
from ollamamq_tpu_torch.ops.quant import QuantKV, QuantTensor

from test_torch_model import DENSE_TINY, MP, NPAGES, PS, TOL, _np_params, _ragged_meta


def _int8_params(name):
    """JAX's int8 tree of the test_torch_model weights, as numpy."""
    jp = jweights.quantize_params_int8(
        jax.tree_util.tree_map(jnp.asarray, _np_params(name)), JAX_CONFIGS[name])
    return jp, jax.tree_util.tree_map(np.asarray, jp)


def _pools_match(t, j):
    """Port QuantKV pool vs JAX QuantKV pool, trash page excluded."""
    tq, ts = t.q.numpy()[:, PS:], t.s.numpy()[:, PS:]
    jqa, jsa = np.asarray(j.q)[:, PS:], np.asarray(j.s)[:, PS:]
    deq_t = tq.astype(np.float32) * ts[..., None]
    deq_j = jqa.astype(np.float32) * jsa[..., None]
    step = np.maximum(ts, jsa)[..., None] * (1 + 1e-5)
    assert (np.abs(deq_t - deq_j) <= step).all()
    differ = int((tq != jqa).sum())
    assert differ <= 1e-3 * tq.size, f"{differ} of {tq.size} payload elements differ"
    np.testing.assert_allclose(ts, jsa, **TOL)


@pytest.mark.parametrize("name", DENSE_TINY)
def test_int8_forwards_match_jax(name):
    cfg = MODEL_CONFIGS[name]
    jparams, pnp = _int8_params(name)
    tparams = from_jax_numpy(pnp, cfg)
    assert isinstance(tparams["layers"][0]["wq"], QuantTensor)
    assert isinstance(tparams["embed"], QuantTensor)
    rng = np.random.default_rng(1)
    shape = (cfg.num_layers, NPAGES * PS, cfg.num_kv_heads, cfg.head_dim)

    def jpool():
        return JaxQuantKV(jnp.zeros(shape, jnp.int8), jnp.ones(shape[:-1], jnp.float32))

    def tpool():
        return QuantKV(torch.zeros(shape, dtype=torch.int8),
                       torch.ones(shape[:-1], dtype=torch.float32))

    jk, jv = jpool(), jpool()
    tk, tv = tpool(), tpool()
    B = 3
    pt = np.zeros((B, MP), np.int32)
    pt[0, :3] = [1, 2, 3]
    pt[1, :2] = [7, 5]
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (18, 11)]

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
        _pools_match(tk, jk)
        _pools_match(tv, jv)

    toks = np.zeros(24, np.int32)
    toks[:18], toks[18:22] = prompts[0], prompts[1][:4]
    ragged(toks, [(0, 0, 18, 18), (1, 0, 4, 4)], 24)
    pools_match()
    toks = np.zeros(16, np.int32)
    toks[0], toks[1:8] = 42, prompts[1][4:]
    ragged(toks, [(0, 18, 1, 19), (1, 4, 7, 11)], 16)
    pools_match()
    for step in range(2):
        tokens = np.array([7 + step, 9 + step, 0], np.int32)
        positions = np.array([19 + step, 11 + step, 0], np.int32)
        jl, jk, jv = jllama.forward_decode(
            jparams, JAX_CONFIGS[name], jnp.asarray(tokens), jnp.asarray(positions),
            jk, jv, jnp.asarray(pt), PS, attn_impl="jnp")
        tl, _, _ = tllama.forward_decode(
            tparams, cfg, torch.from_numpy(tokens), torch.from_numpy(positions),
            tk, tv, torch.from_numpy(pt), PS)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], **TOL)
        pools_match()
    # Each layer wrote its own K/V: the layer-1 view differs from layer 0
    # (a pool indexed as a tuple would hand both layers the same tensor).
    for pool in (tk, tv):
        assert not torch.equal(pool[1].q, pool[0].q)
        assert not torch.equal(pool[1].s, pool[0].s)
        assert torch.equal(pool[1].q, pool.q[1])
