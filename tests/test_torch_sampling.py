"""The port's sampling arithmetic against the JAX package's
(ollamamq_tpu/ops/sampling.py): penalties, top-k / top-p masks,
sampling_flags and greedy picks are EXACTLY equal on the same float32
inputs. Random draws are not compared: the port draws from
torch.Generators, JAX from threefry keys, and the bits differ by design.
Within the port, a seeded row is a pure function of (seed, position).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.ops import sampling as jsamp
from ollamamq_tpu_torch.ops import sampling as tsamp

B, V, W = 6, 512, 16


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    recent = rng.integers(-1, V, size=(B, W)).astype(np.int32)
    recent[0] = -1  # an empty ring
    recent[1, :4] = 7  # repeated ids
    rep = np.array([1.0, 1.1, 1.3, 0.9, 1.0, 1.2], np.float32)
    pres = np.array([0.0, 0.5, 0.0, 0.2, 1.0, 0.0], np.float32)
    freq = np.array([0.0, 0.1, 0.3, 0.0, 0.0, 0.7], np.float32)
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.5, 0.9], np.float32)
    top_k = np.array([0, 1, 40, 0, 300, 5], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5, 0.95, 0.3], np.float32)
    return logits, recent, rep, pres, freq, temp, top_k, top_p


def test_penalties_exact():
    logits, recent, rep, pres, freq, *_ = _inputs()
    want = np.asarray(jsamp.apply_penalties(*map(jnp.asarray, (logits, recent, rep, pres, freq))))
    got = tsamp.apply_penalties(*map(torch.from_numpy, (logits, recent, rep, pres, freq))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tsamp.recent_token_counts(torch.from_numpy(recent), V).numpy(),
        np.asarray(jsamp.recent_token_counts(jnp.asarray(recent), V)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_and_greedy_exact(seed):
    logits, _r, _p, _pr, _f, temp, top_k, top_p = _inputs(seed)
    jm, jg = jsamp._masked_scaled_logits(*map(jnp.asarray, (logits, temp, top_k, top_p)))
    tm, tg = tsamp._masked_scaled_logits(*map(torch.from_numpy, (logits, temp, top_k, top_p)))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    # Unmasked path (need_mask False): scaled logits only.
    jm0, _ = jsamp._masked_scaled_logits(*map(jnp.asarray, (logits, temp, top_k, top_p)), need_mask=False)
    tm0, _ = tsamp._masked_scaled_logits(*map(torch.from_numpy, (logits, temp, top_k, top_p)), need_mask=False)
    np.testing.assert_array_equal(tm0.numpy(), np.asarray(jm0))


def test_greedy_rows_take_argmax():
    logits, *_ = _inputs()
    zeros = np.zeros(B, np.float32)
    got = tsamp.sample_tokens_rowwise(
        torch.from_numpy(logits), None, torch.from_numpy(zeros),
        torch.zeros(B, dtype=torch.int32), torch.ones(B), need_mask=False,
        need_sample=False).numpy()
    keys = jsamp.per_row_keys(jnp.asarray([0, 1], jnp.uint32),
                              jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32))
    want = np.asarray(jsamp.sample_tokens_rowwise(
        jnp.asarray(logits), keys, jnp.asarray(zeros), jnp.zeros(B, jnp.int32),
        jnp.ones(B), need_mask=False, need_sample=False))
    np.testing.assert_array_equal(got, want)


def test_sampling_flags_exact():
    _l, _r, rep, pres, freq, temp, top_k, top_p = _inputs()
    cases = [
        (temp, top_k, top_p, rep, pres, freq),
        (np.zeros(B), np.zeros(B, np.int32), np.ones(B), np.ones(B), np.zeros(B), np.zeros(B)),
        (np.zeros(B), np.array([0, 0, 3, 0, 0, 0]), np.ones(B), np.ones(B), np.zeros(B), np.zeros(B)),
        (np.zeros(B), np.zeros(B, np.int32), np.ones(B), np.ones(B), np.full(B, 0.1), np.zeros(B)),
    ]
    for c in cases:
        assert tsamp.sampling_flags(*c) == jsamp.sampling_flags(*c)


def test_sampling_params_parse_like_jax():
    for opts in ({}, {"temperature": 0, "seed": 0, "num_predict": 5},
                 {"temperature": 0.3, "top_k": 9, "stop": ["x"], "seed": 2**40}):
        j = jsamp.SamplingParams.from_ollama_options(opts, 64)
        t = tsamp.SamplingParams.from_ollama_options(opts, 64)
        assert vars(t) == vars(j)
    body = {"temperature": 0.5, "max_tokens": 7, "stop": "END", "seed": None}
    assert vars(tsamp.SamplingParams.from_openai(body, 9)) == vars(
        jsamp.SamplingParams.from_openai(body, 9))


def test_seeded_rows_reproducible_and_isolated():
    """A seeded row's draw depends only on (seed, position): the same
    row alone, or beside other seeded and unseeded rows drawing from a
    differently advanced engine generator, gives the same token."""
    logits, _r, _p, _pr, _f, temp, top_k, top_p = _inputs()
    temp = np.full(B, 1.0, np.float32)

    def draw(seeds, positions, engine_seed):
        gen = torch.Generator().manual_seed(engine_seed)
        u = tsamp.row_uniforms(gen, np.asarray(seeds), np.asarray(positions), V, "cpu")
        return tsamp.sample_tokens_rowwise(
            torch.from_numpy(logits), u, torch.from_numpy(temp),
            torch.from_numpy(top_k), torch.from_numpy(top_p)).numpy()

    a = draw([5, 0, 0, 0, 0, 0], [10, 3, 3, 3, 3, 3], engine_seed=0)
    b = draw([5, 9, 0, 0, 0, 7], [10, 4, 8, 1, 2, 6], engine_seed=123)
    assert a[0] == b[0]
    # The stream moves with the position and the seed.
    rows = [draw([5] * B, [p] * B, 0)[0] for p in range(10, 30)]
    assert len(set(rows)) > 1
    assert draw([6] * B, [10] * B, 0)[0] == draw([6] * B, [10] * B, 1)[0]
