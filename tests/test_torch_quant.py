"""The port's int8 formats against the JAX package's, on the CPU.

Same float32 inputs, made with numpy, go through the JAX quantizers and
the port's: int8 payloads must be EQUAL and scales within rtol 1e-6
(both compute amax / 127 and round half to even in float32). Then the
round-trip bounds of tests/test_quantization.py on the port, the int8
pool format and its per-layer indexing, the weight bridge with
QuantTensor leaves, the byte math, the fail-fast config checks and the
quantization guardrail on the JAX tests' real-shaped config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.config import ModelConfig as JaxModelConfig
from ollamamq_tpu.config import validate_quant_config as jax_validate
from ollamamq_tpu.engine import kv_cache as jkvc
from ollamamq_tpu.models import llama as jllama
from ollamamq_tpu.models import weights as jweights
from ollamamq_tpu.ops import quant as jq
from ollamamq_tpu_torch import cli
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig, ModelConfig
from ollamamq_tpu_torch.config import validate_quant_config
from ollamamq_tpu_torch.engine import kv_cache as kvc
from ollamamq_tpu_torch.engine.engine import ModelRuntime
from ollamamq_tpu_torch.models import weights
from ollamamq_tpu_torch.ops import quant as tq

SCALE_TOL = dict(rtol=1e-6, atol=0)

# tests/test_quantization.py's GUARD_SHAPE: llama-family GQA geometry
# (head_dim 64, grouped KV heads, SwiGLU, tied embeddings) at CI size.
GUARD = dict(name="guard-shape", vocab_size=4096, hidden_size=256,
             intermediate_size=512, num_layers=4, num_heads=4, num_kv_heads=2,
             head_dim=64, rope_theta=500_000.0, max_seq_len=512,
             tie_embeddings=True)


def _same_quant(t, j):
    """A port (q, s) pair against JAX's: payload equal, scales close."""
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), **SCALE_TOL)


@pytest.mark.parametrize("shape,axis", [((3, 32, 48), -1), ((32, 48), -1),
                                        ((64, 16), 0)],
                         ids=["layer-stack", "one-layer", "rows"])
def test_quantize_tensor_matches_jax_and_bounds(shape, axis):
    rng = np.random.default_rng(0)
    w = (rng.normal(size=shape) * 2.5).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero slice hits the scale floor
    t = tq.quantize_tensor(torch.from_numpy(w), axis=axis)
    j = jq.quantize_tensor(jnp.asarray(w), axis=axis)
    assert t.q.dtype == torch.int8 and t.s.dtype == torch.float32
    assert t.s.shape == j.s.shape
    _same_quant(t, j)
    back = tq.dequantize_tensor(t, axis=axis).numpy()
    np.testing.assert_allclose(back, np.asarray(jq.dequantize_tensor(j, axis=axis)),
                               rtol=1e-6, atol=0)
    # Round-trip error within half a quantization step per element.
    s = t.s.numpy()
    step = s[..., None, :] if axis == -1 else s.reshape((-1,) + (1,) * (w.ndim - 1))
    assert (np.abs(back - w) <= step * 0.5 + 1e-6).all()


def test_kv_quantize_matches_jax():
    rng = np.random.default_rng(2)
    vals = (rng.normal(size=(24, 2, 16)) * 3).astype(np.float32)
    vals[3, 1] = 0.0
    _same_quant(tq.kv_quantize(torch.from_numpy(vals)), jq.kv_quantize(jnp.asarray(vals)))


def test_kv_write_gather_match_jax_and_bounds():
    """kv_write on a QuantKV scatters payload AND scales in place; the
    pool, the gathered rows and the untouched slots (scale 1, payload 0)
    all equal JAX's functional update."""
    rng = np.random.default_rng(3)
    S, Hk, hd = 64, 2, 16
    vals = (rng.normal(size=(24, Hk, hd)) * 3).astype(np.float32)
    slots = rng.choice(S, size=24, replace=False).astype(np.int32)
    pool = tq.QuantKV(torch.zeros((S, Hk, hd), dtype=torch.int8),
                      torch.ones((S, Hk), dtype=torch.float32))
    same = tq.kv_write(pool, torch.from_numpy(slots), torch.from_numpy(vals))
    assert same is pool
    jpool = jq.kv_write(jq.QuantKV(jnp.zeros((S, Hk, hd), jnp.int8),
                                   jnp.ones((S, Hk), jnp.float32)),
                        jnp.asarray(slots), jnp.asarray(vals))
    _same_quant((pool.q, pool.s), jpool)
    got = tq.kv_gather(pool, torch.from_numpy(slots)).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.kv_gather(jpool, jnp.asarray(slots))),
                               rtol=1e-6, atol=0)
    scales = pool.s.numpy()[slots]
    assert (np.abs(got - vals) <= scales[..., None] * 0.5 + 1e-6).all()


def test_quant_kv_indexes_layers_not_fields():
    """pool[layer] is that layer's QuantKV (views of payload and scales),
    never the payload field a NamedTuple would return; writes through a
    layer view land in the pool."""
    cfg = MODEL_CONFIGS["test-tiny"]
    ecfg = EngineConfig(num_pages=4, page_size=8)
    kc, vc = kvc.alloc_kv_pool(cfg, ecfg, kv_dtype="int8")
    assert kc is not vc
    L, S, Hk, hd = cfg.num_layers, 32, cfg.num_kv_heads, cfg.head_dim
    assert kc.q.shape == (L, S, Hk, hd) and kc.q.dtype == torch.int8
    assert kc.s.shape == (L, S, Hk) and bool((kc.s == 1).all())
    assert bool((kc.q == 0).all())
    rng = np.random.default_rng(4)
    for layer in range(L):
        rows = torch.from_numpy((rng.normal(size=(5, Hk, hd)) * (layer + 1)).astype(np.float32))
        tq.kv_write(kc[layer], torch.arange(8, 13), rows)
    l0, l1 = kc[0], kc[1]
    assert isinstance(l1, tq.QuantKV) and l1.shape == (S, Hk, hd)
    assert torch.equal(l1.q, kc.q[1]) and torch.equal(l1.s, kc.s[1])
    assert not torch.equal(l1.q, l0.q) and not torch.equal(l1.s, l0.s)
    assert bool((kc.s[:, :8] == 1).all())  # slots nobody wrote
    with pytest.raises(ValueError):
        tq.QuantKV(torch.zeros((4, 2, 8), dtype=torch.int8), torch.ones((4, 3)))


def test_pool_bytes_match_jax():
    for name, kv_dtype in (("test-tiny", "int8"), ("test-tiny", "bfloat16"),
                           ("llama3.2:1b", "int8"), ("llama3.2:1b", "bfloat16")):
        t_cfg, j_cfg = MODEL_CONFIGS[name], JAX_CONFIGS[name]
        assert kvc.kv_pool_bytes(t_cfg, EngineConfig(num_pages=12, page_size=8),
                                 kv_dtype=kv_dtype) == jkvc.kv_pool_bytes(
            j_cfg, JaxEngineConfig(num_pages=12, page_size=8), kv_dtype=kv_dtype)
        assert kvc.kv_page_bytes(t_cfg, 32, kv_dtype=kv_dtype) == \
            jkvc.kv_page_bytes(j_cfg, 32, kv_dtype=kv_dtype)
    # The allocated pools cost what the planning math says.
    cfg, ecfg = MODEL_CONFIGS["test-tiny"], EngineConfig(num_pages=12, page_size=8)
    kc, vc = kvc.alloc_kv_pool(cfg, ecfg, kv_dtype="int8")
    assert tq.nbytes(kc) + tq.nbytes(vc) == kvc.kv_pool_bytes(cfg, ecfg, kv_dtype="int8")


def _np_params(name, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jllama.init_params(JAX_CONFIGS[name], jax.random.PRNGKey(seed),
                                       dtype=jnp.float32))


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-qwen"])
def test_quantize_params_and_bridge_match_jax(name):
    """The port's quantize_params_int8 on bridged weights equals JAX's on
    the same weights; JAX's int8 tree crosses the bridge into per-layer
    QuantTensors and comes back (q, s) for (q, s)."""
    cfg = MODEL_CONFIGS[name]
    pnp = _np_params(name)
    jq_np = jax.tree_util.tree_map(
        np.asarray, jweights.quantize_params_int8(
            jax.tree_util.tree_map(jnp.asarray, pnp), JAX_CONFIGS[name]))
    mine = weights.quantize_params_int8(weights.from_jax_numpy(pnp, cfg))
    bridged = weights.from_jax_numpy(jq_np, cfg, dtype=torch.bfloat16)
    for lp_m, lp_b, i in zip(mine["layers"], bridged["layers"], range(cfg.num_layers)):
        for key in weights.QUANT_LAYER_KEYS:
            assert isinstance(lp_b[key], tq.QuantTensor)
            assert lp_b[key].s.shape == (lp_b[key].q.shape[-1],)
            _same_quant(lp_m[key], (jq_np["layers"][key].q[i], jq_np["layers"][key].s[i]))
            np.testing.assert_array_equal(lp_b[key].q.numpy(), lp_m[key].q.numpy())
        # dtype applies to the float leaves only.
        assert lp_b["attn_norm"].dtype == torch.bfloat16
        assert lp_b["wq"].q.dtype == torch.int8 and lp_b["wq"].s.dtype == torch.float32
    _same_quant(mine["embed"], jq_np["embed"])
    back = weights.to_jax_numpy(weights.from_jax_numpy(jq_np, cfg))
    flat_a = jax.tree_util.tree_leaves_with_path(jq_np)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)
        assert flat_b[path].dtype == a.dtype


def test_validate_quant_config_matches_jax():
    cases = [("bfloat16", "bfloat16"), ("int8", "int8"), ("int8", "bfloat16"),
             ("bfloat16", "int8"), ("fp8", "bfloat16"), ("bfloat16", "fp8"),
             ("fp8", "fp8")]
    for w, kv in cases:
        assert validate_quant_config(w, kv) == jax_validate(w, kv), (w, kv)
    assert validate_quant_config("int8", "int8") is None
    assert "fp8" in validate_quant_config("fp8", "bfloat16")


def test_cli_and_runtime_fail_fast(monkeypatch):
    from ollamamq_tpu_torch.engine import engine as eng

    def no_engine(*a, **k):
        raise AssertionError("an engine was built for an invalid flag")

    monkeypatch.setattr(eng, "TorchEngine", no_engine)
    for flags in (["--weights-dtype", "fp8"], ["--kv-dtype", "int4"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--device", "cpu", "--model", "test-tiny", *flags])
        assert exc.value.code == 2
    args = cli.build_parser().parse_args(["--weights-dtype", "int8", "--kv-dtype", "int8"])
    ecfg = cli.engine_config(args)
    assert (ecfg.weights_dtype, ecfg.kv_dtype) == ("int8", "int8")
    for bad in (dict(kv_dtype="fp8"), dict(weights_dtype="int4")):
        with pytest.raises(ValueError):
            ModelRuntime("test-tiny", MODEL_CONFIGS["test-tiny"],
                         EngineConfig(num_pages=8, page_size=8, **bad), device="cpu")


def test_quant_guardrail_real_shaped():
    """The tier-1 quality gate of tests/test_quantization.py, with its
    bounds, on the port, with the bf16 weights JAX's init gives for the
    JAX test's seed: the int8 tree tracks the bf16 tree's greedy choices
    and its worst logit error stays small against the logit spread."""
    cfg = ModelConfig(**GUARD)
    jcfg = JaxModelConfig(**GUARD)
    pnp = jax.tree_util.tree_map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32))
    base = weights.from_jax_numpy(pnp, cfg, dtype=torch.bfloat16)
    out = weights.quant_guardrail(cfg, base_params=base, seed=3,
                                  prompt_len=16, steps=16)
    assert out["steps"] == 16
    assert out["token_match_rate"] >= 0.85, out
    assert out["rel_logit_err"] <= 0.5, out
