"""The int8 slice as a whole on the CPU: the port's ModelRuntime with
int8 weights and int8 KV pools against the JAX package's ModelRuntime
with the same settings, on test_torch_engine.py's settings, prompts and
ticks. The port takes the JAX runtime's int8 weights through the bridge.

Greedy streams must be IDENTICAL; both ragged and decode ticks run; every
page goes back to the pool; and the int8 runtime's KV and weight bytes
(payload plus scales, equal to JAX's count) shrink against the float32
runtime's as tests/test_quantization.py requires.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.core import MQCore as JaxMQCore
from ollamamq_tpu.engine.engine import ModelRuntime as JaxRuntime
from ollamamq_tpu.engine.request import Request as JaxRequest
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.core.mqcore import MQCore
from ollamamq_tpu_torch.engine.engine import ModelRuntime
from ollamamq_tpu_torch.engine.request import Request
from ollamamq_tpu_torch.models.weights import from_jax_numpy
from ollamamq_tpu_torch.ops.quant import QuantKV, QuantTensor
from ollamamq_tpu_torch.ops.sampling import SamplingParams

from test_torch_engine import MAX_TOKENS, PROMPT_LENS, SETTINGS, _drive

INT8 = dict(weights_dtype="int8", kv_dtype="int8")


@pytest.mark.parametrize("repeat_penalty", [1.0, 1.1], ids=["greedy", "repeat-penalty"])
def test_int8_streams_match_jax_runtime(repeat_penalty):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in PROMPT_LENS]
    jrt = JaxRuntime("test-tiny", JAX_CONFIGS["test-tiny"],
                     JaxEngineConfig(prefill_buckets=(16, 64), **SETTINGS, **INT8),
                     dtype=jnp.float32)
    jrt.tokenizer.eos_id = -1
    pnp = jax.tree_util.tree_map(np.asarray, jrt.params)
    trt = ModelRuntime("test-tiny", MODEL_CONFIGS["test-tiny"],
                       EngineConfig(**SETTINGS, **INT8), device="cpu",
                       dtype=torch.float32,
                       params=from_jax_numpy(pnp, MODEL_CONFIGS["test-tiny"]))
    trt.tokenizer.eos_id = -1
    assert isinstance(trt.kc, QuantKV) and isinstance(trt.vc, QuantKV)
    assert isinstance(trt.params["layers"][0]["w_down"], QuantTensor)

    def jreq(rid, user, p):
        return JaxRequest(rid, user, "test-tiny", p, JaxSampling(
            max_tokens=MAX_TOKENS, repeat_penalty=repeat_penalty))

    def treq(rid, user, p):
        return Request(rid, user, "test-tiny", p, SamplingParams(
            max_tokens=MAX_TOKENS, repeat_penalty=repeat_penalty))

    want, jkinds = _drive(jrt, JaxMQCore(None), jreq, prompts)
    got, tkinds = _drive(trt, MQCore(None), treq, prompts)
    assert got == want
    assert all(len(s) == MAX_TOKENS for s in got)
    assert tkinds == jkinds
    assert "ragged" in tkinds and "decode" in tkinds
    assert trt.alloc.used_pages == 0
    # Bytes count payload plus scales, as the JAX runtime counts them.
    assert (trt.param_bytes, trt.kv_bytes) == (jrt.param_bytes, jrt.kv_bytes)
    stats = trt.stats()
    assert (stats["weights_dtype"], stats["kv_dtype"]) == ("int8", "int8")


def test_int8_runtime_builds_its_own_weights_and_shrinks():
    """Without params the runtime draws its weights and quantizes them
    itself; against the float32 runtime its KV bytes fall under 0.40x and
    its weight bytes under 0.45x (1 payload byte plus 4/hd scale bytes
    per element, against 4)."""
    cfg = MODEL_CONFIGS["test-tiny"]
    f32 = ModelRuntime("test-tiny", cfg, EngineConfig(**SETTINGS), device="cpu",
                       dtype=torch.float32)
    q8 = ModelRuntime("test-tiny", cfg, EngineConfig(**SETTINGS, **INT8), device="cpu",
                      dtype=torch.float32)
    assert q8.kv_bytes < 0.40 * f32.kv_bytes
    assert q8.param_bytes < 0.45 * f32.param_bytes
    assert isinstance(q8.params["embed"], QuantTensor)
    assert q8.params["final_norm"].dtype == torch.float32  # norms stay
    q8.tokenizer.eos_id = -1
    rng = np.random.default_rng(6)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (20, 7, 35)]

    def mk(rid, user, p):
        return Request(rid, user, "test-tiny", p, SamplingParams(max_tokens=6))

    streams, kinds = _drive(q8, MQCore(None), mk, prompts, k_steps=2)
    assert all(len(s) == 6 for s in streams)
    assert "ragged" in kinds and "decode" in kinds
    assert q8.alloc.used_pages == 0
    # Only the KV format changes the pool; weights stay as configured.
    kv_only = ModelRuntime("test-tiny", cfg, dataclasses.replace(
        EngineConfig(**SETTINGS), kv_dtype="int8"), device="cpu", dtype=torch.float32)
    assert kv_only.kv_bytes == q8.kv_bytes and kv_only.param_bytes == f32.param_bytes
