"""Checkpoints and tokenizers of the port against the JAX package on the
CPU: the stdlib HF-safetensors reader and writer (bit-equal with the
JAX loader and the safetensors package in bf16 and float32, shards,
metadata, dtypes), load_params (int8, the orbax refusal), a greedy
stream from a checkpoint-loaded TorchEngine identical to TPUEngine's
from the same directory, HFTokenizer parity, and the quantization
guardrail's gauge."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.engine import tokenizer as jtok
from ollamamq_tpu.engine.engine import TPUEngine
from ollamamq_tpu.models import llama as jllama
from ollamamq_tpu.models import weights as jweights
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.engine import tokenizer as ttok
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.models import weights
from ollamamq_tpu_torch.ops.quant import QuantTensor
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.telemetry import schema as tm
from testutil import collect


def _fake_hf_checkpoint(cfg, tmp_path, with_bias=False, np_dtype=np.float32):
    """tests/test_weights.py's HF-layout checkpoint, in `np_dtype`."""
    rng = np.random.default_rng(0)
    d, qd, kvd, f, v = (cfg.hidden_size, cfg.q_dim, cfg.kv_dim,
                        cfg.intermediate_size, cfg.vocab_size)

    def w(*shape):
        return rng.normal(size=shape).astype(np.float32).astype(np_dtype)

    def ones(n):
        return np.ones((n,), np.float32).astype(np_dtype)

    tensors = {"model.embed_tokens.weight": w(v, d), "model.norm.weight": ones(d),
               "lm_head.weight": w(v, d)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        tensors[p + "input_layernorm.weight"] = ones(d)
        tensors[p + "post_attention_layernorm.weight"] = ones(d)
        tensors[p + "self_attn.q_proj.weight"] = w(qd, d)
        tensors[p + "self_attn.k_proj.weight"] = w(kvd, d)
        tensors[p + "self_attn.v_proj.weight"] = w(kvd, d)
        tensors[p + "self_attn.o_proj.weight"] = w(d, qd)
        tensors[p + "mlp.gate_proj.weight"] = w(f, d)
        tensors[p + "mlp.up_proj.weight"] = w(f, d)
        tensors[p + "mlp.down_proj.weight"] = w(d, f)
        if with_bias:
            tensors[p + "self_attn.q_proj.bias"] = w(qd)
            tensors[p + "self_attn.k_proj.bias"] = w(kvd)
            tensors[p + "self_attn.v_proj.bias"] = w(kvd)
    save_file(tensors, str(tmp_path / "model.safetensors"))
    return tensors


def _bits(a) -> np.ndarray:
    """Raw bit pattern of a torch tensor or JAX / numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


def test_safetensors_hf_layout(tmp_path):
    cfg = MODEL_CONFIGS["test-tiny"]
    raw = _fake_hf_checkpoint(cfg, tmp_path)
    params = weights.load_safetensors(cfg, str(tmp_path), dtype=torch.float32)
    assert len(params["layers"]) == cfg.num_layers
    assert params["layers"][0]["wq"].shape == (cfg.hidden_size, cfg.q_dim)
    # HF [out, in] transposes to our [in, out].
    np.testing.assert_array_equal(params["layers"][0]["wq"].numpy(),
                                  raw["model.layers.0.self_attn.q_proj.weight"].T)
    np.testing.assert_array_equal(params["embed"].numpy(), raw["model.embed_tokens.weight"])
    assert "lm_head" in params  # an untied config keeps its head
    # And the loaded checkpoint runs.
    assert torch.isfinite(weights._full_logits(params, cfg, [1, 2, 3, 4])).all()


def test_safetensors_qwen_bias(tmp_path):
    cfg = MODEL_CONFIGS["test-tiny-qwen"]
    _fake_hf_checkpoint(cfg, tmp_path, with_bias=True)
    params = weights.load_safetensors(cfg, str(tmp_path), dtype=torch.float32)
    assert all(lp["bq"].shape == (cfg.q_dim,) and lp["bk"].shape == (cfg.kv_dim,)
               for lp in params["layers"])


def test_layer_count_mismatch_rejected(tmp_path):
    cfg = MODEL_CONFIGS["test-tiny"]
    _fake_hf_checkpoint(cfg, tmp_path)
    wrong = dataclasses.replace(cfg, num_layers=cfg.num_layers + 1)
    with pytest.raises(ValueError, match="layers"):
        weights.load_safetensors(wrong, str(tmp_path))


def _assert_trees_bit_equal(tp, jp, num_layers):
    assert set(tp) == set(jp)
    for k in ("embed", "final_norm", "lm_head"):
        if k in tp:
            np.testing.assert_array_equal(_bits(tp[k]), _bits(jp[k]))
    assert set(tp["layers"][0]) == set(jp["layers"])
    for name, stack in jp["layers"].items():
        for i in range(num_layers):
            np.testing.assert_array_equal(_bits(tp["layers"][i][name]),
                                          _bits(np.asarray(stack)[i]))


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-qwen"])
def test_reader_bit_equal_with_jax_loader(tmp_path, name, dt):
    """A checkpoint written by safetensors.numpy.save_file (bf16 through
    ml_dtypes) reads bit-equal through the port's stdlib reader and the
    JAX package's loader."""
    cfg = MODEL_CONFIGS[name]
    np_dtype = ml_dtypes.bfloat16 if dt == "bfloat16" else np.float32
    _fake_hf_checkpoint(cfg, tmp_path, with_bias=cfg.attn_bias, np_dtype=np_dtype)
    tp = weights.load_safetensors(cfg, str(tmp_path), dtype=getattr(torch, dt))
    jp = jweights.load_safetensors(JAX_CONFIGS[name], str(tmp_path),
                                   dtype=getattr(jnp, dt))
    _assert_trees_bit_equal(tp, jp, cfg.num_layers)


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-qwen3", "test-tiny-embed"])
def test_writer_read_by_safetensors_and_jax(tmp_path, name, dt):
    """save_safetensors' file: the safetensors package reads every tensor
    back bit-equal, and the JAX loader builds the same tree."""
    cfg = MODEL_CONFIGS[name]
    params = weights.init_random(cfg, seed=1, dtype=getattr(torch, dt))
    path = weights.save_safetensors(params, cfg, str(tmp_path))
    with safe_open(path, framework="np") as f:
        names = set(f.keys())
        np.testing.assert_array_equal(
            _bits(f.get_tensor("model.layers.1.self_attn.q_proj.weight")),
            _bits(params["layers"][1]["wq"].t().contiguous()))
        np.testing.assert_array_equal(_bits(f.get_tensor("model.embed_tokens.weight")),
                                      _bits(params["embed"]))
    assert ("lm_head.weight" in names) == ("lm_head" in params)
    jp = jweights.load_safetensors(JAX_CONFIGS[name], str(tmp_path),
                                   dtype=getattr(jnp, dt))
    _assert_trees_bit_equal(params, jp, cfg.num_layers)
    back = weights.load_safetensors(cfg, str(tmp_path), dtype=getattr(torch, dt))
    _assert_trees_bit_equal(back, jp, cfg.num_layers)


def test_shards_metadata_and_dtypes(tmp_path):
    """Several shards read in sorted order as one checkpoint; the
    __metadata__ entry is skipped; I64 and F16 read; other dtypes raise."""
    cfg = MODEL_CONFIGS["test-tiny"]
    one = tmp_path / "one"
    one.mkdir()
    raw = _fake_hf_checkpoint(cfg, one)
    shards = tmp_path / "shards"
    shards.mkdir()
    names = sorted(raw)
    half = len(names) // 2
    save_file({k: raw[k] for k in names[:half]},
              str(shards / "model-00001-of-00002.safetensors"), metadata={"format": "pt"})
    save_file({k: raw[k] for k in names[half:]},
              str(shards / "model-00002-of-00002.safetensors"))
    a = weights.load_safetensors(cfg, str(one), dtype=torch.float32)
    b = weights.load_safetensors(cfg, str(shards), dtype=torch.float32)
    _assert_trees_bit_equal(a, {**b, "layers": {
        k: np.stack([lp[k].numpy() for lp in b["layers"]]) for k in b["layers"][0]}},
        cfg.num_layers)
    f = str(tmp_path / "mixed.safetensors")
    ints = np.arange(6, dtype=np.int64).reshape(2, 3)
    halfs = np.linspace(-1, 1, 5).astype(np.float16)
    save_file({"i": ints, "h": halfs}, f, metadata={"note": "x"})
    got = weights.read_safetensors(f)
    assert set(got) == {"i", "h"}
    assert got["i"].dtype == torch.int64 and got["i"].tolist() == ints.tolist()
    assert got["h"].dtype == torch.float16
    np.testing.assert_array_equal(got["h"].numpy(), halfs)
    save_file({"x": np.zeros(3, np.int32)}, str(tmp_path / "bad.safetensors"))
    with pytest.raises(ValueError, match="I32"):
        weights.read_safetensors(str(tmp_path / "bad.safetensors"))


def test_load_params_int8_orbax_and_moe(tmp_path):
    cfg = MODEL_CONFIGS["test-tiny"]
    _fake_hf_checkpoint(cfg, tmp_path)
    q = weights.load_params(cfg, str(tmp_path), dtype=torch.float32,
                            weights_dtype="int8")
    assert isinstance(q["layers"][0]["wq"], QuantTensor)
    assert isinstance(q["embed"], QuantTensor)
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax checkpoint needs the JAX package"):
        weights.load_params(cfg, str(orbax))
    with pytest.raises(ValueError, match="orbax"):
        TorchEngine(EngineConfig(model="test-tiny", max_slots=2, num_pages=16,
                                 page_size=8, max_pages_per_seq=4),
                    device="cpu", models={"test-tiny": str(orbax)})
    moe = tmp_path / "moe"
    moe.mkdir()
    save_file({"model.layers.0.block_sparse_moe.gate.weight": np.zeros((4, 64), np.float32)},
              str(moe / "model.safetensors"))
    with pytest.raises(ValueError, match="mixture-of-experts"):
        weights.load_safetensors(cfg, str(moe))
    with pytest.raises(ValueError, match="unquantized"):
        weights.save_safetensors(q, cfg, str(tmp_path / "q"))


def _write_tokenizer(path):
    """A byte-level BPE tokenizer.json trained here, with Llama 3's
    begin/end special tokens; vocab < 512 so test-tiny can emit any id."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=400, special_tokens=["<|begin_of_text|>", "<|eot_id|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    corpus = ["the quick brown fox jumps over the lazy dog",
              "fair queues share one card between many users",
              "café naïve ☃ snowmen ☃☃ and résumés"] * 20
    tok.train_from_iterator(corpus, trainer)
    tok.save(os.path.join(path, "tokenizer.json"))


TEXTS = ["the quick brown fox", "café ☃☃ naïve", "", "queues!"]


def test_hf_tokenizer_matches_jax(tmp_path):
    _write_tokenizer(str(tmp_path))
    t, j = ttok.load_tokenizer(str(tmp_path)), jtok.load_tokenizer(str(tmp_path))
    assert isinstance(t, ttok.HFTokenizer)
    assert (t.bos_id, t.eos_id, t.pad_id, t.vocab_size) == \
        (j.bos_id, j.eos_id, j.pad_id, j.vocab_size)
    assert t.bos_id == t._tok.token_to_id("<|begin_of_text|>")
    assert t.eos_id == t._tok.token_to_id("<|eot_id|>")
    for text in TEXTS:
        for bos in (True, False):
            assert t.encode(text, add_bos=bos) == j.encode(text, add_bos=bos)
        ids = t.encode(text)
        assert t.decode(ids) == j.decode(ids) == text
        # Byte-by-byte ids split the multibyte characters: the decoder
        # holds back the incomplete tail, as the JAX one does.
        step_t, step_j = t.make_incremental_decoder(), j.make_incremental_decoder()
        byte_ids = [t._tok.token_to_id(c) for c in
                    pre_tokenizers_bytes(text)]
        out_t = [step_t(i) for i in ids + byte_ids]
        out_j = [step_j(i) for i in ids + byte_ids]
        assert out_t == out_j
        assert "".join(out_t) == text + text
    assert isinstance(ttok.load_tokenizer(None), ttok.ByteTokenizer)
    assert isinstance(ttok.load_tokenizer(str(tmp_path / "nothing")), ttok.ByteTokenizer)


def pre_tokenizers_bytes(text):
    """The byte-level alphabet's symbol of each UTF-8 byte of `text`."""
    from tokenizers import pre_tokenizers

    pieces = pre_tokenizers.ByteLevel(add_prefix_space=False,
                                      use_regex=False).pre_tokenize_str(text)
    return [c for piece, _ in pieces for c in piece]


def test_checkpoint_stream_matches_tpu_engine(tmp_path):
    """A directory with HF weights (the JAX init of test-tiny, float32)
    and a tokenizer.json: TorchEngine and TPUEngine built from it stream
    identical greedy ids for the same prompts."""
    cfg = MODEL_CONFIGS["test-tiny"]
    jp = jllama.init_params(JAX_CONFIGS["test-tiny"], jax.random.PRNGKey(5),
                            dtype=jnp.float32)
    from ollamamq_tpu_torch.models.weights import from_jax_numpy

    weights.save_safetensors(from_jax_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg),
                             cfg, str(tmp_path))
    _write_tokenizer(str(tmp_path))
    settings = dict(model="test-tiny", max_slots=4, num_pages=64, page_size=8,
                    max_pages_per_seq=16, max_new_tokens=16, decode_steps_per_iter=2,
                    max_batch_tokens=48, token_granule=8)
    engines = [
        (TPUEngine(JaxEngineConfig(prefill_buckets=(16, 64), **settings),
                   models={"test-tiny": str(tmp_path)}, blocklist_path=None,
                   dtype=jnp.float32), JaxSampling),
        (TorchEngine(EngineConfig(**settings), device="cpu", dtype=torch.float32,
                     models={"test-tiny": str(tmp_path)}), SamplingParams)]
    streams = []
    for eng, sp in engines:
        rt = eng.runtimes["test-tiny"]
        assert type(rt.tokenizer).__name__ == "HFTokenizer"
        rt.tokenizer.eos_id = -1  # full-length streams
        eng.start()
        try:
            ids = []
            for text in ("the quick brown fox", "café queues"):
                req = eng.enqueue_request("u", "", "test-tiny",
                                          prompt_tokens=rt.tokenizer.encode(text),
                                          sampling=sp(max_tokens=16))
                assert collect(req)[-1].kind == "done"
                ids.append(list(req.generated_ids))
            streams.append(ids)
        finally:
            eng.stop()
    assert streams[0] == streams[1]
    assert all(len(s) == 16 for s in streams[1])


def test_guardrail_sets_logit_error_gauge():
    cfg = MODEL_CONFIGS["test-tiny"]
    out = weights.quant_guardrail(cfg, dtype=torch.float32, steps=2, prompt_len=4)
    gauge = tm.QUANT_LOGIT_ERR.labels(model="test-tiny")
    assert gauge.value == out["max_logit_err"] > 0
    line = [ln for ln in tm.REGISTRY.render().splitlines()
            if ln.startswith('ollamamq_quant_logit_err{model="test-tiny"}')]
    assert line and float(line[0].split()[-1]) == pytest.approx(out["max_logit_err"])
    assert json.dumps(out)
