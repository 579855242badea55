"""Orbax checkpoints of the JAX package served by the port, through
scripts/orbax_to_safetensors.py.

For test-tiny, -gqa, -qwen (q/k/v biases), -qwen3 (q/k norms), -moe (the
[L, E, D, F] expert stacks) and -embed (the encoder), in float32 and in
bfloat16: the JAX `init_params` tree (every leaf moved off its constant
init by seeded numpy noise, so a swapped or transposed leaf shows) goes
through the JAX package's `save_orbax`, the script converts the directory
in a subprocess, and the port's `load_params` of the output is bit-equal,
leaf by leaf and in each leaf's own dtype, to `from_jax_numpy` of the JAX
`load_orbax` of the input; in bfloat16 each leaf upcast to float32 is
also bit-equal to `from_jax_numpy` of that input cast to float32 by
ml_dtypes, so the bf16 path is held against the JAX package's values and
not only against itself.

Served on the CPU in float32: TorchEngine over the converted directories
streams the greedy ids of TPUEngine loading the orbax directories
themselves (test-tiny and test-tiny-moe), and the embeddings of
test-tiny-embed agree within 1e-5.

Every refusal of the script (no directory, a safetensors SRC, a directory
that is no orbax checkpoint, DST = SRC, a DST holding a checkpoint, an
unknown model, int8 (q, s) leaves, another layer count, another model's
tree) exits with what to do; the port's own orbax refusal names the
script's command line.
"""

import concurrent.futures
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.engine.engine import TPUEngine
from ollamamq_tpu.models import llama as jllama
from ollamamq_tpu.models import weights as jweights
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.models import weights
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from testutil import collect

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "orbax_to_safetensors.py")
FAMILIES = ["test-tiny", "test-tiny-gqa", "test-tiny-qwen", "test-tiny-qwen3",
            "test-tiny-moe", "test-tiny-embed"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CASES = [(n, d) for n in FAMILIES for d in DTYPES]
CONVERT_TIMEOUT_S = 240
ENGINE = dict(model="test-tiny", max_slots=4, num_pages=64, page_size=8,
              max_pages_per_seq=16, max_new_tokens=12, decode_steps_per_iter=2,
              max_batch_tokens=48, token_granule=8)
PROMPTS = ["convert me", "orbax to safetensors " * 2]
TEXTS = ["a", "retrieval indexes embed documents", "x" * 40]


def _script():
    spec = importlib.util.spec_from_file_location("orbax_to_safetensors", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(name, dtype, seed=5):
    """The JAX init_params tree of `name` in `dtype`, every leaf plus
    seeded noise (norms of ones and biases of zeros included)."""
    params = jllama.init_params(JAX_CONFIGS[name], jax.random.PRNGKey(seed),
                                dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
                              .astype(np.float32), dtype), params)


def _convert(name, src, dst):
    return subprocess.run([sys.executable, SCRIPT, "--model", name, str(src), str(dst)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=CONVERT_TIMEOUT_S)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """{(family, dtype): (orbax dir, converted dir, the script's run)}:
    every tree saved by save_orbax, the conversions run as subprocesses,
    four at a time."""
    root = tmp_path_factory.mktemp("orbax")
    dirs = {}
    for name, dt in CASES:
        src, dst = root / f"{name}-{dt}", root / f"{name}-{dt}-hf"
        jweights.save_orbax(_tree(name, DTYPES[dt][0]), str(src))
        dirs[(name, dt)] = (src, dst)
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        runs = dict(zip(dirs, pool.map(lambda k: _convert(k[0], *dirs[k]), dirs)))
    return {k: (*dirs[k], runs[k]) for k in dirs}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("name,dt", CASES, ids=[f"{n}-{d}" for n, d in CASES])
def test_converted_leaves_are_bit_equal(converted, name, dt):
    src, dst, run = converted[(name, dt)]
    assert run.returncode == 0, run.stderr[-3000:]
    summary = json.loads(run.stdout.strip().splitlines()[-1])
    assert summary["model"] == name and summary["dtypes"] == [dt]
    cfg = MODEL_CONFIGS[name]
    got = weights.load_params(cfg, str(dst), dtype=DTYPES[dt][1])
    want = weights.from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, jweights.load_orbax(str(src))), cfg)
    assert set(got) == set(want)
    assert ("lm_head" in got) == (not cfg.tie_embeddings and not cfg.is_encoder)
    pairs = [(k, got[k], want[k]) for k in want if k != "layers"]
    for i, (lg, lw) in enumerate(zip(got["layers"], want["layers"])):
        assert set(lg) == set(lw), i
        pairs += [(f"layers.{i}.{k}", lg[k], lw[k]) for k in lw]
    assert len(pairs) == summary["tensors"]
    for key, g, w in pairs:
        assert g.dtype == w.dtype == DTYPES[dt][1], key
        assert g.shape == w.shape, key
        assert torch.equal(_bits(g), _bits(w)), key
    if dt == "bfloat16":
        # Away from the bf16 branch of from_jax_numpy: the orbax tree cast
        # to float32 by ml_dtypes' own astype (exact from bf16) goes
        # through its float32 conversion, and every leaf upcast equals it.
        want32 = weights.from_jax_numpy(jax.tree_util.tree_map(
            lambda a: np.asarray(a).astype(np.float32),
            jweights.load_orbax(str(src))), cfg)
        flat32 = {k: want32[k] for k in want32 if k != "layers"}
        for i, lw in enumerate(want32["layers"]):
            flat32.update({f"layers.{i}.{k}": v for k, v in lw.items()})
        for key, g, _ in pairs:
            assert flat32[key].dtype == torch.float32, key
            assert torch.equal(_bits(g.float()), _bits(flat32[key])), key
    if cfg.num_experts:  # [L, E, D, F] stacks became [E, D, F] per layer
        assert got["layers"][0]["we_gate"].shape == (
            cfg.num_experts, cfg.hidden_size, cfg.intermediate_size)


@pytest.fixture(scope="module")
def engine_runs(converted):
    """TPUEngine over the float32 orbax directories, TorchEngine over their
    conversions: greedy ids of PROMPTS on test-tiny and test-tiny-moe, and
    embeddings of TEXTS on test-tiny-embed, from each."""
    names = ("test-tiny", "test-tiny-moe", "test-tiny-embed")
    engines = [
        (TPUEngine(JaxEngineConfig(prefill_buckets=(16, 64), **ENGINE),
                   models={n: str(converted[(n, "float32")][0]) for n in names},
                   blocklist_path=None, dtype=jnp.float32), JaxSampling),
        (TorchEngine(EngineConfig(**ENGINE), device="cpu", dtype=torch.float32,
                     blocklist_path=None,
                     models={n: str(converted[(n, "float32")][1]) for n in names}),
         SamplingParams)]
    runs = []
    for eng, sp in engines:
        eng.start()
        try:
            gens = {}
            for name in names[:2]:
                tok = eng.runtimes[name].tokenizer
                tok.eos_id = -1  # full-length streams
                gens[name] = [eng.enqueue_request(
                    f"u{i}", "", name, prompt_tokens=tok.encode(p),
                    sampling=sp(max_tokens=12, temperature=0.0))
                    for i, p in enumerate(PROMPTS)]
            tok = eng.runtimes["test-tiny-embed"].tokenizer
            embeds = [eng.enqueue_request(f"rag-{i}", "", "test-tiny-embed",
                                          prompt_tokens=tok.encode(t),
                                          sampling=sp(), kind="embed")
                      for i, t in enumerate(TEXTS)]
            for req in [r for rs in gens.values() for r in rs] + embeds:
                assert collect(req, timeout=120)[-1].kind == "done"
            runs.append(({n: [list(r.generated_ids) for r in rs]
                          for n, rs in gens.items()},
                         [np.asarray(r.embedding, np.float32) for r in embeds]))
        finally:
            eng.stop()
    return runs


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-moe"])
def test_served_ids_match_tpu_engine_on_the_orbax_dir(engine_runs, name):
    (want, _), (got, _) = engine_runs
    assert got[name] == want[name]
    assert all(len(ids) == 12 for ids in got[name])


def test_encoder_embeddings_match_tpu_engine(engine_runs):
    (_, want), (_, got) = engine_runs
    for g, w in zip(got, want):
        assert g.shape == w.shape == (MODEL_CONFIGS["test-tiny-embed"].hidden_size,)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def odd_trees(tmp_path_factory, converted):
    """Directories the script refuses: int8 (q, s) leaves, one layer of
    test-tiny's two, a safetensors directory, a directory of no
    checkpoint, a DST already holding one."""
    root = tmp_path_factory.mktemp("odd")
    cfg = JAX_CONFIGS["test-tiny"]
    jweights.save_orbax(jweights.quantize_params_int8(_tree("test-tiny", jnp.float32),
                                                      cfg), str(root / "int8"))
    one = _tree("test-tiny", jnp.float32)
    one["layers"] = {k: v[:1] for k, v in one["layers"].items()}
    jweights.save_orbax(one, str(root / "one-layer"))
    (root / "empty").mkdir()
    (root / "notes.txt").write_text("x")
    return {"int8": root / "int8", "one-layer": root / "one-layer",
            "empty": root / "empty", "file": root / "notes.txt",
            "orbax": converted[("test-tiny", "float32")][0],
            "hf": converted[("test-tiny", "float32")][1], "new": root / "new"}


REFUSALS = {
    # case: (model, src, dst, why, what to do)
    "not-a-directory": ("test-tiny", "file", "new", "is not a directory",
                        "pass the orbax checkpoint directory"),
    "safetensors-src": ("test-tiny", "hf", "new", "already an HF safetensors",
                        "serve it as it is"),
    "not-orbax": ("test-tiny", "empty", "new", "is not an orbax checkpoint",
                  "pass the directory save_orbax wrote"),
    "dst-is-src": ("test-tiny", "orbax", "orbax", "DST must be another directory",
                   "than SRC"),
    "dst-holds-checkpoint": ("test-tiny", "orbax", "hf", "already holds a .safetensors",
                             "pick an empty or new directory"),
    "unknown-model": ("no-such-model", "orbax", "new", "unknown model",
                      "pass a name of the port's MODEL_CONFIGS"),
    "int8-leaves": ("test-tiny", "int8", "new", "int8 (q, s) leaves",
                    "serve it with --weights-dtype int8"),
    "layer-count": ("test-tiny", "one-layer", "new", "holds 1 layers, model test-tiny has 2",
                    "pass the --model the checkpoint was saved for"),
    "other-family": ("test-tiny-qwen", "orbax", "new", "not a test-tiny-qwen tree",
                     "pass the --model the checkpoint was saved for"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_script_refuses_with_what_to_do(odd_trees, case, capsys):
    model, src, dst, why, todo = REFUSALS[case]
    rc = _script().main(["--model", model, str(odd_trees[src]), str(odd_trees[dst])])
    err = capsys.readouterr().err
    assert rc == 2 and why in err and todo in err, err
    assert not os.path.exists(odd_trees["new"])  # nothing written


def test_port_refusal_names_the_converter(odd_trees):
    """load_params keeps its words and adds the script's command line; the
    same message reaches --checkpoints (the engine's build) and /api/pull
    (load_model)."""
    orbax = str(odd_trees["orbax"])
    cmd = f"python scripts/orbax_to_safetensors.py --model test-tiny {orbax} DST"
    with pytest.raises(ValueError, match="orbax checkpoint needs the JAX package") as e:
        weights.load_params(MODEL_CONFIGS["test-tiny"], orbax)
    assert cmd in str(e.value)
    ecfg = EngineConfig(model="test-tiny", max_slots=2, num_pages=16, page_size=8,
                        max_pages_per_seq=4)
    with pytest.raises(ValueError) as e:
        TorchEngine(ecfg, device="cpu", blocklist_path=None, models={"test-tiny": orbax})
    assert cmd in str(e.value)
    eng = TorchEngine(ecfg, device="cpu", blocklist_path=None, models={"test-tiny": None})
    with pytest.raises(ValueError) as e:
        eng.load_model("test-tiny-qwen3", orbax)
    assert "scripts/orbax_to_safetensors.py --model test-tiny-qwen3" in str(e.value)
    assert "test-tiny-qwen3" not in eng.runtimes
