"""The slice as a whole on the CPU: the port's ModelRuntime against the
JAX package's ModelRuntime, same weights, same prompts, same ticks.

Both runtimes take the settings of tests/test_ragged_engine.py's make_rt
(test-tiny, float32, page size 8, token budget 48, granule 8, four
slots) with EOS disabled, and are driven by the same engine-loop-shaped
tick: a ragged mixed dispatch when a prefill span is in flight, else one
decode step. Six prompts straddle the page and token-budget boundaries,
so prefill spans are split across ticks and share dispatches with decode
rows. Greedy streams must be IDENTICAL (argmax over float32 logits that
agree within 1e-4; see test_torch_model.py).
"""

import itertools

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
from ollamamq_tpu_torch.ops.sampling import SamplingParams

SETTINGS = dict(model="test-tiny", max_slots=4, num_pages=96, page_size=8,
                max_pages_per_seq=16, max_new_tokens=8,
                decode_steps_per_iter=2, max_batch_tokens=48, token_granule=8)
# Lengths hug the page size (8) and the token budget (48).
PROMPT_LENS = [7, 8, 9, 47, 49, 23]
# Long enough that most tokens come from decode ticks, where the penalty
# ring rolls inside the decode dispatch.
MAX_TOKENS = 16
_IDS = itertools.count(1)


def _jax_runtime():
    rt = JaxRuntime("test-tiny", JAX_CONFIGS["test-tiny"],
                    JaxEngineConfig(prefill_buckets=(16, 64), **SETTINGS),
                    dtype=jnp.float32)
    rt.tokenizer.eos_id = -1
    return rt


def _torch_runtime(jax_params):
    pnp = jax.tree_util.tree_map(np.asarray, jax_params)
    rt = ModelRuntime("test-tiny", MODEL_CONFIGS["test-tiny"],
                      EngineConfig(**SETTINGS), device="cpu",
                      dtype=torch.float32,
                      params=from_jax_numpy(pnp, MODEL_CONFIGS["test-tiny"]))
    rt.tokenizer.eos_id = -1
    return rt


def _drive(rt, core, make_req, prompts, max_ticks=400, k_steps=1):
    """Submit every prompt, tick until all finish (decode ticks run
    k_steps tokens per dispatch); returns the streams and the tick kinds
    seen."""
    reqs = []
    for i, p in enumerate(prompts):
        req = make_req(next(_IDS), f"u{i % 3}", list(p))
        req._inc_decode = rt.tokenizer.make_incremental_decoder()
        rt.pending_prefill.append(req)
        reqs.append(req)
    kinds = []
    for _ in range(max_ticks):
        if all(r.stats.finished_at for r in reqs):
            break
        if rt.step_ragged(core):
            kinds.append("ragged")
        elif any(r is not None for r in rt.slot_req):
            rt.step_decode(core, k_steps=k_steps)
            kinds.append("decode")
    assert all(r.stats.finished_at for r in reqs), "requests wedged"
    return [list(r.generated_ids) for r in reqs], kinds


@pytest.mark.parametrize("repeat_penalty", [1.0, 1.1],
                         ids=["greedy", "repeat-penalty"])
def test_greedy_streams_match_jax_runtime(repeat_penalty):
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in PROMPT_LENS]
    jrt = _jax_runtime()
    trt = _torch_runtime(jrt.params)

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
    # Both attention paths ran, in the same order as the reference's.
    assert tkinds == jkinds
    assert "ragged" in tkinds and "decode" in tkinds
    assert trt.ragged_dispatches == tkinds.count("ragged")
    assert trt.decode_dispatches == tkinds.count("decode")
    # Every page went back to the pool.
    assert trt.alloc.used_pages == 0


@pytest.mark.parametrize("sampling", [
    dict(repeat_penalty=1.1),
    dict(temperature=0.9, top_k=40, top_p=0.95, seed=77),
], ids=["greedy-penalty", "seeded-sampled"])
def test_multi_step_decode_matches_single_steps(sampling):
    """One decode dispatch of k_steps tokens (the serving loop's shape:
    the penalty ring rolls and seeded rows draw at each step's own
    position inside the dispatch) emits the same streams as k_steps
    single-step dispatches, slots finishing mid-dispatch included."""
    cfg = MODEL_CONFIGS["test-tiny"]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in (5, 17, 30)]
    budgets = [7, 10, 5]  # finish at different steps of a 4-step dispatch

    def run(k_steps):
        rt = ModelRuntime("test-tiny", cfg, EngineConfig(**SETTINGS),
                          device="cpu", dtype=torch.float32)
        rt.tokenizer.eos_id = -1

        def mk(rid, user, p):
            return Request(rid, user, "test-tiny", p, SamplingParams(
                max_tokens=budgets[prompts.index(p)], **sampling))

        streams, kinds = _drive(rt, MQCore(None), mk, prompts, k_steps=k_steps)
        assert rt.alloc.used_pages == 0
        return streams, kinds

    one, kinds_one = run(1)
    four, kinds_four = run(4)
    assert four == one
    assert [len(s) for s in four] == budgets
    assert kinds_four.count("decode") < kinds_one.count("decode")


def test_seeded_sampling_is_reproducible_across_batches():
    """Seeded rows are a pure function of (seed, position): the same
    seeded request gives the same stream alone and beside other
    (unseeded, sampled) requests."""
    cfg = MODEL_CONFIGS["test-tiny"]

    def run(n_mates):
        rt = ModelRuntime("test-tiny", cfg, EngineConfig(**SETTINGS),
                          device="cpu", dtype=torch.float32)
        rt.tokenizer.eos_id = -1
        prompts = [[5, 6, 7, 8, 9]] + [[10 + i] * (3 + i) for i in range(n_mates)]

        def mk(rid, user, p):
            seed = 1234 if p == prompts[0] else None
            return Request(rid, user, "test-tiny", p,
                           SamplingParams(max_tokens=8, temperature=1.0,
                                          top_k=50, seed=seed))

        streams, _ = _drive(rt, MQCore(None), mk, prompts)
        return streams[0]

    alone = run(0)
    assert run(2) == alone
    assert run(3) == alone


# ------------------------------------------- the bucketed path (pp > 1)
def _drive_bucketed(rt, core, make_req, prompts, max_ticks=400):
    """The pipeline path's tick (TorchEngine._loop_once with ragged off):
    up to two bucketed prefills, one chunk, then one decode step."""
    reqs = []
    for i, p in enumerate(prompts):
        req = make_req(next(_IDS), f"u{i % 3}", list(p))
        req._inc_decode = rt.tokenizer.make_incremental_decoder()
        rt.pending_prefill.append(req)
        reqs.append(req)
    kinds = []
    for _ in range(max_ticks):
        if all(r.stats.finished_at for r in reqs):
            break
        budget = 2
        while budget and rt.pending_prefill and rt.step_prefill(core):
            budget -= 1
            kinds.append("prefill")
        if rt.step_chunk(core):
            kinds.append("chunk")
        if any(r is not None for r in rt.slot_req):
            rt.step_decode(core, k_steps=1)
            kinds.append("decode")
    assert all(r.stats.finished_at for r in reqs), "requests wedged"
    return [list(r.generated_ids) for r in reqs], kinds


@pytest.mark.parametrize("repeat_penalty", [1.0, 1.1],
                         ids=["greedy", "repeat-penalty"])
def test_bucketed_path_matches_jax_runtime(repeat_penalty):
    """The non-ragged path a pp > 1 runtime serves, at pp 1 on both
    sides (ragged off, as tests/test_correctness_edges.py drives the JAX
    loop's branch): batched same-bucket prefills padded to
    MAX_PREFILL_BATCH, prompts past the largest bucket (47, 49 > 32) in
    chunks, the penalty ring opened by each. Greedy streams and the
    sequence of steps are identical to the JAX runtime's."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, 500, size=n).tolist() for n in PROMPT_LENS]
    jrt = JaxRuntime("test-tiny", JAX_CONFIGS["test-tiny"],
                     JaxEngineConfig(prefill_buckets=(16, 32), **SETTINGS),
                     dtype=jnp.float32)
    jrt.tokenizer.eos_id = -1
    jrt.ragged = False
    pnp = jax.tree_util.tree_map(np.asarray, jrt.params)
    trt = ModelRuntime("test-tiny", MODEL_CONFIGS["test-tiny"],
                       EngineConfig(prefill_buckets=(16, 32), **SETTINGS),
                       device="cpu", dtype=torch.float32,
                       params=from_jax_numpy(pnp, MODEL_CONFIGS["test-tiny"]))
    trt.tokenizer.eos_id = -1
    trt.ragged = False

    def jreq(rid, user, p):
        return JaxRequest(rid, user, "test-tiny", p, JaxSampling(
            max_tokens=MAX_TOKENS, repeat_penalty=repeat_penalty))

    def treq(rid, user, p):
        return Request(rid, user, "test-tiny", p, SamplingParams(
            max_tokens=MAX_TOKENS, repeat_penalty=repeat_penalty))

    want, jkinds = _drive_bucketed(jrt, JaxMQCore(None), jreq, prompts)
    got, tkinds = _drive_bucketed(trt, MQCore(None), treq, prompts)
    assert got == want
    assert tkinds == jkinds
    assert {"prefill", "chunk", "decode"} <= set(tkinds)
    # A step_prefill that hands a long prompt to the chunks runs no
    # forward: 2 of the steps did (47 and 49 tokens).
    assert trt.prefill_dispatches == tkinds.count("prefill") - 2
    assert trt.chunk_dispatches == tkinds.count("chunk")
    assert trt.ragged_dispatches == 0
    assert trt.alloc.used_pages == 0


def test_prefill_drain_bounded_per_tick():
    """The mirror of tests/test_correctness_edges.py's: an arrival storm
    must not starve decode, so _loop_once admits at most
    prefill_batches_per_tick bucketed prefills (the pipeline path's loop
    branch, driven here with ragged off) before dispatching decode."""
    from ollamamq_tpu_torch.engine.engine import TorchEngine

    eng = TorchEngine(
        EngineConfig(model="test-tiny", max_slots=2, num_pages=32,
                     page_size=8, max_pages_per_seq=8, prefill_buckets=(16,),
                     decode_steps_per_iter=2, prefill_batches_per_tick=2,
                     dtype="float32"),
        device="cpu", blocklist_path=None)
    rt = eng.runtimes["test-tiny"]
    rt.ragged = False
    calls = []
    rt.step_prefill = lambda core: (calls.append(1), True)[1]
    rt.pending_prefill.append(
        Request(1, "edgeF", "test-tiny", [1, 2], SamplingParams(max_tokens=2)))
    eng._loop_once()
    assert len(calls) == 2
    calls.clear()
    eng.ecfg.prefill_batches_per_tick = 1
    eng._loop_once()
    assert len(calls) == 1


@pytest.mark.parametrize("case", ["layers", "moe", "sp"])
def test_pp_runtime_refusals(case, monkeypatch):
    """A pp that does not divide the layers, pp with a mixture-of-experts
    model, and pp with sp are refused at build, before any weight is
    drawn, in the JAX runtime's words (ollamamq_tpu/engine/engine.py)."""
    from ollamamq_tpu_torch.models import weights
    from ollamamq_tpu_torch.parallel.mesh import RankMesh

    def no_weights(*a, **k):
        raise AssertionError("weights were drawn for an invalid layout")

    monkeypatch.setattr(weights, "load_params", no_weights)
    name, shape = {"layers": ("test-tiny", {"pipe": 4}),
                   "moe": ("test-tiny-moe", {"pipe": 2}),
                   "sp": ("test-tiny", {"pipe": 2, "seq": 2})}[case]
    n = 1
    for v in shape.values():
        n *= v
    mesh = RankMesh(shape, 0, ["cpu"] * n)
    want = {"layers": "pp=4 must divide num_layers=2 (test-tiny)",
            "moe": ("pp with an MoE model is not supported: the pipeline "
                    "stage body runs the dense FFN (use ep x tp for MoE)"),
            "sp": ("pp and sp cannot combine on one runtime: pipeline "
                   "stages and sequence shards contend for the same "
                   "activation layout (use pp x tp, or sp x tp)")}[case]
    with pytest.raises(ValueError) as exc:
        ModelRuntime(name, MODEL_CONFIGS[name],
                     EngineConfig(model=name, num_pages=8, page_size=8), mesh=mesh)
    assert str(exc.value) == want
