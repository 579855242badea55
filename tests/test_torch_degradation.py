"""Degradation of the port's engine under load and faults, on the CPU.

TorchEngine serves test-tiny on its loop thread, as the server drives
it. Mirrors of the JAX package's tests/test_engine.py:598 (pool
pressure), tests/test_degradation.py (preemption with recompute, the
explicit kv_exhausted error, retries and poisoning) and
tests/test_chaos.py:118 (a runtime rebuilt after a failed decode
dispatch). Faults come from the port's copy of the deterministic fault
plan (ollamamq_tpu_torch/testing/faults.py), so every run replays the
same faults in the same order. The preempted stream is held against the
JAX engine's stream under the same plan, on bridged float32 weights.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.engine.engine import TPUEngine
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu.testing.faults import FaultPlan as JaxFaultPlan
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.engine.request import FinishReason
from ollamamq_tpu_torch.models.weights import from_jax_numpy
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.testing.faults import FaultPlan
from testutil import collect

# tests/test_degradation.py's engine.
TINY = dict(model="test-tiny", max_slots=2, num_pages=64, page_size=8,
            max_pages_per_seq=16, decode_steps_per_iter=2)
PROMPT = "the quick brown fox jumps"


def _engine(plan=None, params=None, **over):
    eng = TorchEngine(EngineConfig(fault_plan=plan, **{**TINY, **over}),
                      device="cpu", dtype=torch.float32, params=params)
    eng.start()
    return eng


def _run(eng, user, prompt=PROMPT, max_tokens=10):
    tok = eng.resolve_runtime("test-tiny").tokenizer
    return eng.enqueue_request(user, "", "test-tiny",
                               prompt_tokens=tok.encode(prompt),
                               sampling=SamplingParams(max_tokens=max_tokens))


def _ids(items):
    return [i.token_id for i in items if i.kind == "token" and i.token_id >= 0]


def test_kv_pool_pressure_waits_and_recovers():
    """tests/test_engine.py:598 with the default config (preemption on):
    8 users against 15 usable pages, each request growing to 3 pages.
    Every stream ends `done` (a dry pool preempts, never errors) and no
    page leaks."""
    eng = TorchEngine(EngineConfig(model="test-tiny", max_slots=8, num_pages=16,
                                   page_size=8, max_pages_per_seq=4,
                                   max_new_tokens=8, decode_steps_per_iter=1),
                      device="cpu")
    eng.start()
    try:
        tok = eng.runtimes["test-tiny"].tokenizer
        reqs = [eng.enqueue_request(f"p{i}", "", "test-tiny",
                                    prompt_tokens=tok.encode(f"pressure {i}"),
                                    sampling=SamplingParams(max_tokens=12))
                for i in range(8)]
        for r in reqs:
            items = collect(r, timeout=120)
            assert items[-1].kind == "done", items[-1]
        rt = eng.runtimes["test-tiny"]
        assert rt.alloc.used_pages == 0  # everything reclaimed
        assert eng.preemption_count() >= 1  # the pool really ran dry
        snap = eng.core.snapshot()
        assert all(snap["users"][f"p{i}"]["processed"] == 1 for i in range(8))
        assert sum(u["processing"] for u in snap["users"].values()) == 0
    finally:
        eng.stop()


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["cache-off", "cache-on"])
def test_preemption_round_trip_matches_unloaded_and_jax(prefix_cache):
    """tests/test_degradation.py:113: the third decode-time page growth
    fails, the lone request preempts itself, requeues at the front,
    replays prompt + generated, and continues. Its token ids equal the
    unloaded run's and the JAX engine's under the same plan."""
    rule = [{"site": "extend", "kind": "alloc_fail", "at": [3]}]
    jeng = TPUEngine(JaxEngineConfig(prefill_buckets=(16, 32, 64),
                                     fault_plan=JaxFaultPlan(rule),
                                     prefix_cache=prefix_cache, **TINY),
                     models={"test-tiny": None}, blocklist_path=None,
                     dtype=jnp.float32)
    jeng.start()
    try:
        tok = jeng.runtimes["test-tiny"].tokenizer
        jreq = jeng.enqueue_request("victim", "", "test-tiny",
                                    prompt_tokens=tok.encode(PROMPT),
                                    sampling=JaxSampling(max_tokens=10))
        want = collect(jreq)
        pnp = jax.tree_util.tree_map(np.asarray, jeng.runtimes["test-tiny"].params)
    finally:
        jeng.stop()
    assert want[-1].kind == "done" and jreq.preemptions >= 1
    params = from_jax_numpy(pnp, MODEL_CONFIGS["test-tiny"])

    eng = _engine(params=params, prefix_cache=prefix_cache)
    try:
        base = collect(_run(eng, "base"))
    finally:
        eng.stop()
    eng = _engine(FaultPlan(rule), params=params, prefix_cache=prefix_cache)
    try:
        req = _run(eng, "victim")
        items = collect(req)
        rt = eng.runtimes["test-tiny"]
        assert req.preemptions >= 1 and rt.preempt_count >= 1
        if prefix_cache:
            # The replay walks the tree that the preemption's insert seeded.
            stats = eng.prefix_cache_stats()
            assert stats["enabled"] and stats["models"]["test-tiny"]["hits"] >= 1
            rt.prefix_cache.check()
            # A flush (on the loop thread) frees every unreferenced page.
            cached = rt.alloc.cached_pages
            assert cached > 0 and eng.prefix_cache_flush() == cached
            assert rt.alloc.cached_pages == 0
        assert rt.alloc.used_pages == 0
    finally:
        eng.stop()
    assert items[-1].kind == "done", items[-1].error
    assert _ids(base) and _ids(items) == _ids(base) == _ids(want)
    assert "".join(i.text for i in items) == "".join(i.text for i in base)


def test_kv_exhausted_explicit_when_preemption_disabled():
    """tests/test_degradation.py:153: with preemption off a failed growth
    ends the stream with the distinct kv_exhausted reason, never a
    silent LENGTH."""
    plan = FaultPlan([{"site": "extend", "kind": "alloc_fail", "at": [3]}])
    eng = _engine(plan, preempt=False)
    try:
        items = collect(_run(eng, "u"))
        assert eng.runtimes["test-tiny"].alloc.used_pages == 0
    finally:
        eng.stop()
    assert items[-1].kind == "error"
    assert items[-1].finish_reason == FinishReason.KV_EXHAUSTED
    assert "exhausted" in items[-1].error


def test_injected_ragged_fault_retries_and_succeeds():
    """tests/test_degradation.py:304: the first ragged dispatch raises;
    its request is retried once and streams what an unfaulted run
    streams."""
    eng = _engine()
    try:
        clean = collect(_run(eng, "u"))
    finally:
        eng.stop()
    plan = FaultPlan([{"site": "ragged", "kind": "exception", "at": [1]}])
    eng = _engine(plan)
    try:
        req = _run(eng, "u")
        items = collect(req)
        assert req.retries == 1
        assert eng.runtimes["test-tiny"].retry_count == 1 == eng.retry_count()
        assert plan.stats()["injected"] == 1
    finally:
        eng.stop()
    assert items[-1].kind == "done", items[-1].error
    assert _ids(items) == _ids(clean)


def test_repeated_fault_poisons_engine_keeps_serving():
    """tests/test_degradation.py:326: two consecutive ragged faults spend
    the retry budget; the request is poisoned with an explicit error and
    the next user is served."""
    plan = FaultPlan([{"site": "ragged", "kind": "exception", "at": [1, 2]}])
    eng = _engine(plan)
    try:
        poisoned = collect(_run(eng, "bad"), timeout=60)
        assert poisoned[-1].kind == "error"
        assert "poisoned" in poisoned[-1].error
        survivor = collect(_run(eng, "good"))
        assert survivor[-1].kind == "done", survivor[-1].error
        assert _ids(survivor)
        snap = eng.core.snapshot()
        assert snap["users"]["bad"]["dropped"] == 1
        assert snap["users"]["good"]["processed"] == 1
        assert sum(u["processing"] for u in snap["users"].values()) == 0
    finally:
        eng.stop()


def test_decode_failure_rebuilds_runtime():
    """tests/test_chaos.py:118: a failed decode dispatch kills the
    runtime; its request is retried (not errored), a request enqueued
    while the runtime is down waits in the queue, the engine rebuilds the
    runtime with the same weights, and both finish."""
    plan = FaultPlan([{"site": "decode", "kind": "exception", "at": [1]}])
    eng = _engine(plan, max_slots=4, max_new_tokens=8)
    eng.recover_interval = 0.2
    try:
        rt = eng.runtimes["test-tiny"]
        victim = _run(eng, "victim", "hello", max_tokens=4)
        deadline = time.monotonic() + 60
        while not rt._failed and time.monotonic() < deadline:
            time.sleep(0.02)
        assert rt._failed and not rt.has_capacity()
        assert victim.retries == 1
        survivor = _run(eng, "survivor", "hello", max_tokens=4)
        deadline = time.monotonic() + 60
        while eng.runtimes["test-tiny"] is rt and time.monotonic() < deadline:
            time.sleep(0.02)
        fresh = eng.runtimes["test-tiny"]
        assert fresh is not rt, "runtime never rebuilt"
        for req in (victim, survivor):
            items = collect(req, timeout=60)
            assert items[-1].kind == "done", items[-1].error
            assert len(req.generated_ids) == 4
        # The rebuild kept the weights: the replayed victim streams what
        # the survivor (same prompt, never faulted) streams.
        assert victim.generated_ids == survivor.generated_ids
        snap = eng.core.snapshot()
        assert snap["users"]["victim"]["processed"] == 1
        assert snap["users"]["victim"].get("dropped", 0) == 0
        assert snap["users"]["survivor"]["processed"] == 1
        assert sum(u["processing"] for u in snap["users"].values()) == 0
        assert fresh.alloc.used_pages == 0
    finally:
        eng.stop()
