"""Speculative decoding of the port against the JAX package's, on the CPU.

- accept_prefix (ollamamq_tpu_torch/ops/sampling.py) answers as the JAX
  function does on seeded random drafts, and PageAllocator.rollback_to
  frees exactly the rejected tail's pages, never below the shared floor;
- the n-gram proposer gives the JAX runtime's drafts;
- the port's runtime with spec on is driven in lockstep with the JAX
  runtime (test-tiny, float32, weights bridged; the lockstep driver of
  test_torch_prefix_cache.py): every tick makes the same dispatch, the
  same page decisions (free and cached pages, preemptions, prefix-cache
  stats, spec_proposed / spec_accepted / spec_rollbacks) and the same
  tokens. That holds in the chaotic and the copy-map regime
  (tests/test_spec_decoding.py:226), with the prefix cache (:254), and
  under page pressure that preempts slots while they speculate (:284);
- the greedy streams with spec on equal those with spec off, the penalty
  rings end alike, and so does an int8 runtime's
  (tests/test_quantization.py:255).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.engine.kv_cache import PageAllocator as JaxAllocator
from ollamamq_tpu.engine.request import Request as JaxRequest
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu.ops.sampling import accept_prefix as jax_accept_prefix
from ollamamq_tpu_torch.core.mqcore import MQCore
from ollamamq_tpu_torch.engine.kv_cache import PageAllocator
from ollamamq_tpu_torch.engine.request import Request
from ollamamq_tpu_torch.ops.sampling import SamplingParams, accept_prefix

from test_torch_prefix_cache import PS, drive, jax_runtime, lockstep, torch_runtime

# tests/test_spec_decoding.py's runtime.
SPEC = dict(num_pages=256, max_pages_per_seq=32, max_new_tokens=96,
            max_batch_tokens=64, token_granule=8, spec_k=4, spec_min_accept=0.0)
_IDS = itertools.count(1)


def _mixed_prompts(rng, n):
    """Half repeated patterns (the lookup can match), half random, lengths
    straddling the page and budget boundaries."""
    out = []
    for i in range(n):
        if i % 2 == 0:
            pat = rng.integers(3, 500, size=int(rng.integers(3, 8))).tolist()
            L = int(rng.integers(12, 60))
            out.append((pat * (L // len(pat) + 1))[:L])
        else:
            out.append(rng.integers(3, 500, size=int(rng.integers(4, 60))).tolist())
    return out


def _serve(rt, prompts, max_tokens):
    streams, _ = drive(rt, MQCore(None), lambda rid, u, p: Request(
        rid, u, "test-tiny", p, SamplingParams(max_tokens=max_tokens)), prompts)
    return streams


# -- units -------------------------------------------------------------------
def test_accept_prefix_matches_jax():
    """The cases of tests/test_spec_decoding.py:111-137 plus seeded random
    drafts over a small alphabet (many partial matches)."""
    rng = np.random.default_rng(3)
    cases = [
        (np.array([[5, 6, 7, 8]] * 4), np.array([[5, 6, 7, 8], [9, 6, 7, 8],
                                                 [5, 6, 9, 8], [5, 6, 7, 8]]),
         np.array([4, 4, 4, 2]), [4, 0, 2, 2]),
        (np.zeros((3, 0)), np.zeros((3, 0)), np.zeros(3), [0, 0, 0]),
        (np.array([[1, 2, 3, 4]]), np.array([[1, 9, 3, 4]]), np.array([4]), [1]),
    ]
    for _ in range(20):
        B, K = int(rng.integers(1, 9)), int(rng.integers(1, 6))
        cases.append((rng.integers(0, 3, size=(B, K)), rng.integers(0, 3, size=(B, K)),
                      rng.integers(-1, K + 1, size=B), None))
    for draft, greedy, dlen, want in cases:
        args = [np.asarray(a, np.int32) for a in (draft, greedy, dlen)]
        ref = np.asarray(jax_accept_prefix(*(jnp.asarray(a) for a in args)))
        got = accept_prefix(*(torch.from_numpy(a) for a in args)).numpy()
        assert got.dtype == np.int32
        assert got.tolist() == ref.tolist()
        if want is not None:
            assert got.tolist() == want


def test_rollback_to_conserves_pages_and_keeps_the_shared_floor():
    """tests/test_spec_decoding.py:145-165 on both allocators, op for op."""
    a, b = JaxAllocator(32, 8, 16), PageAllocator(32, 8, 16)
    pa, pb = a.alloc(40), b.alloc(40)
    assert pa == pb and len(pb) == 5
    assert a.rollback_to(pa, 18) == b.rollback_to(pb, 18) == 2
    assert pa == pb and len(pb) == 3
    assert b.rollback_to(pb, 24) == 0  # already tight
    qa, qb = a.alloc(32), b.alloc(32)
    # The first 3 pages are shared prefix pages: a kv_len of 1 keeps them.
    assert a.rollback_to(qa, 1, keep=3) == b.rollback_to(qb, 1, keep=3) == 1
    assert qa == qb and len(qb) == 3
    rng = np.random.default_rng(13)
    a, b = JaxAllocator(64, 8, 32), PageAllocator(64, 8, 32)
    live = []
    for _ in range(300):
        op = rng.random()
        if op < 0.45 or not live:
            n = int(rng.integers(1, 80))
            pa, pb = a.alloc(n), b.alloc(n)
            assert pa == pb
            if pb is not None:
                live.append([pa, pb, n])
        elif op < 0.8:
            e = live[int(rng.integers(len(live)))]
            new_len = int(rng.integers(1, e[2] + 1))
            assert a.rollback_to(e[0], new_len) == b.rollback_to(e[1], new_len)
            e[2] = new_len
        else:
            pa, pb, _ = live.pop(int(rng.integers(len(live))))
            a.free(pa)
            b.free(pb)
        assert b.free_pages + b.used_pages + b.cached_pages == b.num_pages - 1
        assert (a.free_pages, a.used_pages) == (b.free_pages, b.used_pages)
    for _, pb, _ in live:
        b.free(pb)
    assert b.used_pages == 0


def test_proposer_drafts_match_jax():
    """tests/test_spec_decoding.py:193-207 and seeded random contexts:
    the same drafts, budget and context caps included."""
    jrt = jax_runtime(spec=True, **SPEC)
    trt = torch_runtime(jrt, spec=True, **SPEC)
    rng = np.random.default_rng(5)
    pat = [11, 22, 33, 44, 55]
    ctxs = [((pat * 6)[:28], [], 32), ([7, 8, 9] * 5, [100, 101], 3),
            (list(range(3, 40)), [], 32)]
    for _ in range(30):
        p = rng.integers(3, 9, size=int(rng.integers(2, 40))).tolist()
        g = rng.integers(3, 9, size=int(rng.integers(0, 10))).tolist()
        ctxs.append((p, g, int(rng.integers(1, 12))))
    for prompt, gen, max_tokens in ctxs:
        drafts = []
        for rt, R, SP in ((jrt, JaxRequest, JaxSampling), (trt, Request, SamplingParams)):
            req = R(next(_IDS), "u", "test-tiny", prompt, SP(max_tokens=max_tokens))
            req.generated_ids = list(gen)
            rt.slot_req[0] = req
            rt.seq_lens[0] = len(prompt) + len(gen) - 1
            drafts.append(rt._propose_drafts(req, 0))
            rt.slot_req[0] = None
        assert drafts[1] == drafts[0], (prompt, gen, max_tokens)
    req = Request(next(_IDS), "u", "test-tiny", (pat * 6)[:28], SamplingParams(max_tokens=32))
    trt.slot_req[0], trt.seq_lens[0] = req, 28
    assert trt._propose_drafts(req, 0) == (pat * 7)[28:32]
    trt.slot_req[0] = None


# -- the runtime in lockstep with JAX ------------------------------------------
@pytest.mark.parametrize("regime", ["chaotic", "copy"])
def test_spec_runtime_matches_jax_and_spec_off(regime):
    """tests/test_spec_decoding.py:226: four mixed prompts (at most
    max_slots, so slot assignment does not depend on finish order)."""
    copy = regime == "copy"
    prompts = _mixed_prompts(np.random.default_rng(17), 4)
    jrt = jax_runtime(copy_map=copy, spec=True, **SPEC)
    trt = torch_runtime(jrt, spec=True, **SPEC)
    on = lockstep(jrt, trt, prompts, max_tokens=48)
    off_rt = torch_runtime(jrt, **SPEC)
    assert _serve(off_rt, prompts, 48) == on
    # The ring advances by the accepted count: the rings end alike.
    S = trt.ecfg.max_slots
    assert torch.equal(off_rt.recent[:S], trt.recent[:S])
    assert trt.alloc.used_pages == 0
    assert trt.spec_proposed > 0
    # Copy-map drafts verify; chaotic ones are rejected and roll back.
    assert (trt.spec_accepted if copy else trt.spec_rollbacks) > 0


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["cache-off", "cache-on"])
def test_spec_with_prefix_cache_matches_jax(prefix_cache):
    """tests/test_spec_decoding.py:254: a 3-page shared prefix; the second
    and third prompt arrive after the first has finished, so with the
    cache on they are hits whose spans start at a page boundary."""
    rng = np.random.default_rng(23)
    shared = rng.integers(3, 500, size=3 * PS).tolist()
    prompts = [shared + rng.integers(3, 500, size=t).tolist() for t in (5, 17, 30)]
    arrivals = [0, 40, 41]
    kw = dict(SPEC, prefix_cache=prefix_cache)
    jrt = jax_runtime(copy_map=True, spec=True, **kw)
    trt = torch_runtime(jrt, spec=True, **kw)
    on = lockstep(jrt, trt, prompts, arrivals, max_tokens=48)
    off, _ = drive(torch_runtime(jrt, **kw), MQCore(None), lambda rid, u, p: Request(
        rid, u, "test-tiny", p, SamplingParams(max_tokens=48)), prompts, arrivals)
    assert off == on
    assert trt.alloc.used_pages == 0 and trt.spec_accepted > 0
    if prefix_cache:
        assert trt.prefix_cache.hits == 2


def test_preemption_during_speculation_matches_jax():
    """tests/test_spec_decoding.py:284 with the prefix cache on: a 19-page
    pool makes decode-time growth fail while slots speculate, so victims
    are preempted, their written pages enter the tree, and their replays
    hit it. Random weights, so drafts of the repeated prompts are both
    accepted and rejected (rolled back). Per tick the two runtimes
    preempt, roll back, hit and free alike; the streams equal an
    unpressured spec-off run's."""
    prompts = _mixed_prompts(np.random.default_rng(31), 4)
    kw = dict(SPEC, num_pages=20, retry_backoff_s=0.0, prefix_cache=True)
    jrt = jax_runtime(spec=True, **kw)
    trt = torch_runtime(jrt, spec=True, **kw)
    pressured = lockstep(jrt, trt, prompts, max_ticks=8000, max_tokens=32)
    assert trt.preempt_count > 0, "pool never pressured: test is vacuous"
    assert trt.spec_accepted > 0 and trt.spec_rollbacks > 0
    assert trt.prefix_cache.hits > 0
    assert trt.alloc.used_pages == 0
    trt.prefix_cache.check()
    baseline = _serve(torch_runtime(jrt, **SPEC), prompts, 32)
    assert pressured == baseline


def test_spec_identity_on_int8_runtime():
    """tests/test_quantization.py:255: drafts verify with the same int8
    forward and int8 KV writes as the one-token path, so spec on equals
    spec off on an int8 runtime, in lockstep with the JAX int8 runtime."""
    rng = np.random.default_rng(7)
    cyc = rng.integers(3, 400, size=5).tolist()
    prompts = [(cyc * 10)[:40], (cyc * 5)[:24]]
    kw = dict(weights_dtype="int8", kv_dtype="int8", spec_k=3, spec_min_accept=0.0)
    jrt = jax_runtime(copy_map=True, spec=True, **kw)
    trt = torch_runtime(jrt, spec=True, **kw)
    spec = lockstep(jrt, trt, prompts, max_tokens=40)
    assert trt.spec_proposed > 0 and trt.spec_accepted > 0
    assert _serve(torch_runtime(jrt, **kw), prompts, 40) == spec
