"""The prefix cache of the port against the JAX package's, on the CPU.

- The radix tree and the allocator (ollamamq_tpu_torch/engine/
  prefix_cache.py, kv_cache.py) run the same seeded random sequence of
  match / pin / insert / evict / rollback / free operations as the JAX
  package's and give the same answers and page counts at every step.
- The port's ModelRuntime with the cache on is driven in lockstep with
  the JAX ModelRuntime (test-tiny, float32, weights bridged, the ragged
  path): per tick the prefix-cache stats and the free and cached page
  counts agree, and the greedy streams are identical (argmax over
  float32 logits that agree within 1e-4; see test_torch_model.py), with
  repeat_penalty 1.0 and 1.1 (the penalty ring opens from the cached
  prefix's last tokens). They also equal the cache-off streams.
- A request cancelled mid-prefill with its prefix pinned leaks nothing,
  and a full cache evicts instead of failing admission.

The lockstep driver here is shared by test_torch_spec.py and
test_torch_degradation.py.
"""

import dataclasses
import itertools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import MODEL_CONFIGS as JAX_CONFIGS
from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.core import MQCore as JaxMQCore
from ollamamq_tpu.engine.engine import ModelRuntime as JaxRuntime
from ollamamq_tpu.engine.kv_cache import PageAllocator as JaxAllocator
from ollamamq_tpu.engine.prefix_cache import PrefixCache as JaxPrefixCache
from ollamamq_tpu.engine.request import Request as JaxRequest
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu_torch.config import EngineConfig, ModelConfig
from ollamamq_tpu_torch.core.mqcore import MQCore
from ollamamq_tpu_torch.engine.engine import ModelRuntime
from ollamamq_tpu_torch.engine.kv_cache import PageAllocator
from ollamamq_tpu_torch.engine.prefix_cache import PrefixCache
from ollamamq_tpu_torch.engine.request import Request
from ollamamq_tpu_torch.models.weights import from_jax_numpy
from ollamamq_tpu_torch.ops.sampling import SamplingParams

PS = 8
# tests/test_prefix_cache.py's runtime, on the ragged path (token budget
# 48, granule 8, as in test_torch_engine.py).
BASE = dict(model="test-tiny", max_slots=4, num_pages=96, page_size=PS,
            max_pages_per_seq=16, max_new_tokens=8, decode_steps_per_iter=2,
            max_batch_tokens=48, token_granule=8)
_IDS = itertools.count(1)


# -- shared lockstep driver ---------------------------------------------------
def jax_runtime(copy_map=False, cfg=None, **kw):
    """A JAX ModelRuntime (float32, EOS off) of the JAX ModelConfig `cfg`
    (test-tiny by default). copy_map zeroes the residual output
    projections (tests/test_spec_decoding.py's trick: greedy generation
    cycles, so n-gram drafts verify)."""
    cfg = cfg or JAX_CONFIGS["test-tiny"]
    rt = JaxRuntime(cfg.name, cfg,
                    JaxEngineConfig(prefill_buckets=(16, 64),
                                    **{**BASE, "model": cfg.name, **kw}),
                    dtype=jnp.float32)
    rt.tokenizer.eos_id = -1
    if copy_map:
        for key in ("wo", "w_down", "we_down"):
            if key in rt.params["layers"]:
                rt.params["layers"][key] = jax.tree_util.tree_map(
                    jnp.zeros_like, rt.params["layers"][key])
    return rt


def torch_runtime(jrt, **kw):
    """The port's ModelRuntime with the same settings, model config and
    weights as jrt."""
    pnp = jax.tree_util.tree_map(np.asarray, jrt.params)
    cfg = ModelConfig(**dataclasses.asdict(jrt.cfg))
    rt = ModelRuntime(cfg.name, cfg,
                      EngineConfig(**{**BASE, "model": cfg.name, **kw}),
                      device="cpu", dtype=torch.float32,
                      params=from_jax_numpy(pnp, cfg))
    rt.tokenizer.eos_id = -1
    return rt


def counters(rt) -> dict:
    """The page decisions a tick made, comparable across the packages."""
    a = rt.alloc
    return {"free": a.free_pages, "cached": a.cached_pages,
            "used": a.used_pages, "preempt": rt.preempt_count,
            "retries": rt.retry_count, "spec": (rt.spec_proposed,
                                                rt.spec_accepted,
                                                rt.spec_rollbacks),
            "prefix_cache": (rt.prefix_cache.stats()
                             if rt.prefix_cache is not None else None),
            "stalled": sorted(rt._stalled_slots)}


def tick(rt, core) -> str:
    """One engine-loop-shaped tick: a mixed or verify dispatch, else one
    decode step."""
    if rt.step_ragged(core):
        return "ragged"
    if any(r is not None for r in rt.slot_req):
        rt.step_decode(core, k_steps=1)
        return "decode"
    return "idle"


def drive(rt, core, make_req, prompts, arrivals=None, max_ticks=3000,
          requeue=True):
    """Submit prompt i at tick arrivals[i] (all at 0 by default) and tick
    until every request finishes. Preempted requests return to the front
    of the pending queue. Returns (streams, per-tick trace)."""
    if requeue:
        rt.on_preempt = lambda req: (rt.pending_prefill.appendleft(req), True)[1]
    arrivals = arrivals or [0] * len(prompts)
    reqs, trace = [None] * len(prompts), []
    for t in range(max_ticks):
        for i, p in enumerate(prompts):
            if arrivals[i] == t:
                req = make_req(next(_IDS), f"u{i % 3}", list(p))
                req._inc_decode = rt.tokenizer.make_incremental_decoder()
                rt.pending_prefill.append(req)
                reqs[i] = req
        if t >= max(arrivals) and all(r.stats.finished_at for r in reqs):
            break
        trace.append((tick(rt, core), counters(rt),
                      [list(r.generated_ids) if r else None for r in reqs]))
    assert all(r.stats.finished_at for r in reqs), "requests wedged"
    return [list(r.generated_ids) for r in reqs], trace


def lockstep(jrt, trt, prompts, arrivals=None, max_ticks=3000, **sampling):
    """Drive both runtimes through the same ticks; assert that every tick
    made the same dispatch, the same page decisions and the same tokens.
    Returns the port's streams."""
    def jreq(rid, user, p):
        return JaxRequest(rid, user, jrt.name, p, JaxSampling(**sampling))

    def treq(rid, user, p):
        return Request(rid, user, trt.name, p, SamplingParams(**sampling))

    want, jtrace = drive(jrt, JaxMQCore(None), jreq, prompts, arrivals, max_ticks)
    got, ttrace = drive(trt, MQCore(None), treq, prompts, arrivals, max_ticks)
    assert len(ttrace) == len(jtrace)
    for t, (j, g) in enumerate(zip(jtrace, ttrace)):
        assert g == j, f"tick {t}: port {g} != jax {j}"
    assert got == want
    return got


def pool_invariant(rt) -> None:
    a = rt.alloc
    assert a.free_pages + a.used_pages + a.cached_pages == a.num_pages - 1
    assert a.used_pages >= 0
    if rt.prefix_cache is not None:
        rt.prefix_cache.check()


# -- the radix tree and the allocator ------------------------------------------
def test_tree_and_allocator_match_jax_on_random_ops():
    """Both packages' tree + allocator run one seeded op sequence
    (tests/test_prefix_cache.py's fuzz alphabet: few distinct blocks, so
    prefixes share heavily) and answer alike after every op."""
    rng = random.Random(0)
    ps, num_pages = 4, 48
    sides = []
    for Alloc, Cache in ((JaxAllocator, JaxPrefixCache), (PageAllocator, PrefixCache)):
        alloc = Alloc(num_pages=num_pages, page_size=ps, max_pages_per_seq=10)
        sides.append({"alloc": alloc, "pc": Cache(ps, alloc, model="fuzz"), "live": []})

    def admit(side, tokens):
        pc, alloc = side["pc"], side["alloc"]
        nodes, shared = pc.match(tokens)
        pc.pin(nodes)
        need = alloc.pages_needed(len(tokens) + 1) - len(nodes)
        tail = alloc.alloc_n(need, held=len(nodes))
        if tail is None:
            short = need - alloc.free_pages
            if short > 0 and pc.evict(short) > 0:
                tail = alloc.alloc_n(need, held=len(nodes))
        if tail is None:
            pc.release(nodes)
            return ("full", len(shared))
        side["live"].append({"tokens": tokens, "nodes": nodes,
                             "pages": list(shared) + tail, "shared": len(nodes)})
        return ("admitted", list(shared), tail)

    def retire(side, i, insert):
        pc, alloc = side["pc"], side["alloc"]
        e = side["live"].pop(i)
        keep, adopted = e["shared"], 0
        if insert:  # the engine's _release_slot_pages for a finished slot
            full = min(len(e["tokens"]) // ps, len(e["pages"]))
            if full > keep:
                adopted = pc.insert(e["tokens"], e["pages"][:full])
                keep = full
        alloc.free(e["pages"][keep:])
        pc.release(e["nodes"])
        return adopted

    for step in range(500):
        op = rng.choice(("admit", "finish", "cancel", "evict", "extend",
                         "rollback", "flush"))
        n_live = len(sides[0]["live"])
        if op == "admit":
            n = rng.randrange(ps, 9 * ps)
            tokens = [t for _ in range(-(-n // ps)) for t in [rng.randrange(3)] * ps][:n]
            args = (tokens,)
        elif op in ("finish", "cancel", "extend", "rollback") and n_live:
            i = rng.randrange(n_live)
            extra = rng.randrange(8)
            args = (i, extra)
        elif op == "evict":
            args = (rng.randrange(1, 4),)
        elif op == "flush" and rng.random() < 0.2:
            args = ()
        else:
            continue
        results = []
        for side in sides:
            pc, alloc = side["pc"], side["alloc"]
            if op == "admit":
                r = admit(side, *args)
            elif op in ("finish", "cancel"):
                r = retire(side, args[0], op == "finish")
            elif op == "extend":
                e = side["live"][args[0]]
                r = alloc.extend(e["pages"], len(e["pages"]) * ps + args[1])
            elif op == "rollback":
                e = side["live"][args[0]]
                r = alloc.rollback_to(e["pages"], max(1, args[1] * ps),
                                      keep=e["shared"])
            elif op == "evict":
                r = pc.evict(*args)
            else:
                r = pc.flush()
            pc.check()
            results.append((r, alloc.free_pages, alloc.used_pages,
                            alloc.cached_pages, sorted(alloc._free),
                            sorted(pc.pages()), pc.stats()))
        assert results[0] == results[1], f"step {step} ({op}): {results}"
    tree = sides[1]
    while tree["live"]:
        retire(tree, 0, True)
    tree["pc"].flush()
    a = tree["alloc"]
    assert a.free_pages + a.cached_pages == a.num_pages - 1


# -- runtime level ---------------------------------------------------------------
@pytest.mark.parametrize("repeat_penalty", [1.0, 1.1], ids=["greedy", "repeat-penalty"])
def test_cache_on_streams_and_pages_match_jax(repeat_penalty):
    """tests/test_prefix_cache.py:139 on the ragged path: misses, hits on
    a shared 4-page prefix, a hit whose longest match includes a private
    page, a prompt below any match, and a hit with a tail longer than
    the token budget. Arrivals are staggered so earlier prompts have
    finished (and been inserted) when later ones are admitted."""
    rng = np.random.RandomState(7)
    prefix = rng.randint(3, 500, size=4 * PS).tolist()  # 4 full pages
    tail_a = rng.randint(3, 500, size=7).tolist()
    prompts = [prefix + tail_a,
               prefix + rng.randint(3, 500, size=9).tolist(),
               prefix + tail_a,
               rng.randint(3, 500, size=5).tolist(),
               prefix + rng.randint(3, 500, size=80).tolist()]
    arrivals = [0, 12, 24, 26, 40]
    sampling = dict(max_tokens=6, repeat_penalty=repeat_penalty)
    jrt = jax_runtime(prefix_cache=True)
    trt = torch_runtime(jrt, prefix_cache=True)
    on = lockstep(jrt, trt, prompts, arrivals, **sampling)
    pc = trt.prefix_cache.stats()
    assert pc["hits"] >= 3 and pc["tokens_saved"] >= 3 * 4 * PS
    pool_invariant(trt)
    assert trt.alloc.used_pages == 0
    # Cache off: the same streams.
    off_rt = torch_runtime(jrt)
    off, _ = drive(off_rt, MQCore(None), lambda rid, u, p: Request(
        rid, u, "test-tiny", p, SamplingParams(**sampling)), prompts, arrivals)
    assert off == on


def test_cancel_mid_prefill_with_partially_cached_pages():
    """tests/test_prefix_cache.py:175: a hit whose 24-token tail needs two
    spans (token budget 16) is cancelled after the first; the pins are
    released, the tail's pages freed, nothing leaks into the tree, and
    the same prompt served afresh matches the cache-off stream."""
    kw = dict(max_batch_tokens=16, prefix_cache=True)
    jrt = jax_runtime(**kw)
    rt = torch_runtime(jrt, **kw)
    core = MQCore(None)
    rng = np.random.RandomState(13)
    base = rng.randint(3, 500, size=96).tolist()  # 12 full pages

    def serve(rt, prompt):
        streams, _ = drive(rt, core, lambda rid, u, p: Request(
            rid, u, "test-tiny", p, SamplingParams(max_tokens=4)), [prompt])
        return streams[0]

    serve(rt, base)
    pool_invariant(rt)
    assert rt.prefix_cache.cached_pages == 12
    victim = base + rng.randint(3, 500, size=24).tolist()
    req = Request(next(_IDS), "u", "test-tiny", victim, SamplingParams(max_tokens=4))
    req._inc_decode = rt.tokenizer.make_incremental_decoder()
    rt.pending_prefill.append(req)
    assert rt.step_ragged(core)  # hit: the first tail span ran
    assert rt.prefix_cache.hits == 1 and req in rt.chunking
    assert 12 * PS < req._chunk_pos < len(victim)
    assert rt.prefix_cache.stats()["pinned_pages"] == 12
    req.cancelled.set()
    assert not rt.step_ragged(core)  # reaped, nothing else to run
    assert req not in rt.chunking and not rt.reserved_slots
    pool_invariant(rt)
    assert rt.prefix_cache.cached_pages == 12
    assert rt.prefix_cache.stats()["pinned_pages"] == 0
    assert rt.alloc.used_pages == 0
    off = torch_runtime(jrt, max_batch_tokens=16)
    assert serve(rt, victim) == serve(off, victim)
    pool_invariant(rt)


def test_full_cache_evicts_instead_of_failing_admission():
    """tests/test_prefix_cache.py:218: two finished 48-token prompts leave
    12 pages in the tree of a 19-page pool; a 56-token prompt needs 8
    pages and is admitted by evicting."""
    kw = dict(num_pages=20, max_pages_per_seq=8, max_new_tokens=4, prefix_cache=True)
    rt = torch_runtime(jax_runtime(**kw), **kw)
    core = MQCore(None)
    rng = np.random.RandomState(3)

    def serve(prompt):
        streams, _ = drive(rt, core, lambda rid, u, p: Request(
            rid, u, "test-tiny", p, SamplingParams(max_tokens=2)), [prompt])
        return streams[0]

    for _ in range(2):
        serve(rng.randint(3, 500, size=48).tolist())
    pool_invariant(rt)
    assert rt.alloc.cached_pages == 12 and rt.alloc.free_pages < 8
    assert rt.has_capacity()  # evictable pages count as capacity
    assert len(serve(rng.randint(3, 500, size=56).tolist())) == 2
    assert rt.prefix_cache.evictions > 0
    pool_invariant(rt)
