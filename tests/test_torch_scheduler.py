"""The port's scheduling policies against the JAX package's, on the CPU.

1. The policy classes (the output-length predictor, aging, score,
   remaining work, victim_key and the three orderings) give the same
   outputs on the same inputs under fcfs, srpt and edf.
2. The port's ModelRuntime and the JAX ModelRuntime run in lockstep
   under srpt and edf (test-tiny, float32, bridged weights, the ragged
   path; the lockstep harness of test_torch_prefix_cache.py): requests with mixed
   max_tokens, some deadlines, staggered arrivals and a pool small
   enough that victims are picked. Every tick's dispatch, slot
   occupancy, pending and packing order, page decisions and tokens are
   identical, and so is the predictor's final state.
3. TorchEngine and TPUEngine admit the same burst in the same order
   under srpt, with the loops driven by hand (each engine's _admit,
   never started).
"""

import collections
import itertools
import random

import jax.numpy as jnp
import pytest
import torch

from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.core import MQCore as JaxMQCore
from ollamamq_tpu.engine.engine import TPUEngine
from ollamamq_tpu.engine.request import Request as JaxRequest
from ollamamq_tpu.engine.scheduler import AGING_TICKS as JAX_AGING_TICKS
from ollamamq_tpu.engine.scheduler import make_policy as jax_make_policy
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu_torch.config import SCHEDULERS, EngineConfig, validate_scheduler
from ollamamq_tpu_torch.core.mqcore import MQCore
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.engine.request import Request
from ollamamq_tpu_torch.engine.scheduler import AGING_TICKS, make_policy
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from test_torch_prefix_cache import counters, jax_runtime, tick, torch_runtime

_IDS = itertools.count(1)
POLICIES = ("fcfs", "srpt", "edf")


def _pair(i, user, n_prompt, max_tokens, deadline):
    """The same request in both packages, with the same arrival time and
    deadline instant."""
    j = JaxRequest(next(_IDS), user, "test-tiny", [1 + i % 7] * n_prompt,
                   JaxSampling(max_tokens=max_tokens))
    t = Request(j.req_id, user, "test-tiny", [1 + i % 7] * n_prompt,
                SamplingParams(max_tokens=max_tokens))
    t.stats.enqueued_at = j.stats.enqueued_at
    j.deadline = t.deadline = deadline
    j._i = t._i = i
    return j, t


def test_validation_matches_jax():
    assert SCHEDULERS == ("fcfs", "srpt", "edf") and AGING_TICKS == JAX_AGING_TICKS
    for name in SCHEDULERS:
        assert validate_scheduler(name) is None
    assert "fcfs" in validate_scheduler("sjf")
    with pytest.raises(ValueError, match="sjf"):
        make_policy(EngineConfig(scheduler="sjf"))


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_decisions_match_jax(policy):
    """A seeded stream of requests, finishes, admission ticks, windows,
    pending queues, packing lists and victim picks through both
    packages' policy objects."""
    rng = random.Random(3)
    jp = jax_make_policy(JaxEngineConfig(scheduler=policy))
    tp = make_policy(EngineConfig(scheduler=policy))
    assert (tp.name, tp.admission_window) == (jp.name, jp.admission_window)
    live = []
    for step in range(400):
        op = rng.random()
        if op < 0.3 or len(live) < 4:
            deadline = (1e6 + rng.random() * 1e3) if rng.random() < 0.4 else None
            live.append(_pair(step, f"u{rng.randrange(4)}", rng.randrange(1, 90),
                              rng.randrange(1, 200), deadline))
        elif op < 0.45:
            j, t = live.pop(rng.randrange(len(live)))
            n = rng.randrange(0, 200)
            j.generated_ids = t.generated_ids = [5] * n
            jp.observe_finish(j, model="test-tiny")
            tp.observe_finish(t, model="test-tiny")
        elif op < 0.55:
            jp.on_admit_tick()
            tp.on_admit_tick()
        elif op < 0.65:
            # Progress on a live request: prefilled span and tokens.
            j, t = rng.choice(live)
            j._chunk_pos = t._chunk_pos = rng.randrange(0, len(j.prompt_tokens) + 1)
            j.generated_ids = t.generated_ids = [5] * rng.randrange(0, 50)
        else:
            picks = rng.sample(live, min(len(live), rng.randint(1, 8)))
            jw = jp.order_admission([(p[0]._i, "u", "m", p[0]) for p in picks])
            tw = tp.order_admission([(p[1]._i, "u", "m", p[1]) for p in picks])
            assert [x[0] for x in tw] == [x[0] for x in jw], step
            jq = collections.deque(p[0] for p in picks)
            tq = collections.deque(p[1] for p in picks)
            jp.reorder_pending(jq)
            tp.reorder_pending(tq)
            assert [r._i for r in tq] == [r._i for r in jq], step
            assert ([r._i for r in tp.pack_order(tq)]
                    == [r._i for r in jp.pack_order(jq)]), step
            served = rng.randrange(5)
            for j, t in picks:
                assert tp.victim_key(t, served) == jp.victim_key(j, served), step
                assert tp.score(t) == jp.score(j), step
                assert tp.remaining(t) == jp.remaining(j), step
                assert tp.predict(t) == jp.predict(j), step
    assert tp.decisions == jp.decisions
    assert tp.predictor.accuracy() == jp.predictor.accuracy()
    assert tp.predictor.observed == jp.predictor.observed > 20


# -- runtime lockstep -----------------------------------------------------------
# (prompt length, max_tokens, deadline offset in ms or 0): mixed lengths;
# deadlines far apart and far away, so they order edf but never expire.
JOBS = [(20, 30, 0), (6, 4, 3e6), (14, 24, 0), (9, 6, 1e6), (30, 18, 2e6),
        (5, 3, 0), (12, 28, 4e6), (7, 5, 0), (16, 12, 5e6), (8, 9, 0)]
ARRIVALS = [0, 0, 0, 1, 1, 3, 5, 6, 9, 12]
# A pool too small for the decode growth of the live set: victims are
# picked (13 usable pages; a request grows to up to 7 pages of 8 tokens).
SMALL_POOL = dict(num_pages=14, max_pages_per_seq=8)


def _sched_drive(rt, core, make_req, max_ticks=3000):
    """Submit JOBS[i] at tick ARRIVALS[i]; tick until all finish. Each
    tick records the dispatch, the page counters, which request holds
    each slot, the pending and chunking orders, and the streams.
    Preempted requests return to the front of the pending queue."""
    rt.on_preempt = lambda req: (rt.pending_prefill.appendleft(req), True)[1]
    reqs, trace = [None] * len(JOBS), []

    def who(seq):
        return [None if r is None else r._i for r in seq]

    for t in range(max_ticks):
        for i, (n, max_tokens, dl) in enumerate(JOBS):
            if ARRIVALS[i] == t:
                req = make_req(i, n, max_tokens)
                if dl:
                    req.deadline = 1e9 + dl / 1e3  # the same instant in both
                req._i = i
                req._inc_decode = rt.tokenizer.make_incremental_decoder()
                rt.pending_prefill.append(req)
                reqs[i] = req
        if t >= max(ARRIVALS) and all(r.stats.finished_at for r in reqs):
            break
        kind = tick(rt, core)
        trace.append((kind, counters(rt), who(rt.slot_req), who(rt.pending_prefill),
                      who(rt.chunking),
                      [list(r.generated_ids) if r else None for r in reqs]))
    assert all(r.stats.finished_at for r in reqs), "requests wedged"
    return [list(r.generated_ids) for r in reqs], trace


@pytest.mark.parametrize("policy", ["srpt", "edf"])
def test_runtime_lockstep_under_policy(policy):
    jrt = jax_runtime(**SMALL_POOL)
    trt = torch_runtime(jrt, **SMALL_POOL)
    jrt.policy = jax_make_policy(JaxEngineConfig(scheduler=policy))
    trt.policy = make_policy(EngineConfig(scheduler=policy))

    def jreq(i, n, max_tokens):
        return JaxRequest(next(_IDS), f"u{i % 3}", "test-tiny",
                          [3 + (i * 5 + k) % 400 for k in range(n)],
                          JaxSampling(temperature=0.0, max_tokens=max_tokens))

    def treq(i, n, max_tokens):
        return Request(next(_IDS), f"u{i % 3}", "test-tiny",
                       [3 + (i * 5 + k) % 400 for k in range(n)],
                       SamplingParams(temperature=0.0, max_tokens=max_tokens))

    want, jtrace = _sched_drive(jrt, JaxMQCore(None), jreq)
    got, ttrace = _sched_drive(trt, MQCore(None), treq)
    assert len(ttrace) == len(jtrace)
    for t, (j, g) in enumerate(zip(jtrace, ttrace)):
        assert g == j, f"tick {t}: port {g} != jax {j}"
    assert got == want
    assert [len(ids) for ids in got] == [m for _, m, _ in JOBS]
    assert trt.preempt_count >= 1  # victims were really picked
    jpred, tpred = jrt.policy.predictor, trt.policy.predictor
    assert (tpred._user, tpred._global, tpred._ratio, tpred.observed) == \
        (jpred._user, jpred._global, jpred._ratio, jpred.observed)
    assert trt.policy.decisions == jrt.policy.decisions


# -- engine admission -------------------------------------------------------------
ENGINE = dict(model="test-tiny", max_slots=4, num_pages=64, page_size=8,
              max_pages_per_seq=16, scheduler="srpt")


def test_engine_admits_burst_in_jax_order():
    """The whole TPUEngine is practical on the CPU here: both engines are
    built but never started, a burst of 9 requests from 5 users with
    mixed max_tokens is enqueued into each, and each engine's _admit runs
    by hand. The srpt window (8) is placed in the same order, and so are
    the leftovers of a second pass after the runtimes drain."""
    jeng = TPUEngine(JaxEngineConfig(prefill_buckets=(16, 32), **ENGINE),
                     models={"test-tiny": None}, blocklist_path=None,
                     dtype=jnp.float32)
    teng = TorchEngine(EngineConfig(**ENGINE), device="cpu", dtype=torch.float32)
    burst = [(f"u{i % 5}", 4 + (i * 7) % 23) for i in range(9)]
    orders = []
    for eng, sp in ((jeng, JaxSampling), (teng, SamplingParams)):
        tok = eng.runtimes["test-tiny"].tokenizer
        for user, max_tokens in burst:
            eng.enqueue_request(user, "", "test-tiny",
                                prompt_tokens=tok.encode(f"{user} asks {max_tokens}"),
                                sampling=sp(max_tokens=max_tokens))
        rt = eng.runtimes["test-tiny"]
        placed = []
        for _ in range(2):
            eng._admit()
            placed.append([(r.user, r.sampling.max_tokens) for r in rt.pending_prefill])
            rt.pending_prefill.clear()
        orders.append((placed, eng.core.total_queued(), eng.policy.decisions))
    jeng.stop()
    teng.stop()
    assert orders[1] == orders[0]
    placed, queued, decisions = orders[1]
    assert [len(p) for p in placed] == [8, 1] and queued == 0
    assert decisions >= 1  # srpt really reordered the window
