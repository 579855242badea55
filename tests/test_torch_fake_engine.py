"""The port's FakeEngine against the JAX package's, on the CPU.

FakeEngine is TorchEngine with runtimes that run no model: the same
admission, fair-share, journaling and durability paths, deterministic
`word0 word1 ...` tokens, configurable latency, cancellation mid-stream
and fake embeddings. The mirror of the JAX package's fake-engine tests
(tests/test_engine.py:353-485), with the stream, embedding, stats and
journal held against the JAX FakeEngine's on the same inputs; the HTTP
surface served through it; and the device default: TorchEngine still
refuses to start without a GPU unless the CPU is asked for.
"""

import json
import time
import urllib.error
import urllib.request

import pytest
import torch

from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.engine.fake import FakeEngine as JaxFakeEngine
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu.telemetry.journal import decision_signature as jax_signature
from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.engine.fake import FakeEngine, FakeRuntime
from ollamamq_tpu_torch.engine.request import FinishReason
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
from ollamamq_tpu_torch.telemetry.journal import (check_invariants,
                                                  decision_signature)
from ollamamq_tpu_torch.testing.faults import FaultPlan
from testutil import collect

SMALL = dict(model="test-tiny", max_slots=4, num_pages=64, page_size=8,
             max_pages_per_seq=16, max_new_tokens=8, decode_steps_per_iter=4)


def _pair(latency=0.0, **over):
    """Started (port, JAX) fake engines on the same config."""
    engs = (FakeEngine(EngineConfig(**{**SMALL, **over}), blocklist_path=None,
                       token_latency_s=latency),
            JaxFakeEngine(JaxEngineConfig(**{**SMALL, **over}), blocklist_path=None,
                          token_latency_s=latency))
    for e in engs:
        e.start()
    return engs


def _both(engs, fn):
    try:
        return [fn(e, SamplingParams if isinstance(e, FakeEngine) else JaxSampling)
                for e in engs]
    finally:
        for e in engs:
            e.stop()


def _text(items):
    return "".join(i.text for i in items if i.kind == "token")


def test_stream_and_embed_match_jax():
    def run(eng, sp):
        tok = eng.runtimes["test-tiny"].tokenizer
        req = eng.enqueue_request("u", "", "test-tiny",
                                  prompt_tokens=tok.encode("hi"),
                                  sampling=sp(max_tokens=5))
        items = collect(req, timeout=10)
        emb = eng.enqueue_request("u", "", "test-tiny",
                                  prompt_tokens=tok.encode("embed me"),
                                  sampling=sp(), kind="embed")
        collect(emb, timeout=10)
        return (_text(items), list(req.generated_ids), items[-1].kind,
                emb.embedding)

    port, ref = _both(_pair(), run)
    assert port[0] == "word0 word1 word2 word3 word4 "
    assert port[:3] == ref[:3]
    assert port[3] == pytest.approx(ref[3], abs=1e-12)
    assert abs(sum(x * x for x in port[3]) - 1.0) < 1e-6


def test_stop_string():
    eng = FakeEngine(EngineConfig(**SMALL), blocklist_path=None)
    eng.start()
    try:
        tok = eng.runtimes["test-tiny"].tokenizer
        req = eng.enqueue_request("u", "", "test-tiny",
                                  prompt_tokens=tok.encode("hi"),
                                  sampling=SamplingParams(max_tokens=16,
                                                          stop=("word3",)))
        items = collect(req, timeout=10)
        assert _text(items) == "word0 word1 word2 "
        assert items[-1].finish_reason == FinishReason.STOP
    finally:
        eng.stop()


def test_vip_priority_through_engine():
    eng = FakeEngine(EngineConfig(**{**SMALL, "max_slots": 1}),
                     blocklist_path=None, token_latency_s=0.01)
    eng.start()
    try:
        eng.core.set_vip("vip")
        # Hold the loop so all four land in the queue before any is popped.
        reqs = eng.call_on_loop(lambda: [
            (u, eng.enqueue_request(u, "", "test-tiny", prompt_tokens=[3],
                                    sampling=SamplingParams(max_tokens=2)))
            for u in ("a", "b", "vip", "c")])
        for _u, r in reqs:
            collect(r, timeout=20)
        order = [u for u, r in sorted(reqs, key=lambda x: x[1].stats.first_token_at)]
        assert order[0] == "vip"
    finally:
        eng.stop()


def test_cancellation_mid_stream_and_latency():
    """A slow stream is cancelled mid-way: it ends `cancelled` with a
    journaled finish, the user's processing count returns to 0, and the
    tokens it did emit paced at the configured latency."""
    eng = FakeEngine(EngineConfig(**SMALL), blocklist_path=None,
                     token_latency_s=0.05)
    eng.start()
    try:
        t0 = time.monotonic()
        req = eng.enqueue_request("c", "", "test-tiny", prompt_tokens=[4, 5],
                                  sampling=SamplingParams(max_tokens=16))
        while len(req.generated_ids) < 3:
            time.sleep(0.005)
        assert time.monotonic() - t0 >= 3 * 0.05
        eng.cancel(req.req_id)
        items = collect(req, timeout=10)
        assert items[-1].finish_reason == FinishReason.CANCELLED
        assert 3 <= len(req.generated_ids) < 16
        fin = eng.journal.tail(req_id=req.req_id, kind="finish")
        assert [r["reason"] for r in fin] == ["cancelled"]
        deadline = time.monotonic() + 5
        while (eng.core.snapshot()["users"]["c"]["processing"]
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert eng.core.snapshot()["users"]["c"]["processing"] == 0
    finally:
        eng.stop()


def test_processing_gauge_not_corrupted_by_precancel():
    """tests/test_engine.py:451: dropping a never-started request does
    not decrement another request's processing count."""
    eng = FakeEngine(EngineConfig(**SMALL), blocklist_path=None,
                     token_latency_s=0.05)
    eng.start()
    try:
        r1 = eng.enqueue_request("g", "", "test-tiny", prompt_tokens=[3],
                                 sampling=SamplingParams(max_tokens=16))
        deadline = time.monotonic() + 10
        while not r1.stats.first_token_at and time.monotonic() < deadline:
            time.sleep(0.01)
        r2 = eng.call_on_loop(lambda: eng.enqueue_request(
            "g", "", "test-tiny", prompt_tokens=[4]))
        eng.cancel(r2.req_id)
        assert collect(r2, timeout=10)[-1].finish_reason == FinishReason.CANCELLED
        u = eng.core.snapshot()["users"]["g"]
        assert u["processing"] == 1 and u["dropped"] == 1
        collect(r1, timeout=20)
    finally:
        eng.stop()


def test_spec_stream_equals_plain_and_journals_like_jax():
    """With spec on, a step emits 1 + k words and journals the
    speculate / spec_verify pair; the stream equals spec off, and the
    decision stream equals the JAX fake's."""
    def run(eng, sp):
        req = eng.enqueue_request("s", "", "test-tiny", prompt_tokens=[9, 9],
                                  sampling=sp(max_tokens=11))
        items = collect(req, timeout=10)
        recs = eng.journal.tail(None)
        return _text(items), [r["kind"] for r in recs], recs

    port, ref = _both(_pair(spec=True, spec_k=3), run)
    assert port[0] == "".join(f"word{i} " for i in range(11))
    assert "speculate" in port[1] and "spec_verify" in port[1]
    assert port[1] == ref[1]
    assert decision_signature(port[2]) == jax_signature(ref[2])
    assert check_invariants(port[2]) == []


def test_step_fault_retries_then_poisons_like_jax():
    """A fake step that keeps failing: each request is retried once, then
    poisoned with the explicit error, and the journals agree."""
    def run(eng, sp):
        req = eng.enqueue_request("f", "", "test-tiny", prompt_tokens=[1],
                                  sampling=sp(max_tokens=4))
        items = collect(req, timeout=10)
        kinds = [r["kind"] for r in eng.journal.tail(None)]
        return items[-1].kind, items[-1].error, kinds

    plan = [{"site": "step", "kind": "exception", "every": 1}]
    from ollamamq_tpu.testing.faults import FaultPlan as JaxFaultPlan

    engs = (FakeEngine(EngineConfig(**SMALL, retry_backoff_s=0.0,
                                    fault_plan=FaultPlan(plan)),
                       blocklist_path=None),
            JaxFakeEngine(JaxEngineConfig(**SMALL, retry_backoff_s=0.0,
                                          fault_plan=JaxFaultPlan(plan)),
                          blocklist_path=None))
    for e in engs:
        e.start()
    port, ref = _both(engs, run)
    assert port[0] == "error" and "poisoned after 1 retry" in port[1]
    assert port == ref
    assert port[2].count("retry") == 1 and port[2].count("poison") == 1


def test_stats_match_jax_fake_runtime():
    port = FakeRuntime("test-tiny", EngineConfig(**SMALL))
    from ollamamq_tpu.engine.fake import FakeRuntime as JaxFakeRuntime

    ref = JaxFakeRuntime("test-tiny", JaxEngineConfig(**SMALL)).stats()
    got = port.stats()
    assert {k: got[k] for k in ref} == ref
    assert got["failed"] is False and got["device"] == "cpu"


def test_encoder_fake_serves_embeddings_only():
    eng = FakeEngine(EngineConfig(**SMALL), blocklist_path=None,
                     models={"test-tiny-embed": None})
    eng.start()
    try:
        emb = eng.enqueue_request("e", "", "test-tiny-embed", prompt_tokens=[5, 6],
                                  kind="embed")
        assert collect(emb, timeout=10)[-1].kind == "done"
        assert len(emb.embedding) == 64
        gen = eng.enqueue_request("e", "", "test-tiny-embed", prompt_tokens=[5])
        last = collect(gen, timeout=10)[-1]
        assert last.kind == "error" and "embedding-only" in last.error
    finally:
        eng.stop()


def test_http_surface_through_the_fake_engine(tmp_path):
    srv = serve_in_thread(FakeEngine(EngineConfig(**SMALL), blocklist_path=str(
        tmp_path / "bl.json")), timeout_s=30)
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"X-User-ID": "h"})
        return urllib.request.urlopen(req, timeout=30)

    try:
        r = json.loads(post("/api/generate", {"model": "test-tiny", "prompt": "x",
                                              "stream": False,
                                              "options": {"num_predict": 3}}).read())
        assert r["response"] == "word0 word1 word2 " and r["token_ids"] == [1, 2, 3]
        lines = [json.loads(x) for x in post("/api/chat", {
            "model": "test-tiny", "messages": [{"role": "user", "content": "x"}],
            "options": {"num_predict": 2}})]
        assert "".join(x["message"]["content"] for x in lines) == "word0 word1 "
        assert lines[-1]["done_reason"] == "length"
        e = json.loads(post("/api/embed", {"model": "test-tiny",
                                           "input": ["a", "bc"]}).read())
        assert [len(v) for v in e["embeddings"]] == [64, 64]
        c = json.loads(post("/v1/chat/completions", {
            "model": "test-tiny", "max_tokens": 2,
            "messages": [{"role": "user", "content": "x"}]}).read())
        assert c["choices"][0]["message"]["content"] == "word0 word1 "
        h = json.loads(urllib.request.urlopen(base + "/health", timeout=5).read())
        assert h["status"] == "ok" and h["device"] == "cpu"
    finally:
        stop_server(srv)


def test_fake_engine_leaves_the_torch_engine_device_default():
    """FakeEngine runs on the CPU whatever the host has; TorchEngine
    without a device still means CUDA and raises when none is found."""
    eng = FakeEngine(EngineConfig(**SMALL), blocklist_path=None)
    assert str(eng.device) == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchEngine(EngineConfig(**SMALL))
