"""Ollama's /api/generate `context` field on the port, against the JAX
package, on the CPU.

A client continues a conversation by sending the ids of an earlier turn
as `context`. The JAX engine folds them into the prompt with
generated_ids pre-filled and max_tokens re-based (engine.py
enqueue_request's context_ids), so decoding continues right after them.
The port's server reads the field and TorchEngine folds it the same way:
the same prompt and context give the same greedy ids through the port's
HTTP route as through TPUEngine (test-tiny, float32, weights bridged).
A `context` that is not a list of ints, or that holds an id outside the
model's vocabulary, is a 400: at a single engine, at a fleet router, and
in a KV migration blob sent to /admin/migrate/import.
"""

import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.config import EngineConfig as JaxEngineConfig
from ollamamq_tpu.engine.engine import TPUEngine
from ollamamq_tpu.ops.sampling import SamplingParams as JaxSampling
from ollamamq_tpu_torch.config import MODEL_CONFIGS, EngineConfig
from ollamamq_tpu_torch.engine import kv_cache as kvc
from ollamamq_tpu_torch.engine.engine import (TokenIdError, TorchEngine,
                                              request_migration_state)
from ollamamq_tpu_torch.engine.request import Request
from ollamamq_tpu_torch.fleet import FleetRouter, LocalMember
from ollamamq_tpu_torch.models.weights import from_jax_numpy
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
from testutil import collect

TINY = dict(model="test-tiny", max_slots=2, num_pages=64, page_size=8,
            max_pages_per_seq=8, decode_steps_per_iter=1)
PROMPT = "and then"
CONTEXT = [77, 104, 101, 110, 32]  # five ids of an earlier turn
NEW = 6


@pytest.fixture(scope="module")
def jax_reference():
    """(ids after the context, greedy, from TPUEngine; the bridged
    weights)."""
    jeng = TPUEngine(JaxEngineConfig(prefill_buckets=(16, 32), **TINY),
                     blocklist_path=None, dtype=jnp.float32)
    jeng.start()
    try:
        tok = jeng.runtimes["test-tiny"].tokenizer
        req = jeng.enqueue_request("ctx", "", "test-tiny",
                                   prompt_tokens=tok.encode(PROMPT),
                                   sampling=JaxSampling(max_tokens=NEW),
                                   raw_prompt=PROMPT, context_ids=CONTEXT)
        items = collect(req)
        pnp = jax.tree_util.tree_map(np.asarray,
                                     jeng.runtimes["test-tiny"].params)
    finally:
        jeng.stop()
    assert items[-1].kind == "done"
    assert req.generated_ids[:len(CONTEXT)] == CONTEXT
    ids = [i.token_id for i in items if i.kind == "token" and i.token_id >= 0]
    assert len(ids) == NEW
    return ids, from_jax_numpy(pnp, MODEL_CONFIGS["test-tiny"])


@pytest.fixture(scope="module")
def port(jax_reference):
    srv = serve_in_thread(TorchEngine(EngineConfig(**TINY), device="cpu",
                                      dtype=torch.float32,
                                      params=jax_reference[1]))
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv.engine
    stop_server(srv)


def _generate(base, body):
    req = urllib.request.Request(base + "/api/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"X-User-ID": "ctx"})
    return urllib.request.urlopen(req, timeout=120)


def test_generate_context_matches_jax_engine(jax_reference, port):
    """The streamed ids after the context equal TPUEngine's; the reply's
    token_ids (the whole generation) lead with the context."""
    want, _params = jax_reference
    base, _eng = port
    body = {"model": "test-tiny", "prompt": PROMPT, "context": CONTEXT,
            "options": {"temperature": 0, "repeat_penalty": 1.0,
                        "num_predict": NEW}}
    ids, done = [], None
    for line in _generate(base, {**body, "stream": True}):
        frame = json.loads(line)
        ids += frame.get("token_ids") or []
        if frame["done"]:
            done = frame["done_reason"]
    assert done == "length"
    assert ids == want
    reply = json.loads(_generate(base, {**body, "stream": False}).read())
    assert reply["token_ids"] == CONTEXT + want


def test_engine_folds_context_as_jax_does(jax_reference, port):
    """enqueue_request(context_ids=...) on TorchEngine: prompt + ctx,
    generated_ids pre-filled, the budget re-based, the prompt count."""
    want, _params = jax_reference
    _base, eng = port
    tok = eng.runtimes["test-tiny"].tokenizer
    prompt = tok.encode(PROMPT)
    req = eng.enqueue_request("ctx", "", "test-tiny", prompt_tokens=prompt,
                              sampling=SamplingParams(max_tokens=NEW),
                              raw_prompt=PROMPT, context_ids=CONTEXT)
    assert req.raw_prompt == PROMPT
    assert req.prompt_tokens[:len(prompt) + len(CONTEXT)] == prompt + CONTEXT
    assert req.stats.prompt_tokens == len(prompt) + len(CONTEXT)
    assert req.sampling.max_tokens == NEW + len(CONTEXT)
    assert req._replay_gen == len(CONTEXT)
    items = collect(req)
    assert items[-1].kind == "done"
    assert req.generated_ids == CONTEXT + want


@pytest.mark.parametrize("context", ["5 6", [1, "2"], [True, 3], {"a": 1}])
def test_bad_context_is_400(port, context):
    base, _eng = port
    with pytest.raises(urllib.error.HTTPError) as e:
        _generate(base, {"model": "test-tiny", "prompt": "x",
                         "context": context, "stream": False})
    assert e.value.code == 400
    assert "context" in json.loads(e.value.read())["error"]


@pytest.mark.parametrize("context", [[512], [-1], [5, 999999999]])
def test_out_of_vocab_context_is_400_and_engine_serves_on(port, context):
    """A context id outside [0, vocab_size) never reaches the device (on
    the card it would index the embedding table past its end): the
    request is a 400, nothing is left queued, and the engine serves the
    next request."""
    base, eng = port
    with pytest.raises(urllib.error.HTTPError) as e:
        _generate(base, {"model": "test-tiny", "prompt": "x",
                         "context": context, "stream": False})
    assert e.value.code == 400
    assert "outside [0, 512)" in json.loads(e.value.read())["error"]
    assert eng.core.queue_len("ctx") == 0
    reply = json.loads(_generate(base, {
        "model": "test-tiny", "prompt": PROMPT, "stream": False,
        "options": {"temperature": 0, "num_predict": 3}}).read())
    assert reply["done"] and reply["done_reason"] == "length"
    assert len(reply["token_ids"]) == 3


def test_engine_refuses_out_of_vocab_ids(port):
    """enqueue_request itself checks the prompt and the context ids
    against the model's vocabulary, so WAL recovery is covered too."""
    _base, eng = port
    for bad in (dict(prompt_tokens=[1, 512]),
                dict(prompt_tokens=[1], context_ids=[-3])):
        with pytest.raises(TokenIdError):
            eng.enqueue_request("ctx", "", "test-tiny",
                                sampling=SamplingParams(max_tokens=2), **bad)
    assert eng.core.queue_len("ctx") == 0


@pytest.fixture(scope="module")
def fleet(jax_reference):
    """A FleetRouter over two in-process TorchEngine members, served."""
    members = [LocalMember(f"r{i}", TorchEngine(
        EngineConfig(**TINY), device="cpu", dtype=torch.float32,
        params=jax_reference[1], blocklist_path=None)) for i in range(2)]
    srv = serve_in_thread(FleetRouter(members, EngineConfig(**TINY),
                                      blocklist_path=None))
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv.engine
    stop_server(srv)


@pytest.mark.parametrize("context", [[512], [-1], [5, 999999999]])
def test_out_of_vocab_context_is_400_at_the_fleet_router(fleet, context):
    """The router checks ids at its door as a single engine does: on the
    card every in-process member shares one CUDA context, which one
    out-of-table id would poison. Nothing is left queued, no member saw
    the request, and the fleet serves the next one."""
    base, router = fleet
    with pytest.raises(urllib.error.HTTPError) as e:
        _generate(base, {"model": "test-tiny", "prompt": "x",
                         "context": context, "stream": False})
    assert e.value.code == 400
    assert "outside [0, 512)" in json.loads(e.value.read())["error"]
    assert router.core.queue_len("ctx") == 0
    assert not router.pending
    reply = json.loads(_generate(base, {
        "model": "test-tiny", "prompt": PROMPT, "stream": False,
        "options": {"temperature": 0, "num_predict": 3}}).read())
    assert reply["done"] and reply["done_reason"] == "length"


def test_member_refuses_out_of_vocab_injected_request(fleet):
    """inject_request, the router's seam into a member, checks the
    prompt and the replayed generated ids too."""
    _base, router = fleet
    eng = router.members[0].engine
    for prompt, gen in (([1, 512], []), ([1, 70], [70, -2])):
        req = Request(0, "ctx", "test-tiny", prompt,
                      SamplingParams(max_tokens=2))
        req.generated_ids = gen
        with pytest.raises(TokenIdError):
            eng.inject_request(req)
    assert eng.core.queue_len("ctx") == 0 and not eng.pending


def _stream_blob(eng, **bad) -> bytes:
    """A wire blob of one decode slot for `eng`'s test-tiny runtime: a
    3-token prompt, one generated token pending (kv_len 3), zero pages;
    `bad` overrides the last token, the ring, or the request's ids."""
    rt = eng.runtimes["test-tiny"]
    cfg, ps, n = rt.cfg, rt.ecfg.page_size, 1
    req = Request(0, "imp", "test-tiny", bad.get("prompt", [1, 70, 80]),
                  SamplingParams(max_tokens=3))
    req.generated_ids = bad.get("generated", [90])
    ring = np.full(rt.recent.shape[1], -1, np.int32)
    ring[:4] = bad.get("recent", [1, 70, 80, 90])
    shape = (cfg.num_layers, n * ps, cfg.num_kv_heads, cfg.head_dim)
    return kvc.pack_migration_blob({
        "version": 1, "kind": "stream", "model": "test-tiny",
        "kv_dtype": rt.kv_dtype, "page_size": ps,
        "num_layers": cfg.num_layers, "num_kv_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim, "kv_len": 3,
        "last_token": bad.get("last_token", 90), "n_pages": n,
        "recent": ring, "request": request_migration_state(req),
        "k_pages": np.zeros(shape, np.float32),
        "v_pages": np.zeros(shape, np.float32)})


def _import(base, raw: bytes):
    req = urllib.request.Request(
        base + "/admin/migrate/import", data=raw,
        headers={"X-User-ID": "imp",
                 "Content-Type": "application/octet-stream"})
    return urllib.request.urlopen(req, timeout=120)


@pytest.mark.parametrize("bad", [dict(last_token=512),
                                 dict(recent=[1, 70, 600, 90]),
                                 dict(generated=[90, 10**9]),
                                 dict(prompt=[1, -5, 80])],
                         ids=["last_token", "recent", "generated", "prompt"])
def test_out_of_vocab_migration_blob_is_400_and_engine_serves_on(port, bad):
    """/admin/migrate/import takes a blob from any caller: an id outside
    the vocabulary in its last token, penalty ring, generated or prompt
    ids is a 400 before a page is allocated, and the same blob with good
    ids then lands and streams to its end."""
    base, eng = port
    rt = eng.runtimes["test-tiny"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _import(base, _stream_blob(eng, **bad))
    assert e.value.code == 400
    assert "outside [0, 512)" in json.loads(e.value.read())["error"]
    assert rt.alloc.used_pages == 0
    assert all(r is None for r in rt.slot_req)
    frames = [json.loads(line) for line in _import(base, _stream_blob(eng))]
    assert frames[-1]["done"] and frames[-1]["done_reason"] == "length"
