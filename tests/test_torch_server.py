"""The port's HTTP server on the CPU with test-tiny: Ollama NDJSON and
JSON, OpenAI server-sent events, and two users served concurrently
through the fair-share core."""

import http.client
import json
import threading

import pytest
import torch

from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server


@pytest.fixture(scope="module")
def server():
    eng = TorchEngine(EngineConfig(model="test-tiny", max_slots=4, num_pages=64,
                                   page_size=8, max_pages_per_seq=16,
                                   max_new_tokens=8, max_batch_tokens=48,
                                   token_granule=8),
                      device="cpu", dtype=torch.float32)
    srv = serve_in_thread(eng, port=0, timeout_s=60)
    yield srv
    stop_server(srv)


def _call(srv, method, path, body=None, user=None):
    c = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
    headers = {"Content-Type": "application/json"}
    if user:
        headers["X-User-ID"] = user
    c.request(method, path, json.dumps(body) if body is not None else None, headers)
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, r.getheader("Content-Type"), data


GREEDY = {"temperature": 0, "num_predict": 6}


def test_health_and_tags(server):
    status, _, data = _call(server, "GET", "/health")
    body = json.loads(data)
    assert status == 200 and body["status"] == "ok" and body["device"] == "cpu"
    assert set(body["kernel_launches"]) == {
        "paged_decode_attention", "paged_decode_attention_int8",
        "ragged_paged_attention", "ragged_paged_attention_int8"}
    status, _, data = _call(server, "GET", "/api/tags")
    assert status == 200
    assert [m["name"] for m in json.loads(data)["models"]] == ["test-tiny"]
    assert _call(server, "POST", "/api/generate", {"prompt": "x"})[0] == 400
    assert _call(server, "POST", "/api/generate", {"model": "nope"})[0] == 404


def test_generate_stream_and_not(server):
    status, ctype, data = _call(server, "POST", "/api/generate",
                                {"model": "test-tiny", "prompt": "hello",
                                 "stream": False, "options": GREEDY}, user="alice")
    assert status == 200 and ctype == "application/json"
    whole = json.loads(data)
    assert whole["done"] is True and whole["done_reason"] == "length"
    assert whole["eval_count"] == 6 and len(whole["token_ids"]) == 6

    status, ctype, data = _call(server, "POST", "/api/generate",
                                {"model": "test-tiny", "prompt": "hello",
                                 "options": GREEDY}, user="alice")
    assert status == 200 and ctype == "application/x-ndjson"
    frames = [json.loads(line) for line in data.decode().splitlines()]
    assert frames[-1]["done"] is True and frames[-1]["done_reason"] == "length"
    assert all(not f["done"] for f in frames[:-1])
    ids = [t for f in frames for t in f.get("token_ids", [])]
    assert ids == whole["token_ids"]  # greedy: same tokens either way
    assert "".join(f["response"] for f in frames) == whole["response"]


def test_chat_ndjson(server):
    status, ctype, data = _call(server, "POST", "/api/chat",
                                {"model": "test-tiny", "options": GREEDY,
                                 "messages": [{"role": "user", "content": "hi"}]},
                                user="bob")
    assert status == 200 and ctype == "application/x-ndjson"
    frames = [json.loads(line) for line in data.decode().splitlines()]
    assert frames[-1]["done"] is True
    assert all(f["message"]["role"] == "assistant" for f in frames)


def test_openai_sse(server):
    status, ctype, data = _call(server, "POST", "/v1/chat/completions",
                                {"model": "test-tiny", "stream": True,
                                 "max_tokens": 5, "temperature": 0,
                                 "messages": [{"role": "user", "content": "hi"}]},
                                user="carol")
    assert status == 200 and ctype == "text/event-stream"
    events = [e for e in data.decode().split("\n\n") if e]
    assert events[-1] == "data: [DONE]"
    last = json.loads(events[-2][len("data: "):])
    assert last["choices"][0]["finish_reason"] == "length"
    status, _, data = _call(server, "POST", "/v1/chat/completions",
                            {"model": "test-tiny", "max_tokens": 5,
                             "temperature": 0, "messages": [{"role": "user", "content": "hi"}]})
    body = json.loads(data)
    assert status == 200 and body["usage"]["completion_tokens"] == 5


def test_two_users_concurrently(server):
    results = {}

    def worker(user, prompt):
        results[user] = _call(server, "POST", "/api/generate",
                              {"model": "test-tiny", "prompt": prompt,
                               "stream": False, "options": GREEDY}, user=user)

    threads = [threading.Thread(target=worker, args=(u, p))
               for u, p in (("dave", "one prompt"),
                            ("erin", "another, longer prompt"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for user in ("dave", "erin"):
        status, _, data = results[user]
        assert status == 200 and json.loads(data)["eval_count"] == 6
    # The fair-share core accounted both users' requests as served.
    users = server.engine.core.snapshot()["users"]
    assert users["dave"]["processed"] == 1 and users["erin"]["processed"] == 1


def _sse(data):
    return [json.loads(line[len("data: "):])
            for line in data.decode().splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


def test_images_ignored_is_loud(server):
    """Image payloads get an explicit `warnings` field, streamed or not,
    on each route that takes them (the JAX package's test_api.py case,
    with the streamed and non-streamed mode of every route): no vision
    path exists, so a text-only answer is never silent."""
    png = "aGVsbG8="  # content is irrelevant; presence is the contract
    opts = {"options": GREEDY}
    # /api/generate: top-level images.
    for stream in (False, True):
        status, _, data = _call(server, "POST", "/api/generate", {
            "model": "test-tiny", "prompt": "what is this?",
            "stream": stream, "images": [png], **opts})
        assert status == 200
        last = [json.loads(x) for x in data.decode().splitlines()][-1]
        assert last["done"] and "images ignored" in last["warnings"][0]
    # /api/chat: a message's images.
    for stream in (False, True):
        status, _, data = _call(server, "POST", "/api/chat", {
            "model": "test-tiny", "stream": stream, **opts,
            "messages": [{"role": "user", "content": "hi",
                          "images": [png]}]})
        assert status == 200
        lines = [json.loads(x) for x in data.decode().splitlines()]
        assert any("images ignored" in w
                   for x in lines for w in x.get("warnings", []))
        assert "warnings" in lines[-1] and lines[-1]["done"]
    # /v1/chat/completions: an image_url content part.
    messages = [{"role": "user", "content": [
        {"type": "text", "text": "hi"},
        {"type": "image_url", "image_url": {"url": "data:x"}}]}]
    status, _, data = _call(server, "POST", "/v1/chat/completions", {
        "model": "test-tiny", "max_tokens": 4, "messages": messages})
    assert status == 200
    assert "images ignored" in json.loads(data)["warnings"][0]
    status, _, data = _call(server, "POST", "/v1/chat/completions", {
        "model": "test-tiny", "max_tokens": 4, "stream": True,
        "messages": messages})
    assert status == 200
    chunks = _sse(data)
    assert any("images ignored" in w
               for c in chunks for w in c.get("warnings", []))
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    # No images => no warnings field at all, in either mode.
    status, _, data = _call(server, "POST", "/api/generate", {
        "model": "test-tiny", "prompt": "hi", "stream": False, **opts})
    assert "warnings" not in json.loads(data)
    status, _, data = _call(server, "POST", "/v1/chat/completions", {
        "model": "test-tiny", "max_tokens": 4, "stream": True,
        "messages": [{"role": "user", "content": "hi"}]})
    assert not any("warnings" in c for c in _sse(data))
