"""The port's model registry and the rest of its route table on the CPU:
the tags / ps / show / OpenAI-models payloads equal the JAX registry's,
and, over real sockets against TorchEngine serving test-tiny and
test-tiny-embed, the route-level cases of tests/test_api.py (embeddings
in every shape, embed on a generative model, token counts, the registry
routes, the pull / delete lifecycle with streamed progress, copy, the
honest 501s, 404 / 400 / 405, blocked-user 403 on every new route), the
text-completions route, 409 for deleting a busy model, and the
attribution and bundle routes."""

import http.client
import json
import time

import numpy as np
import pytest
import torch

from ollamamq_tpu.server.registry import ModelRegistry as JaxRegistry
from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
from ollamamq_tpu_torch.server.registry import ModelRegistry

STAMPS = ("modified_at", "expires_at", "created")


def _norm(obj):
    """Payload with its timestamps blanked."""
    if isinstance(obj, dict):
        return {k: (None if k in STAMPS else _norm(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_norm(v) for v in obj]
    return obj


class _StubEngine:
    """loaded_models / load_model / evict_model: the registry's view."""

    def __init__(self, names):
        self.names = list(names)
        self.calls = []

    def loaded_models(self):
        return list(self.names)

    def load_model(self, name, checkpoint_path=None):
        self.calls.append(("load", name, checkpoint_path))
        if name not in self.names:
            self.names.append(name)

    def evict_model(self, name):
        self.calls.append(("evict", name))
        self.names.remove(name)
        return True


LOADED = ["test-tiny", "test-tiny-embed", "llama3.2:1b", "nomic-embed-text",
          "qwen2.5:7b", "qwen3:8b"]


def test_registry_payloads_match_jax():
    regs = [cls(_StubEngine(LOADED)) for cls in (JaxRegistry, ModelRegistry)]
    for reg in regs:
        reg.register("test-tiny-qwen", checkpoint_path="/ckpt/qwen")  # not loaded
        assert reg.copy("llama3.2:1b", "my-llama")
        assert not reg.copy("nope", "x")
    j, t = regs
    assert _norm(t.tags_payload()) == _norm(j.tags_payload())
    assert _norm(t.ps_payload()) == _norm(j.ps_payload())
    assert _norm(t.openai_models_payload()) == _norm(j.openai_models_payload())
    for name in LOADED + ["test-tiny-qwen", "my-llama", "llama3", "nope"]:
        assert _norm(t.show_payload(name)) == _norm(j.show_payload(name)), name
    for reg in regs:
        reg.pull("test-tiny-qwen")
        assert reg.delete("qwen3:8b") and not reg.delete("nope")
    assert regs[0].engine.calls == regs[1].engine.calls
    assert _norm(t.tags_payload()) == _norm(j.tags_payload())
    assert _norm(t.ps_payload()) == _norm(j.ps_payload())


@pytest.fixture(scope="module")
def server():
    eng = TorchEngine(EngineConfig(model="test-tiny", max_slots=4, num_pages=64,
                                   page_size=8, max_pages_per_seq=16,
                                   max_new_tokens=8, max_batch_tokens=48,
                                   token_granule=8),
                      device="cpu", dtype=torch.float32,
                      models={"test-tiny": None, "test-tiny-embed": None})
    srv = serve_in_thread(eng, port=0, timeout_s=60)
    yield srv
    stop_server(srv)


def _call(srv, method, path, body=None, user=None, raw=None):
    c = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=60)
    headers = {"Content-Type": "application/json"}
    if user:
        headers["X-User-ID"] = user
    data = raw if raw is not None else (json.dumps(body) if body is not None else None)
    c.request(method, path, data, headers)
    r = c.getresponse()
    out = r.read()
    c.close()
    return r.status, r.getheader("Content-Type"), out


def _json(srv, method, path, body=None, status=200, **kw):
    st, ctype, data = _call(srv, method, path, body, **kw)
    assert st == status, (path, st, data[:300])
    return json.loads(data)


def test_root_liveness(server):
    status, ctype, data = _call(server, "GET", "/")
    assert status == 200 and data == b"Ollama is running"
    assert _call(server, "POST", "/")[0] == 200  # "*" route


def test_embeddings_all_shapes(server):
    body = _json(server, "POST", "/api/embed", {"model": "test-tiny-embed",
                                                "input": ["a", "b"]})
    assert len(body["embeddings"]) == 2 and body["model"] == "test-tiny-embed"
    assert all(len(v) == 64 for v in body["embeddings"])
    np.testing.assert_allclose(np.linalg.norm(body["embeddings"], axis=-1), 1.0,
                               rtol=1e-3)
    body = _json(server, "POST", "/api/embeddings", {"model": "test-tiny-embed",
                                                     "prompt": "a"})
    assert isinstance(body["embedding"], list) and body["embedding"]
    body = _json(server, "POST", "/v1/embeddings", {"model": "test-tiny-embed",
                                                    "input": "a"})
    assert body["object"] == "list" and body["data"][0]["object"] == "embedding"
    assert body["data"][0]["index"] == 0 and body["model"] == "test-tiny-embed"


def test_embed_on_generative_model_serves(server):
    for route, body, key in (
            ("/api/embed", {"model": "test-tiny", "input": "a"}, "embeddings"),
            ("/api/embeddings", {"model": "test-tiny", "prompt": "a"}, "embedding"),
            ("/v1/embeddings", {"model": "test-tiny", "input": "a"}, "data")):
        assert key in _json(server, "POST", route, body)
    assert _call(server, "POST", "/api/embed", {"model": "nope", "input": "a"})[0] == 404


def test_embed_token_counts(server):
    """Counts are tokens, not characters: BOS + 6 UTF-8 bytes."""
    body = _json(server, "POST", "/api/embed", {"model": "test-tiny-embed",
                                                "input": ["☃☃"]})
    assert body["prompt_eval_count"] == 7
    usage = _json(server, "POST", "/v1/embeddings", {"model": "test-tiny-embed",
                                                     "input": "☃☃"})["usage"]
    assert usage["prompt_tokens"] == 7 and usage["total_tokens"] == 7


def test_tags_ps_show_version(server):
    names = [m["name"] for m in _json(server, "GET", "/api/tags")["models"]]
    assert "test-tiny" in names and "test-tiny-embed" in names
    ps = _json(server, "GET", "/api/ps")
    assert any(m["name"] == "test-tiny" for m in ps["models"])
    assert all("size_vram" in m for m in ps["models"])
    show = _json(server, "POST", "/api/show", {"model": "test-tiny"})
    assert show["details"]["family"] in ("llama", "qwen2", "bert")
    assert show["model_info"]["general.architecture"] in ("llama", "qwen2")
    assert _json(server, "POST", "/api/show", {"name": "test-tiny-embed"}
                 )["details"]["family"] == "bert"
    assert _call(server, "POST", "/api/show", {"model": "nope"})[0] == 404
    assert "version" in _json(server, "GET", "/api/version")


def test_openai_models(server):
    ids = [m["id"] for m in _json(server, "GET", "/v1/models")["data"]]
    assert "test-tiny" in ids
    one = _json(server, "GET", "/v1/models/test-tiny")
    assert one["id"] == "test-tiny" and one["object"] == "model"
    assert _call(server, "GET", "/v1/models/nope")[0] == 404


def test_pull_and_delete_lifecycle(server):
    assert _json(server, "POST", "/api/pull", {"model": "test-tiny-qwen",
                                               "stream": False}) == {"status": "success"}
    ps = _json(server, "GET", "/api/ps")["models"]
    assert any(m["name"] == "test-tiny-qwen" for m in ps)
    reply = _json(server, "POST", "/api/generate", {
        "model": "test-tiny-qwen", "prompt": "hi", "stream": False,
        "options": {"temperature": 0, "num_predict": 3}})
    assert reply["done"] is True and reply["eval_count"] == 3
    assert _json(server, "POST", "/api/delete", {"model": "test-tiny-qwen"}) == \
        {"status": "success"}
    ps = _json(server, "GET", "/api/ps")["models"]
    assert not any(m["name"] == "test-tiny-qwen" for m in ps)
    assert "test-tiny-qwen" not in server.engine.runtimes
    assert _call(server, "POST", "/api/delete", {"model": "test-tiny-qwen"})[0] == 404
    # Deleted: requests for it are refused as for a model never pulled.
    assert _call(server, "POST", "/api/generate", {"model": "test-tiny-qwen",
                                                   "prompt": "x"})[0] == 404
    assert _call(server, "POST", "/api/pull", {"model": "no-such-arch"})[0] == 404


def test_pull_streaming_progress(server):
    status, ctype, data = _call(server, "POST", "/api/pull", {"model": "test-tiny-qwen"})
    lines = [json.loads(x) for x in data.decode().strip().split("\n")]
    assert status == 200 and ctype == "application/x-ndjson"
    assert lines[0]["status"] == "pulling manifest"
    assert lines[-1]["status"] == "success"
    _call(server, "POST", "/api/delete", {"model": "test-tiny-qwen"})


def test_pull_failure_in_band_and_500(server, tmp_path):
    """A load that fails after the 200 is on the wire ends the NDJSON body
    with an error line; unstreamed, it answers 500."""
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "manifest.ocdbt").write_text("x")
    server.registry.register("test-tiny-qwen3", checkpoint_path=str(orbax))
    status, _, data = _call(server, "POST", "/api/pull", {"model": "test-tiny-qwen3"})
    lines = [json.loads(x) for x in data.decode().strip().split("\n")]
    assert status == 200 and "orbax" in lines[-1]["error"]
    status, _, data = _call(server, "POST", "/api/pull", {"model": "test-tiny-qwen3",
                                                          "stream": False})
    assert status == 500 and "orbax" in json.loads(data)["error"]
    assert "test-tiny-qwen3" not in server.engine.runtimes
    server.registry.delete("test-tiny-qwen3")


def test_delete_busy_model_409(server):
    eng = server.engine
    rt = eng.runtimes["test-tiny"]
    req = eng.enqueue_request("busy", "", "test-tiny", prompt_tokens=[1, 5, 6],
                              sampling=SamplingParams(max_tokens=100_000))
    rt.tokenizer.eos_id = -1
    try:
        deadline = time.monotonic() + 30
        while not req.stats.first_token_at and time.monotonic() < deadline:
            time.sleep(0.01)
        status, _, data = _call(server, "POST", "/api/delete", {"model": "test-tiny"})
        assert status == 409 and "in-flight" in json.loads(data)["error"]
        assert eng.runtimes["test-tiny"] is rt
    finally:
        req.cancelled.set()
        rt.tokenizer.eos_id = 2
        while not req.stats.finished_at:
            time.sleep(0.01)


def test_copy_alias(server):
    assert _json(server, "POST", "/api/copy", {"source": "test-tiny",
                                               "destination": "my-alias"})
    names = [m["name"] for m in _json(server, "GET", "/api/tags")["models"]]
    assert "my-alias" in names
    assert _call(server, "POST", "/api/copy", {"source": "test-tiny"})[0] == 400
    assert _call(server, "POST", "/api/copy", {"source": "nope",
                                               "destination": "y"})[0] == 404
    server.registry.delete("my-alias")


def test_unsupported_routes_are_honest(server):
    for path in ("/api/create", "/api/push", "/api/blobs/sha256:abc"):
        assert _call(server, "POST", path, {})[0] == 501, path


def test_errors_404_400_405(server):
    st, _, data = _call(server, "POST", "/api/generate",
                        {"model": "definitely-not-a-model", "prompt": "x", "stream": False})
    assert st == 404 and "not found" in json.loads(data)["error"]
    assert _call(server, "POST", "/api/generate", {"prompt": "x"})[0] == 400
    assert _call(server, "POST", "/api/embed", {"input": "x"})[0] == 400
    assert _call(server, "POST", "/api/generate", raw=b"{not json")[0] == 400
    assert _call(server, "POST", "/health")[0] == 405
    assert _call(server, "DELETE", "/metrics")[0] == 405
    assert _call(server, "GET", "/no/such/route")[0] == 404
    # GET carries no body: the model field is missing.
    assert _call(server, "GET", "/api/generate")[0] == 400


def test_completions_json_and_sse(server):
    body = _json(server, "POST", "/v1/completions", {
        "model": "test-tiny", "prompt": ["one", "two"], "max_tokens": 4,
        "temperature": 0})
    assert body["object"] == "text_completion" and body["id"].startswith("cmpl-")
    assert [c["index"] for c in body["choices"]] == [0, 1]
    assert all(c["finish_reason"] in ("stop", "length") for c in body["choices"])
    assert body["usage"]["total_tokens"] == (body["usage"]["prompt_tokens"]
                                             + body["usage"]["completion_tokens"])
    status, ctype, data = _call(server, "POST", "/v1/completions", {
        "model": "test-tiny", "prompt": "one", "max_tokens": 6, "temperature": 0,
        "stream": True})
    assert status == 200 and ctype == "text/event-stream"
    events = [x[len("data: "):] for x in data.decode().split("\n\n") if x]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(x) for x in events[:-1]]
    assert all(c["object"] == "text_completion" and "text" in c["choices"][0]
               for c in chunks)
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")
    whole = _json(server, "POST", "/v1/completions", {
        "model": "test-tiny", "prompt": "one", "max_tokens": 6, "temperature": 0})
    assert "".join(c["choices"][0]["text"] for c in chunks) == whole["choices"][0]["text"]
    assert _call(server, "POST", "/v1/completions", {
        "model": "test-tiny", "prompt": ["a", "b"], "stream": True})[0] == 400


def test_debug_requests_and_bundle(server):
    st, _, data = _call(server, "POST", "/api/generate", {
        "model": "test-tiny", "prompt": "trace me", "options": {"num_predict": 2}})
    assert st == 200
    rid = json.loads(data.decode().splitlines()[-1])["req_id"]
    summary = _json(server, "GET", "/debug/requests?recent=5")
    assert {"inflight", "recent"} <= set(summary)
    one = _json(server, "GET", f"/debug/requests/{rid}")
    assert one["req_id"] == rid and "phases_ms" in one
    assert _call(server, "GET", "/debug/requests/99999999")[0] == 404
    assert _call(server, "GET", "/debug/requests/abc")[0] == 400
    assert _call(server, "GET", "/debug/requests?recent=x")[0] == 400
    bundle = _json(server, "GET", "/debug/bundle")
    for key in ("config", "env", "models", "stats", "health", "alerts", "slo",
                "metrics", "stepprof", "hbm", "requests", "prefix_cache"):
        assert key in bundle and not (isinstance(bundle[key], dict)
                                      and set(bundle[key]) == {"error"}), key
    assert set(bundle["models"]) >= {"test-tiny", "test-tiny-embed"}
    assert bundle["config"]["max_new_tokens"] == "[REDACTED]"  # "token" keys


NEW_ROUTES = [("GET", "/"), ("POST", "/api/embed"), ("POST", "/api/embeddings"),
              ("GET", "/api/ps"), ("POST", "/api/show"), ("GET", "/api/version"),
              ("POST", "/api/pull"), ("POST", "/api/delete"), ("POST", "/api/copy"),
              ("POST", "/api/create"), ("POST", "/api/push"), ("POST", "/api/blobs/x"),
              ("POST", "/v1/completions"), ("POST", "/v1/embeddings"),
              ("GET", "/v1/models"), ("GET", "/v1/models/test-tiny"),
              ("GET", "/debug/requests"), ("GET", "/debug/requests/1"),
              ("GET", "/debug/bundle"), ("GET", "/api/tags")]


def test_blocked_user_403_on_every_new_route(server):
    core = server.engine.core
    core.block_user("banned")
    try:
        for method, path in NEW_ROUTES:
            st, _, data = _call(server, method, path, {"model": "test-tiny-embed",
                                                       "input": "x"}, user="banned")
            assert st == 403 and "blocked" in json.loads(data)["error"], path
        assert _call(server, "GET", "/health", user="banned")[0] == 200
    finally:
        core.unblock_user("banned")
    assert _call(server, "GET", "/api/version", user="banned")[0] == 200


def test_keepalive_connection_survives_refusals_and_ignored_bodies(server):
    """Bodies are read whatever the route does: a 403 and a 404 with a
    body, and a POST /api/tags whose body is ignored, leave the kept-alive
    connection in step for the next request."""
    core = server.engine.core
    c = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
    body = json.dumps({"model": "test-tiny", "prompt": "x" * 300})
    core.block_user("kept")
    try:
        c.request("POST", "/api/generate", body, {"X-User-ID": "kept"})
        r = c.getresponse()
        assert r.status == 403 and b"blocked" in r.read()
    finally:
        core.unblock_user("kept")
    for method, path, status in (("POST", "/no/such", 404), ("POST", "/api/tags", 200),
                                 ("GET", "/api/version", 200)):
        c.request(method, path, body, {"X-User-ID": "kept"})
        r = c.getresponse()
        assert r.status == status, path
        r.read()
    c.close()
