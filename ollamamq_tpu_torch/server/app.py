"""HTTP front-end on the standard library: Ollama and OpenAI wire formats.

http.server.ThreadingHTTPServer, one thread per connection; each handler
enqueues into the engine (X-User-ID names the user the fair-share core
schedules by) and reads the request's TokenStream, writing NDJSON
(Ollama) or server-sent events (OpenAI) with chunked transfer encoding,
or one JSON body when the client asked for no stream.

The JAX package's single-engine route table (server/app.py), with its
methods and status codes; "*" accepts any method:
  GET /health; * / (Ollama's liveness text);
  * /api/generate, /api/chat, /api/embed, /api/embeddings;
  * /api/tags, /api/ps, /api/show, /api/version (the model registry,
    server/registry.py); * /api/pull (NDJSON progress when streaming; a
    failure after the 200 is an in-band "error" line), * /api/delete
    (409 while the model has work in flight, 404 when unknown),
    * /api/copy; honest 501s: * /api/create, /api/push, /api/blobs/{digest};
  * /v1/chat/completions, /v1/completions (JSON and server-sent events),
    /v1/embeddings, /v1/models, /v1/models/{model};
  the telemetry plane: GET /metrics (Prometheus text), /metrics.json,
    /metrics/snapshot, /debug/trace, /debug/trace/{req_id},
    /debug/requests, /debug/requests/{req_id} (latency attribution),
    /debug/bundle (every section error-contained), /debug/stepprof,
    /debug/hbm, GET|POST /debug/prefix_cache, POST /debug/profile (a
    torch.profiler capture exported as a Chrome trace).
Left out with the modules they serve: the fleet, journal, WAL and HA
routes. Every route but /health answers 403 to a blocked user or IP. A
request naming a model the registry does not hold (never pulled, or
deleted) answers 404, as Ollama does.

Bounded admission answers 429 (this user's queue is full) or 503 (the
whole queue is full) with a Retry-After from the observed completion
rate, and the JAX package's body.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import os
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs

from ollamamq_tpu_torch import __version__
from ollamamq_tpu_torch.config import get_model_config
from ollamamq_tpu_torch.core.mqcore import BlockedError, Family
from ollamamq_tpu_torch.engine.engine import QueueFullError
from ollamamq_tpu_torch.engine.request import FinishReason, Request, StreamItem
from ollamamq_tpu_torch.engine.tokenizer import ByteTokenizer
from ollamamq_tpu_torch.ops.cuda import launch_counts
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.registry import ModelRegistry
from ollamamq_tpu_torch.server.templates import render_chat, template_owns_bos
from ollamamq_tpu_torch.telemetry import REGISTRY, attribution, stepprof, tracing
from ollamamq_tpu_torch.telemetry import schema as tm

log = logging.getLogger("ollamamq.torch.server")


class ApiError(Exception):
    def __init__(self, status: int, message: str, headers: Optional[dict] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers or {}


# Bundle keys whose values are withheld, as in the JAX package.
_SECRET_KEY_MARKERS = ("token", "secret", "password", "passwd", "api_key",
                       "apikey", "credential", "auth", "cookie", "private")


def _redact(obj):
    """Recursively replace secret-shaped mapping values with a marker."""
    if isinstance(obj, dict):
        return {k: ("[REDACTED]" if any(m in str(k).lower()
                                        for m in _SECRET_KEY_MARKERS)
                    else _redact(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_redact(v) for v in obj]
    return obj


def _now_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


def _ns(seconds: float) -> int:
    return int(seconds * 1e9)


def _done_reason(item: StreamItem) -> str:
    return "length" if item.finish_reason == FinishReason.LENGTH else "stop"


def _error_reason(item: StreamItem) -> str:
    return item.finish_reason.value if item.finish_reason is not None else "error"


def _gen_stats(req: Request) -> dict:
    st = req.stats
    first = st.first_token_at or st.enqueued_at
    return {
        "total_duration": _ns(st.total_duration_s),
        "load_duration": 0,
        "prompt_eval_count": st.prompt_tokens,
        "prompt_eval_duration": _ns(max(0.0, first - st.enqueued_at)),
        "eval_count": st.completion_tokens,
        "eval_duration": _ns(max(0.0, (st.finished_at or time.monotonic()) - first)),
    }


class _ClientGone(Exception):
    """The client closed the connection mid-response."""


class Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "OllamaServer"

    def log_message(self, fmt, *args):  # route the access log to logging
        log.debug("%s " + fmt, self.address_string(), *args)

    # (method or "*", path) -> handler name; one {param} segment at most.
    ROUTES = {
        ("GET", "/health"): "health",
        ("*", "/"): "root",
        ("*", "/api/generate"): "api_generate",
        ("*", "/api/chat"): "api_chat",
        ("*", "/api/embed"): "api_embed",
        ("*", "/api/embeddings"): "api_embeddings_legacy",
        ("*", "/api/tags"): "api_tags",
        ("*", "/api/show"): "api_show",
        ("*", "/api/create"): "api_create",
        ("*", "/api/copy"): "api_copy",
        ("*", "/api/delete"): "api_delete",
        ("*", "/api/pull"): "api_pull",
        ("*", "/api/push"): "api_push",
        ("*", "/api/blobs/{digest}"): "api_blobs",
        ("*", "/api/ps"): "api_ps",
        ("*", "/api/version"): "api_version",
        ("*", "/v1/chat/completions"): "v1_chat_completions",
        ("*", "/v1/completions"): "v1_completions",
        ("*", "/v1/embeddings"): "v1_embeddings",
        ("*", "/v1/models"): "v1_models",
        ("*", "/v1/models/{model}"): "v1_model",
        ("GET", "/metrics"): "metrics",
        ("GET", "/metrics.json"): "metrics_json",
        ("GET", "/metrics/snapshot"): "metrics_snapshot",
        ("GET", "/debug/trace"): "debug_trace",
        ("GET", "/debug/trace/{req_id}"): "debug_trace_one",
        ("GET", "/debug/requests"): "debug_requests",
        ("GET", "/debug/requests/{req_id}"): "debug_request",
        ("GET", "/debug/bundle"): "debug_bundle",
        ("POST", "/debug/profile"): "debug_profile",
        ("GET", "/debug/stepprof"): "debug_stepprof",
        ("GET", "/debug/hbm"): "debug_hbm",
        ("GET", "/debug/prefix_cache"): "debug_prefix_cache",
        ("POST", "/debug/prefix_cache"): "debug_prefix_cache_flush",
    }

    # -- plumbing ------------------------------------------------------------
    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_PUT(self):
        self._dispatch("PUT")

    def do_DELETE(self):
        self._dispatch("DELETE")

    def do_PATCH(self):
        self._dispatch("PATCH")

    def _route(self, method: str, path: str):
        """(handler, path parameter or None), or raise 404 / 405."""
        allowed = False
        for (m, pattern), name in self.ROUTES.items():
            head, brace, _ = pattern.partition("{")
            if brace:
                arg = path[len(head):] if path.startswith(head) else ""
                if not arg or "/" in arg:
                    continue
            elif path != pattern:
                continue
            else:
                arg = None
            if m in ("*", method):
                return getattr(self, name), arg
            allowed = True
        if allowed:
            raise ApiError(405, f"method {method} not allowed for {path}")
        raise ApiError(404, f"no route for {method} {path}")

    def _dispatch(self, method: str) -> None:
        self.method = method
        # The body is read whatever the route does with it: one left unread
        # would be parsed as the connection's next request.
        n = int(self.headers.get("Content-Length") or 0)
        self._raw = self.rfile.read(n) if n > 0 else b""
        path, _, query = self.path.partition("?")
        self.query = {k: v[-1] for k, v in parse_qs(query).items()}
        try:
            fn, arg = self._route(method, path)
            fn() if arg is None else fn(arg)
        except ApiError as e:
            self._send_json(e.status, {"error": e.message}, e.headers)
        except _ClientGone:
            self.close_connection = True

    def _read_body(self) -> dict:
        """The JSON object body; GET carries none (as in the JAX package,
        whatever was sent is ignored)."""
        raw = self._raw
        if not raw or self.method == "GET":
            return {}
        try:
            body = json.loads(raw)
        except json.JSONDecodeError:
            raise ApiError(400, "invalid JSON body")
        if not isinstance(body, dict):
            raise ApiError(400, "request body must be a JSON object")
        return body

    def _send_json(self, status: int, obj, headers: Optional[dict] = None) -> None:
        self._send(status, json.dumps(obj).encode(), "application/json", headers)

    def _send(self, status: int, data: bytes, content_type: str,
              headers: Optional[dict] = None) -> None:
        try:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            raise _ClientGone()

    def _int_query(self, name: str, default: int) -> int:
        try:
            return int(self.query.get(name, default))
        except ValueError:
            raise ApiError(400, f"'{name}' must be an integer")

    def _start_chunked(self, content_type: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
        self.wfile.flush()

    def _ident(self):
        """(user, ip); blocked users and IPs get 403."""
        user = self.headers.get("X-User-ID") or "anonymous"
        ip = self.client_address[0] if self.client_address else ""
        core = self.server.engine.core
        if core.is_user_blocked(user):
            raise ApiError(403, f"user '{user}' is blocked")
        if ip and core.is_ip_blocked(ip):
            raise ApiError(403, f"ip '{ip}' is blocked")
        return user, ip

    def _model(self, body: dict):
        """(name, architecture) of the body's model: 400 when missing, 404
        when the registry does not hold it (never pulled, or deleted), as
        Ollama answers."""
        name = body.get("model", "")
        if not name:
            raise ApiError(400, "missing 'model' field")
        entry = self.server.registry.resolve(name)
        if entry is None:
            raise ApiError(404, f"model '{name}' not found, try pulling it first")
        return name, entry.config

    def _tokenize(self, model: str, text: str, add_bos: bool = True):
        """With the resolved model's own tokenizer; a model not loaded yet
        gets the byte-level one (its request waits for a pull anyway)."""
        rt = self.server.engine.resolve_runtime(model)
        tok = rt.tokenizer if rt is not None else ByteTokenizer()
        return tok.encode(text, add_bos=add_bos)

    def _enqueue(self, user, ip, model, family, tokens, sampling,
                 kind: str = "generate") -> Request:
        try:
            return self.server.engine.enqueue_request(
                user, ip, model, family, tokens, sampling, kind=kind)
        except BlockedError as e:
            raise ApiError(403, str(e))
        except QueueFullError as e:
            # Per-user cap => 429 (this client backs off); global cap =>
            # 503 (the service is saturated).
            status = 429 if e.scope == "user_queue_full" else 503
            raise ApiError(status, str(e), headers={
                "Retry-After": str(max(1, int(round(e.retry_after_s))))})

    def _items(self, req: Request):
        """The request's stream items up to its terminal one; a request
        that outlives the server's timeout is cancelled engine-side."""
        deadline = time.monotonic() + self.server.timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                req.cancelled.set()
                self.server.engine.cancel(req.req_id)
                yield StreamItem("error", error="request timeout")
                return
            item = req.stream.get(timeout=min(remaining, 1.0))
            if item is None:
                continue
            yield item
            if item.kind in ("done", "error"):
                return

    def _stream(self, req: Request, content_type: str, frames) -> None:
        """Write `frames(item)` for every stream item as a chunked body;
        a vanished client cancels the request."""
        try:
            self._start_chunked(content_type)
            for item in self._items(req):
                for data in frames(item):
                    self._chunk(data)
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            req.cancelled.set()
            self.server.engine.cancel(req.req_id)
            raise _ClientGone()

    def _final_items(self, req: Request) -> list:
        """Every stream item of a non-streamed reply; an engine error
        becomes 504 (deadline) or 500."""
        items = list(self._items(req))
        last = items[-1]
        if last.kind == "error":
            raise ApiError(504 if last.finish_reason == FinishReason.DEADLINE
                           else 500, f"engine error: {last.error}")
        return items

    # -- routes --------------------------------------------------------------
    def root(self) -> None:
        """Ollama's liveness string (blocked users get 403 here too)."""
        self._ident()
        self._send(200, b"Ollama is running", "text/plain; charset=utf-8")

    def health(self) -> None:
        """Liveness and degradation: always 200 (degraded is not dead);
        "ok" or "degraded" plus every firing alert (SLO burn, watchdog
        stalls, device loss), the watchdog's state under "health", and the
        engine's stats. Open to blocked users."""
        eng = self.server.engine
        active = [a.to_dict() for a in eng.alerts.active()]
        self._send_json(200, {**eng.stats(),
                              "status": "degraded" if active else "ok",
                              "alerts": active, "device": str(eng.device),
                              "kernel_launches": launch_counts()})

    # -- telemetry -----------------------------------------------------------
    def metrics(self) -> None:
        """Prometheus text exposition (format 0.0.4). Scrape-time gauges
        (queue depth per user, the card's HBM, uptime, firing alerts)
        refresh here; hot-path series are already current."""
        self._ident()
        self._send(200, render_prometheus(self.server.engine).encode(),
                   "text/plain; version=0.0.4; charset=utf-8")

    def metrics_json(self) -> None:
        self._ident()
        self._send_json(200, self.server.engine.stats())

    def metrics_snapshot(self) -> None:
        """The raw registry snapshot (mergeable JSON)."""
        self._ident()
        self._send_json(200, REGISTRY.snapshot())

    def debug_trace(self) -> None:
        """Request-lifecycle traces as Chrome trace-event JSON (load in
        chrome://tracing or Perfetto)."""
        self._ident()
        self._send_json(200, self.server.engine.tracer.export_chrome())

    def debug_trace_one(self, rid: str) -> None:
        """One request's timeline as Chrome trace-event JSON, with the
        `stitched` phase summary (one process: no fleet stitching)."""
        self._ident()
        try:
            rid = int(rid)
        except ValueError:
            raise ApiError(400, "request id must be an integer")
        tracer = self.server.engine.tracer
        tr = tracer.find(rid)
        spans = tracer.export_spans([tr]) if tr is not None else []
        if not spans:
            raise ApiError(404, f"no trace for request {rid} (expired "
                                "from the ring, or never existed)")
        self._send_json(200, tracing.merged_chrome(spans, root_origin=tracer.origin))

    def debug_stepprof(self) -> None:
        """The step profiler's ring: per-mode/per-phase p50/p99, the
        per-shape table and recent samples (`?n=` bounds the tails)."""
        self._ident()
        n = self._int_query("n", 128)
        self._send_json(200, stepprof.PROFILER.snapshot(max(1, n)))

    def debug_hbm(self) -> None:
        """The HBM timeline: sampled page-pool state and weight/KV bytes
        per runtime, and on a CUDA device the allocator's allocated and
        reserved bytes and the card's free and total memory (`?n=`)."""
        self._ident()
        n = self._int_query("n", 0)
        self._send_json(200, {
            "period_s": self.server.engine.HBM_SAMPLE_PERIOD_S,
            "timeline": stepprof.PROFILER.hbm_tail(n if n > 0 else None)})

    def debug_profile(self) -> None:
        """Capture a torch.profiler trace of the live engine for N seconds
        and export it as a Chrome trace. The output directory is the
        operator's (OLLAMAMQ_PROFILE_DIR, never the request body), the
        duration is clamped to [0.1, 30] s, one capture runs at a time."""
        self._ident()
        body = self._read_body()
        try:
            seconds = max(0.1, min(float(body.get("seconds", 3.0)), 30.0))
        except (TypeError, ValueError):
            raise ApiError(400, "'seconds' must be a number")
        out_dir = os.environ.get("OLLAMAMQ_PROFILE_DIR",
                                 os.path.join(tempfile.gettempdir(), "ollamamq-profile"))
        srv = self.server
        with srv.profile_lock:
            if srv.profiling:
                raise ApiError(409, "a profile capture is already running")
            srv.profiling = True
        t_start = time.time()
        try:
            path = capture_profile(out_dir, seconds, srv.engine.device)
        except Exception as e:  # noqa: BLE001 — answered, flag cleared
            raise ApiError(500, f"profile capture failed: {e}")
        finally:
            srv.profiling = False
        self._send_json(200, {"status": "success", "trace_dir": out_dir,
                              "trace_file": path, "seconds": seconds,
                              "stepprof": stepprof.PROFILER.window(t_start, time.time())})

    def debug_prefix_cache(self) -> None:
        self._ident()
        self._send_json(200, self.server.engine.prefix_cache_stats())

    def debug_prefix_cache_flush(self) -> None:
        """Evict every unreferenced cached page (pinned prefixes of live
        requests survive), on the engine loop."""
        self._ident()
        self._read_body()
        try:
            freed = self.server.engine.prefix_cache_flush()
        except Exception as e:  # noqa: BLE001 — answered
            raise ApiError(500, f"prefix-cache flush failed: {e}")
        self._send_json(200, {"status": "success", "freed_pages": freed})

    # -- the model registry ------------------------------------------------
    def api_tags(self) -> None:
        self._ident()
        self._send_json(200, self.server.registry.tags_payload())

    def api_ps(self) -> None:
        self._ident()
        self._send_json(200, self.server.registry.ps_payload())

    def api_show(self) -> None:
        self._ident()
        body = self._read_body()
        name = body.get("model") or body.get("name") or ""
        payload = self.server.registry.show_payload(name)
        if payload is None:
            raise ApiError(404, f"model '{name}' not found")
        self._send_json(200, payload)

    def api_version(self) -> None:
        self._ident()
        self._send_json(200, {"version": __version__})

    def api_pull(self) -> None:
        """Load a model onto the engine's device. Streaming (the default):
        NDJSON progress lines, then "success", or an "error" line after
        the 200 is on the wire."""
        self._ident()
        body = self._read_body()
        name = body.get("model") or body.get("name") or ""
        if get_model_config(name) is None:
            raise ApiError(404, f"model '{name}' not found in the registry")
        registry = self.server.registry
        if not body.get("stream", True):
            try:
                registry.pull(name)
            except NotImplementedError as e:
                raise ApiError(501, str(e))
            except Exception as e:  # noqa: BLE001 — answered
                raise ApiError(500, f"failed to load {name}: {e}")
            self._send_json(200, {"status": "success"})
            return

        def line(obj) -> None:
            self._chunk((json.dumps(obj) + "\n").encode())

        try:
            self._start_chunked("application/x-ndjson")
            line({"status": "pulling manifest"})
            line({"status": f"loading {name} into HBM"})
            try:
                registry.pull(name)
                line({"status": "success"})
            except Exception as e:  # noqa: BLE001 — in-band after the 200
                line({"error": f"failed to load {name}: {e}"})
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            raise _ClientGone()

    def api_delete(self) -> None:
        self._ident()
        body = self._read_body()
        name = body.get("model") or body.get("name") or ""
        try:
            ok = self.server.registry.delete(name)
        except RuntimeError as e:  # the model has work in flight
            raise ApiError(409, str(e))
        if not ok:
            raise ApiError(404, f"model '{name}' not found")
        self._send_json(200, {"status": "success"})

    def api_copy(self) -> None:
        self._ident()
        body = self._read_body()
        src, dst = body.get("source", ""), body.get("destination", "")
        if not src or not dst:
            raise ApiError(400, "source and destination required")
        if not self.server.registry.copy(src, dst):
            raise ApiError(404, f"model '{src}' not found")
        self._send_json(200, {"status": "success"})

    def api_create(self) -> None:
        self._ident()
        raise ApiError(501, "model creation from Modelfiles is not supported; "
                            "register checkpoints via --checkpoints at startup")

    def api_push(self) -> None:
        self._ident()
        raise ApiError(501, "pushing models to a remote registry is not supported")

    def api_blobs(self, _digest: str) -> None:
        self._ident()
        raise ApiError(501, "blob upload is not supported by this registry")

    def v1_models(self) -> None:
        self._ident()
        self._send_json(200, self.server.registry.openai_models_payload())

    def v1_model(self, name: str) -> None:
        self._ident()
        entry = self.server.registry.resolve(name)
        if entry is None:
            raise ApiError(404, f"model '{name}' not found")
        self._send_json(200, {"id": entry.name, "object": "model",
                              "created": int(entry.registered_at),
                              "owned_by": "ollamamq-tpu"})

    # -- embeddings --------------------------------------------------------
    def _embed_batch(self, user, ip, model, texts):
        """(vectors, per-input token counts): one embed request per input,
        all enqueued before any is awaited. Generative models embed too
        (causal forward, mean pool); encoders bidirectionally."""
        reqs, counts = [], []
        for t in texts:
            tokens = self._tokenize(model, t)
            counts.append(len(tokens))
            reqs.append(self._enqueue(user, ip, model, Family.OLLAMA, tokens,
                                      SamplingParams(), kind="embed"))
        out = []
        for req in reqs:
            items = list(self._items(req))
            err = next((i for i in items if i.kind == "error"), None)
            if err is not None:
                raise ApiError(500, f"engine error: {err.error}")
            out.append(req.embedding or [])
        return out, counts

    def _embed_inputs(self):
        user, ip = self._ident()
        body = self._read_body()
        model, _cfg = self._model(body)
        return user, ip, model, body

    def api_embed(self) -> None:
        user, ip, model, body = self._embed_inputs()
        inputs = body.get("input", "")
        texts = [inputs] if isinstance(inputs, str) else list(inputs)
        vectors, counts = self._embed_batch(user, ip, model, texts)
        self._send_json(200, {"model": model, "embeddings": vectors,
                              "total_duration": 0, "load_duration": 0,
                              "prompt_eval_count": sum(counts)})

    def api_embeddings_legacy(self) -> None:
        user, ip, model, body = self._embed_inputs()
        vectors, _ = self._embed_batch(user, ip, model, [body.get("prompt", "")])
        self._send_json(200, {"embedding": vectors[0] if vectors else []})

    def v1_embeddings(self) -> None:
        user, ip, model, body = self._embed_inputs()
        inputs = body.get("input", "")
        texts = [inputs] if isinstance(inputs, str) else list(inputs)
        vectors, counts = self._embed_batch(user, ip, model, texts)
        self._send_json(200, {
            "object": "list",
            "data": [{"object": "embedding", "embedding": v, "index": i}
                     for i, v in enumerate(vectors)],
            "model": model,
            "usage": {"prompt_tokens": sum(counts), "total_tokens": sum(counts)}})

    # -- generation --------------------------------------------------------
    def api_generate(self) -> None:
        user, ip = self._ident()
        body = self._read_body()
        model, _cfg = self._model(body)
        sampling = SamplingParams.from_ollama_options(
            body.get("options"), self.server.engine.ecfg.max_new_tokens)
        tokens = self._tokenize(model, body.get("prompt", ""))
        req = self._enqueue(user, ip, model, Family.OLLAMA, tokens, sampling)
        self._ollama_reply(req, model, chat=False,
                           stream=body.get("stream", True))

    def api_chat(self) -> None:
        user, ip = self._ident()
        body = self._read_body()
        model, cfg = self._model(body)
        sampling = SamplingParams.from_ollama_options(
            body.get("options"), self.server.engine.ecfg.max_new_tokens)
        prompt = render_chat(body.get("messages", []), cfg)
        tokens = self._tokenize(model, prompt, add_bos=not template_owns_bos(cfg))
        req = self._enqueue(user, ip, model, Family.OLLAMA, tokens, sampling)
        self._ollama_reply(req, model, chat=True,
                           stream=body.get("stream", True))

    def _ollama_reply(self, req: Request, model: str, chat: bool,
                      stream: bool) -> None:
        def payload(text: str, **extra) -> dict:
            p = {"model": model, "created_at": _now_iso(), **extra}
            if chat:
                p["message"] = {"role": "assistant", "content": text}
            else:
                p["response"] = text
            return p

        if not stream:
            items = self._final_items(req)
            last = items[-1]
            text = "".join(i.text for i in items if i.kind == "token")
            self._send_json(200, payload(text, done=True,
                                         done_reason=_done_reason(last),
                                         token_ids=list(req.generated_ids),
                                         **_gen_stats(req)))
            return

        pending_ids: list = []

        def frames(item: StreamItem):
            if item.kind == "token":
                if item.token_id >= 0:
                    pending_ids.append(item.token_id)
                if not item.text:
                    return
                p = payload(item.text, done=False, req_id=req.req_id,
                            token_ids=pending_ids[:])
                pending_ids.clear()
            elif item.kind == "error":
                p = {"model": model, "created_at": _now_iso(), "done": True,
                     "req_id": req.req_id, "done_reason": _error_reason(item),
                     "error": item.error}
            else:
                p = payload("", done=True, done_reason=_done_reason(item),
                            req_id=req.req_id, token_ids=pending_ids[:],
                            **_gen_stats(req))
            yield (json.dumps(p) + "\n").encode()

        self._stream(req, "application/x-ndjson", frames)

    def v1_chat_completions(self) -> None:
        user, ip = self._ident()
        body = self._read_body()
        model, cfg = self._model(body)
        sampling = SamplingParams.from_openai(
            body, self.server.engine.ecfg.max_new_tokens)
        prompt = render_chat(body.get("messages", []), cfg)
        tokens = self._tokenize(model, prompt, add_bos=not template_owns_bos(cfg))
        req = self._enqueue(user, ip, model, Family.OPENAI, tokens, sampling)
        self._openai_reply(req, model, f"chatcmpl-{uuid.uuid4().hex[:24]}",
                           chat=True, stream=body.get("stream", False))

    def v1_completions(self) -> None:
        """OpenAI text completions: one choice per prompt of a list; a
        stream carries one prompt."""
        user, ip = self._ident()
        body = self._read_body()
        model, _cfg = self._model(body)
        prompt = body.get("prompt", "")
        prompts = (prompt if isinstance(prompt, list) else [prompt]) or [""]
        sampling = SamplingParams.from_openai(
            body, self.server.engine.ecfg.max_new_tokens)
        rid = f"cmpl-{uuid.uuid4().hex[:24]}"
        if body.get("stream", False):
            if len(prompts) > 1:
                raise ApiError(400, "streaming with multiple prompts is not supported")
            req = self._enqueue(user, ip, model, Family.OPENAI,
                                self._tokenize(model, prompts[0]), sampling)
            self._openai_reply(req, model, rid, chat=False, stream=True)
            return
        reqs = [self._enqueue(user, ip, model, Family.OPENAI,
                              self._tokenize(model, p), sampling) for p in prompts]
        choices, usage_p, usage_c = [], 0, 0
        for i, req in enumerate(reqs):
            items = self._final_items(req)
            choices.append({"index": i,
                            "text": "".join(it.text for it in items
                                            if it.kind == "token"),
                            "finish_reason": _done_reason(items[-1])})
            usage_p += req.stats.prompt_tokens
            usage_c += req.stats.completion_tokens
        self._send_json(200, {
            "id": rid, "object": "text_completion", "created": int(time.time()),
            "model": model, "choices": choices,
            "usage": {"prompt_tokens": usage_p, "completion_tokens": usage_c,
                      "total_tokens": usage_p + usage_c}})

    def _openai_reply(self, req: Request, model: str, rid: str, chat: bool,
                      stream: bool) -> None:
        """One JSON body, or server-sent events ending in [DONE]: chat
        chunks carry deltas (the first with the role), completions text."""
        created = int(time.time())
        obj = "chat.completion" if chat else "text_completion"
        if not stream:
            items = self._final_items(req)
            text = "".join(i.text for i in items if i.kind == "token")
            choice = {"index": 0, "finish_reason": _done_reason(items[-1])}
            if chat:
                choice["message"] = {"role": "assistant", "content": text}
            else:
                choice["text"] = text
            p, c = req.stats.prompt_tokens, req.stats.completion_tokens
            self._send_json(200, {
                "id": rid, "object": obj, "created": created, "model": model,
                "choices": [choice],
                "usage": {"prompt_tokens": p, "completion_tokens": c,
                          "total_tokens": p + c}})
            return
        first = [True]

        def sse(choice: dict) -> bytes:
            return ("data: " + json.dumps({
                "id": rid, "object": obj + ".chunk" if chat else obj,
                "created": created, "model": model, "choices": [choice]})
                + "\n\n").encode()

        def frames(item: StreamItem):
            if item.kind == "token":
                if not item.text:
                    return
                if not chat:
                    yield sse({"index": 0, "text": item.text, "finish_reason": None})
                    return
                delta = {"content": item.text}
                if first[0]:
                    delta["role"] = "assistant"
                    first[0] = False
                yield sse({"index": 0, "delta": delta, "finish_reason": None})
            elif item.kind == "error":
                yield ("data: " + json.dumps({"error": item.error,
                                              "reason": _error_reason(item)})
                       + "\n\n").encode()
                yield b"data: [DONE]\n\n"
            else:
                fin = {"index": 0, "finish_reason": _done_reason(item)}
                fin.update({"delta": {}} if chat else {"text": ""})
                yield sse(fin)
                yield b"data: [DONE]\n\n"

        self._stream(req, "text/event-stream", frames)

    # -- latency attribution and the incident bundle -----------------------
    def debug_requests(self) -> None:
        """Every in-flight request (its current phase and how long it has
        sat there) and the most recent finished timelines (`?recent=`)."""
        self._ident()
        recent = self._int_query("recent", 50)
        self._send_json(200, attribution.summarize(self.server.engine.tracer,
                                                   recent=recent))

    def debug_request(self, rid: str) -> None:
        """One request's phase timeline (milliseconds per phase, summing
        to its wall clock) and its raw lifecycle events."""
        self._ident()
        try:
            rid = int(rid)
        except ValueError:
            raise ApiError(400, "request id must be an integer")
        tr = self.server.engine.tracer.find(rid)
        if tr is None:
            raise ApiError(404, f"no trace for request {rid} (expired from "
                                "the ring, or never existed)")
        self._send_json(200, attribution.timeline(tr))

    def debug_bundle(self) -> None:
        """One-shot diagnostics: config, models, stats, health, alerts,
        SLOs, metrics, step profile, HBM timeline, request timelines and
        prefix-cache stats in one JSON document, each section
        error-contained and secret-shaped keys redacted."""
        self._ident()
        eng = self.server.engine
        bundle = {"generated_at": _now_iso(), "version": __version__,
                  "uptime_s": round(time.time() - eng.started_at, 1)}

        def section(name, fn):
            try:
                bundle[name] = json.loads(json.dumps(fn(), default=str))
            except Exception as e:  # noqa: BLE001 — a sick engine still answers
                bundle[name] = {"error": f"{type(e).__name__}: {e}"}

        section("config", lambda: _redact({
            f.name: getattr(eng.ecfg, f.name)
            for f in dataclasses.fields(eng.ecfg)}))
        section("env", lambda: _redact({
            k: v for k, v in os.environ.items()
            if k.startswith(("OLLAMAMQ_", "CUDA_", "TORCH_"))}))
        section("models", eng.loaded_models)
        section("stats", eng.stats)
        section("health", lambda: eng.health.status() if eng.health else None)
        section("alerts", eng.alerts.to_dict)
        section("slo", eng.slo.summary)
        section("metrics", lambda: render_prometheus(eng))
        section("stepprof", lambda: stepprof.PROFILER.snapshot(64))
        section("hbm", lambda: stepprof.PROFILER.hbm_tail(64))
        section("requests", lambda: attribution.summarize(eng.tracer, recent=50))
        section("prefix_cache", eng.prefix_cache_stats)
        self._send_json(200, bundle)


def render_prometheus(engine) -> str:
    """The registry as Prometheus text after refreshing the scrape-time
    gauges: uptime, queue depth per user (rebuilt so departed users'
    series go), the card's HBM (omitted on the CPU, never a fake 0) and
    the firing alerts (rebuilt so resolved ones go)."""
    tm.UPTIME_SECONDS.set(time.time() - engine.started_at)
    tm.QUEUE_DEPTH.clear()
    for user, row in engine.core.snapshot().get("users", {}).items():
        tm.QUEUE_DEPTH.labels(user=user).set(row.get("queued", 0))
    tm.HBM_USED_BYTES.clear()
    tm.HBM_TOTAL_BYTES.clear()
    for c in engine.chip_stats():
        if c["memory_stats"]:
            lab = {"chip": str(c["id"]), "host": str(c["process"])}
            tm.HBM_USED_BYTES.labels(**lab).set(c["hbm_used"])
            tm.HBM_TOTAL_BYTES.labels(**lab).set(c["hbm_total"])
    tm.SLO_ALERTS_FIRING.clear()
    for a in engine.alerts.active():
        tm.SLO_ALERTS_FIRING.labels(alert=a.name, severity=a.severity).set(1)
    return REGISTRY.render()


def capture_profile(out_dir: str, seconds: float, device) -> str:
    """torch.profiler over the live process for `seconds` (CPU activity,
    plus CUDA on a CUDA engine), exported as a Chrome trace; returns its
    path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        time.sleep(seconds)
    path = os.path.join(out_dir, f"trace-{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    return path


class OllamaServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 11434,
                 timeout_s: float = 300.0):
        super().__init__((host, port), Handler)
        self.engine = engine
        self.registry = ModelRegistry(engine)
        self.timeout_s = timeout_s
        self.profile_lock = threading.Lock()
        self.profiling = False


def serve_in_thread(engine, host: str = "127.0.0.1", port: int = 0,
                    timeout_s: float = 300.0):
    """Start `engine` and an OllamaServer on (host, port) — port 0 picks a
    free one — with serve_forever on a daemon thread. Returns the server;
    server.server_address has the bound port. Stop with stop_server()."""
    engine.start()
    server = OllamaServer(engine, host, port, timeout_s)
    t = threading.Thread(target=server.serve_forever, name="http", daemon=True)
    t.start()
    server.thread = t
    return server


def stop_server(server: Optional[OllamaServer]) -> None:
    if server is None:
        return
    server.shutdown()
    server.server_close()
    server.thread.join(timeout=10)
    server.engine.stop()
