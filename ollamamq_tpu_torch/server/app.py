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
    torch.profiler capture exported as a Chrome trace), GET
    /debug/journal (the decision journal's ring, filtered);
  with a WAL (--wal-dir): GET /api/stream/{req_id}?from=N, the
    resumable stream, across a restart too;
  serving a fleet router: GET /admin/fleet, POST /admin/drain/{replica},
    POST /admin/preempt/{replica}, GET /admin/tiers and POST
    /admin/retier/{replica} (404 on an untiered fleet, 400 for an
    unknown tier, 409 for a refused move); /metrics federates the HTTP members'
    series with a `replica` label, /debug/bundle gathers a section per
    member and /debug/trace/{req_id} stitches every member's spans;
  serving an engine (a fleet member): the KV migration wire, POST
    /admin/migrate/export, /import (a packed blob in; the continuation
    streams out as /api/generate NDJSON), /commit and /abort; GET
    /debug/trace?ctx= exports the spans of one fleet trace context;
  router HA: GET /admin/ha/sync?seq=N[&snap=1][&confirm=1] on a router
    (409 unless it is an HA primary right now), POST /admin/ha/register
    on a member, and the member-side epoch fence: a call carrying
    X-Router-Epoch adopts a higher epoch and gets 409 below the adopted
    one (/api/generate, /api/embed and the migration wire), persisted in
    <wal-dir>/member_epoch.json. /health carries the role block (role,
    epoch, sync lag; a standby reports status "standby" or "promoting")
    or, on a member, the adopted epoch.
With --allow-all-routes every other path answers 501 (no backend to
proxy to), else 404. Every
route but /health answers 403 to a blocked user or IP. Image inputs
(`images` on /api/generate and on chat messages, `image_url` content
parts) are accepted and ignored, and the reply says so in a
`warnings` field. A
request's `traceparent` header (a fleet router's) makes its trace a
span of that context, and X-Deadline-Ms sets its deadline; a streamed
reply's X-Request-ID header names the request id its frames carry. A
request naming a model the registry does not hold (never pulled, or
deleted) answers 404, as Ollama does.

Bounded admission answers 429 (this user's queue is full) or 503 (the
whole queue is full) with a Retry-After from the observed completion
rate, and the JAX package's body. A body over MAX_BODY (1 GB, the JAX
package's limit) answers 413 unread.
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
from ollamamq_tpu_torch.engine import kv_cache as kvc
from ollamamq_tpu_torch.engine.engine import (MigrationError, QueueFullError,
                                              TokenIdError)
from ollamamq_tpu_torch.engine.request import FinishReason, Request, StreamItem
from ollamamq_tpu_torch.engine.tokenizer import ByteTokenizer
from ollamamq_tpu_torch.ops.cuda import launch_counts
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.registry import ModelRegistry
from ollamamq_tpu_torch.server.templates import render_chat, template_owns_bos
from ollamamq_tpu_torch.telemetry import REGISTRY, attribution, stepprof, tracing
from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.telemetry.journal import EVENTS

log = logging.getLogger("ollamamq.torch.server")

MAX_BODY = 1024 * 1024 * 1024  # 1 GB, the JAX package's client_max_size

# No vision path exists: a request's images are ignored, and the reply
# carries this warning so the text-only answer is never silent.
_IMAGES_IGNORED = ("images ignored: this deployment has no vision model; "
                   "the response was generated from text inputs only")


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


def _warnings(req: Request) -> dict:
    """The reply's `warnings` field: present only when the request's
    images were ignored."""
    return ({"warnings": [_IMAGES_IGNORED]}
            if getattr(req, "images_ignored", False) else {})


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
        ("GET", "/api/stream/{req_id}"): "api_stream_resume",
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
        ("GET", "/debug/journal"): "debug_journal",
        ("POST", "/debug/profile"): "debug_profile",
        ("GET", "/debug/stepprof"): "debug_stepprof",
        ("GET", "/debug/hbm"): "debug_hbm",
        ("GET", "/debug/prefix_cache"): "debug_prefix_cache",
        ("POST", "/debug/prefix_cache"): "debug_prefix_cache_flush",
    }
    # Fleet admin: only when the engine IS a fleet router.
    FLEET_ROUTES = {
        ("GET", "/admin/fleet"): "admin_fleet",
        ("POST", "/admin/drain/{replica}"): "admin_drain",
        ("POST", "/admin/preempt/{replica}"): "admin_preempt",
        ("GET", "/admin/tiers"): "admin_tiers",
        ("POST", "/admin/retier/{replica}"): "admin_retier",
        # Router HA: the warm standby's replication poll. Answered on
        # every router, 409 unless the engine is an HA primary right now
        # (a promoted standby serves it without a new server).
        ("GET", "/admin/ha/sync"): "admin_ha_sync",
    }
    # The KV migration wire: only when the engine is an engine (a fleet
    # member); the router's HttpMember speaks it.
    MIGRATE_ROUTES = {
        ("POST", "/admin/migrate/export"): "admin_migrate_export",
        ("POST", "/admin/migrate/import"): "admin_migrate_import",
        ("POST", "/admin/migrate/commit"): "admin_migrate_commit",
        ("POST", "/admin/migrate/abort"): "admin_migrate_abort",
        # Router HA: a (newly promoted) router claims this member under
        # its epoch; older epochs are fenced from here on.
        ("POST", "/admin/ha/register"): "admin_ha_register",
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
        routes = dict(self.ROUTES)
        eng = self.server.engine
        if hasattr(eng, "drain_replica"):
            routes.update(self.FLEET_ROUTES)
        if hasattr(eng, "export_stream"):
            routes.update(self.MIGRATE_ROUTES)
        for (m, pattern), name in routes.items():
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
        if self.server.allow_all_routes:
            # The catch-all route: every method on every other path.
            return self.fallback, None
        if allowed:
            raise ApiError(405, f"method {method} not allowed for {path}")
        raise ApiError(404, f"no route for {method} {path}")

    def _dispatch(self, method: str) -> None:
        self.method = method
        try:
            n = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            n = -1
        if n < 0 or n > MAX_BODY:
            # Refused unread (nothing is allocated for it); the unread body
            # ends the connection.
            self.close_connection = True
            status, msg = ((413, f"request body of {n} bytes exceeds the "
                                 f"{MAX_BODY}-byte limit") if n > 0
                           else (400, "invalid Content-Length"))
            try:
                self._send_json(status, {"error": msg})
            except _ClientGone:
                pass
            return
        # The body is read whatever the route does with it: one left unread
        # would be parsed as the connection's next request.
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

    def _start_chunked(self, content_type: str,
                       headers: Optional[dict] = None) -> None:
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Cache-Control", "no-cache")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
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

    def _check_epoch(self, kind: str) -> None:
        """The epoch fence on a member-facing placement or migration
        call (OllamaServer.check_epoch)."""
        self.server.check_epoch(self.headers.get("X-Router-Epoch"), kind,
                                self.path.partition("?")[0])

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

    def _trace_ctx(self) -> Optional[str]:
        """The propagated fleet trace context (`traceparent`): a fleet
        router stamps it on member requests so every process's spans
        stitch under the client's request id. None mints a fresh one."""
        ctx = self.headers.get(tracing.TRACEPARENT_HEADER)
        return ctx if ctx and tracing.valid_ctx(ctx) else None

    def _apply_deadline(self, sampling) -> None:
        """X-Deadline-Ms (milliseconds from arrival) wins over the body's
        deadline_ms; junk is a 400, never ignored."""
        hdr = self.headers.get("X-Deadline-Ms")
        if hdr is None:
            return
        try:
            ms = float(hdr)
        except ValueError:
            raise ApiError(400, "X-Deadline-Ms must be a number "
                                "(milliseconds from arrival)")
        if ms <= 0:
            raise ApiError(400, "X-Deadline-Ms must be > 0")
        sampling.deadline_ms = ms

    def _enqueue(self, user, ip, model, family, tokens, sampling,
                 kind: str = "generate", raw_prompt: str = "",
                 context_ids=None) -> Request:
        try:
            return self.server.engine.enqueue_request(
                user, ip, model, family, tokens, sampling, kind=kind,
                raw_prompt=raw_prompt, context_ids=context_ids,
                trace_ctx=self._trace_ctx())
        except BlockedError as e:
            raise ApiError(403, str(e))
        except TokenIdError as e:
            raise ApiError(400, str(e))
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
        a vanished client cancels the request. X-Request-ID carries the
        request id from the start: frames carry it only with text, and a
        fleet router's /admin/migrate export needs it before any."""
        try:
            self._start_chunked(content_type,
                                {"X-Request-ID": str(req.req_id)})
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
    def fallback(self) -> None:
        """--allow-all-routes: any path without a handler answers 501
        (there is no backend to proxy it to)."""
        self._ident()
        raise ApiError(501, f"route {self.path.partition('?')[0]} has no "
                            "native handler (--allow-all-routes only exposes "
                            "the fallback, there is no backend to proxy to)")

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
        payload = {**eng.stats(), "status": "degraded" if active else "ok",
                   "alerts": active, "device": str(eng.device),
                   "kernel_launches": launch_counts()}
        if eng.durability is not None:
            # Not ready while the WAL recovery pass is still re-admitting.
            payload["wal"] = eng.durability.status()
            if payload["wal"]["recovering"]:
                payload["status"] = "recovering"
        # Router HA role block. A standby answers status "standby" (not
        # "degraded"): an idle standby is healthy; during promotion the
        # status says so.
        hs_fn = getattr(eng, "ha_status", None)
        hs = hs_fn() if hs_fn is not None else None
        if hs is not None:
            payload["role"] = hs.get("role")
            payload["epoch"] = hs.get("epoch")
            payload["sync_lag_records"] = hs.get("sync_lag_records")
            if hs.get("role") in ("standby", "promoting"):
                payload["status"] = hs["role"]
        elif self.server.ha_epoch:
            # Member side: the adopted fencing epoch, so the router's
            # heartbeat can spot a restarted member that regressed below
            # the fleet epoch and re-register it.
            payload["epoch"] = self.server.ha_epoch
        self._send_json(200, payload)

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
        chrome://tracing or Perfetto). `?ctx=<traceparent>` returns this
        process's raw spans of that fleet trace context instead: the
        stitching wire a fleet router reads."""
        self._ident()
        tracer = self.server.engine.tracer
        ctx = self.query.get("ctx")
        if ctx is not None:
            if not tracing.valid_ctx(ctx):
                raise ApiError(400, "'ctx' must be a traceparent-shaped "
                                    "trace context")
            self._send_json(200, {"ctx": ctx, "spans": tracer.export_spans(
                tracer.find_ctx(ctx))})
            return
        self._send_json(200, tracer.export_chrome())

    def debug_trace_one(self, rid: str) -> None:
        """One request's timeline as Chrome trace-event JSON, with the
        `stitched` phase summary; on a fleet router, every member's spans
        of the stream's context stitched under the router's root."""
        self._ident()
        try:
            rid = int(rid)
        except ValueError:
            raise ApiError(400, "request id must be an integer")
        eng = self.server.engine
        tracer = eng.tracer
        spans_fn = getattr(eng, "fleet_trace_spans", None)
        if spans_fn is not None:
            spans = spans_fn(rid)
        else:
            tr = tracer.find(rid)
            spans = tracer.export_spans([tr]) if tr is not None else []
        if not spans:
            raise ApiError(404, f"no trace for request {rid} (expired "
                                "from the ring, or never existed)")
        self._send_json(200, tracing.merged_chrome(spans, root_origin=tracer.origin))

    def debug_journal(self) -> None:
        """The decision journal's ring, newest last, each record with the
        inputs of its decision. Filters: `?n=` (default 200), `?req_id=`,
        `?user=`, `?kind=` (an unknown kind is a 400 naming the
        vocabulary)."""
        self._ident()
        n = self._int_query("n", 200)
        req_id = (self._int_query("req_id", 0)
                  if self.query.get("req_id") is not None else None)
        kind = self.query.get("kind")
        if kind is not None and kind not in EVENTS:
            raise ApiError(400, f"unknown event kind '{kind}' "
                                f"(vocabulary: {', '.join(EVENTS)})")
        journal = self.server.engine.journal
        self._send_json(200, {**journal.snapshot(), "events": journal.tail(
            n=n, req_id=req_id, user=self.query.get("user"), kind=kind)})

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
                                      SamplingParams(), kind="embed",
                                      raw_prompt=t))
        out = []
        for req in reqs:
            items = list(self._items(req))
            err = next((i for i in items if i.kind == "error"), None)
            if err is not None:
                raise ApiError(500, f"engine error: {err.error}")
            out.append(req.embedding or [])
        return out, counts

    def _embed_inputs(self, fence: bool = False):
        user, ip = self._ident()
        if fence:
            self._check_epoch("placement")
        body = self._read_body()
        model, _cfg = self._model(body)
        return user, ip, model, body

    def api_embed(self) -> None:
        user, ip, model, body = self._embed_inputs(fence=True)
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
        # A fenced ex-primary must not place work here (member side).
        self._check_epoch("placement")
        body = self._read_body()
        model, _cfg = self._model(body)
        sampling = SamplingParams.from_ollama_options(
            body.get("options"), self.server.engine.ecfg.max_new_tokens)
        self._apply_deadline(sampling)
        prompt = body.get("prompt", "")
        tokens = self._tokenize(model, prompt)
        # Ollama's `context`: ids from an earlier turn. The engine
        # prefills prompt + these ids and continues after them;
        # num_predict still budgets new tokens only.
        context = body.get("context") or []
        if context and not (isinstance(context, list) and all(
                isinstance(t, int) and not isinstance(t, bool) for t in context)):
            raise ApiError(400, "'context' must be a list of token ids")
        req = self._enqueue(user, ip, model, Family.OLLAMA, tokens, sampling,
                            raw_prompt=prompt, context_ids=context or None)
        if body.get("images"):
            req.images_ignored = True
        self._ollama_reply(req, model, chat=False,
                           stream=body.get("stream", True))

    def api_chat(self) -> None:
        user, ip = self._ident()
        body = self._read_body()
        model, cfg = self._model(body)
        sampling = SamplingParams.from_ollama_options(
            body.get("options"), self.server.engine.ecfg.max_new_tokens)
        self._apply_deadline(sampling)
        messages = body.get("messages", [])
        prompt = render_chat(messages, cfg)
        tokens = self._tokenize(model, prompt, add_bos=not template_owns_bos(cfg))
        req = self._enqueue(user, ip, model, Family.OLLAMA, tokens, sampling,
                            raw_prompt=prompt)
        if any(isinstance(m, dict) and m.get("images") for m in messages):
            req.images_ignored = True
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
                                         **_gen_stats(req), **_warnings(req)))
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
                            **_gen_stats(req), **_warnings(req))
            yield (json.dumps(p) + "\n").encode()

        self._stream(req, "application/x-ndjson", frames)

    def api_stream_resume(self, rid: str) -> None:
        """Reattach to a stream by the req_id its NDJSON frames carried:
        every frame from token index `?from=N` (default 0) out of the
        durability registry, then the live ones up to the terminal.
        Works across a restart (the recovery pass keys the registry by
        the pre-crash id). An observer: disconnecting cancels nothing.
        404 without a WAL, as the route does not exist there."""
        self._ident()
        dur = self.server.engine.durability
        if dur is None:
            raise ApiError(404, f"no route for GET /api/stream/{rid}")
        try:
            rid = int(rid)
        except ValueError:
            raise ApiError(400, "request id must be an integer")
        try:
            from_n = int(self.query.get("from", "0"))
        except ValueError:
            raise ApiError(400, "'from' must be an integer token index")
        if from_n < 0:
            raise ApiError(400, "'from' must be >= 0")
        entry = dur.registry.find(rid)
        if entry is None:
            raise ApiError(404, f"no resumable stream for request {rid} "
                                "(unknown id, or expired from the stream "
                                "archive)")

        def frame(**fields) -> bytes:
            p = {"model": "", "created_at": _now_iso(), "req_id": entry.rid,
                 **fields}
            return (json.dumps(p) + "\n").encode()

        deadline = time.monotonic() + self.server.timeout_s
        sent = 0         # frames consumed from the entry
        tokens_seen = 0  # id-carrying frames passed (the ?from cursor)
        try:
            self._start_chunked("application/x-ndjson")
            while True:
                frames, terminal = entry.snapshot(sent)
                for tid, text in frames:
                    sent += 1
                    skip = tokens_seen < from_n
                    if tid >= 0:
                        tokens_seen += 1
                    if skip:
                        continue  # inside the prefix the client has
                    extra = {"token_ids": [tid]} if tid >= 0 else {}
                    self._chunk(frame(done=False, response=text, **extra))
                # The snapshot is atomic and a terminal is final: every
                # frame has been sent by now.
                if terminal is not None:
                    extra = ({"error": terminal["error"]}
                             if terminal.get("error") else {})
                    self._chunk(frame(done=True, response="",
                                      done_reason=terminal.get("reason", "stop"),
                                      **extra))
                    break
                if time.monotonic() > deadline:
                    self._chunk(frame(done=True, done_reason="error",
                                      error="resume timeout"))
                    break
                time.sleep(0.02)
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            raise _ClientGone()

    def v1_chat_completions(self) -> None:
        user, ip = self._ident()
        body = self._read_body()
        model, cfg = self._model(body)
        sampling = SamplingParams.from_openai(
            body, self.server.engine.ecfg.max_new_tokens)
        messages = body.get("messages", [])
        prompt = render_chat(messages, cfg)
        tokens = self._tokenize(model, prompt, add_bos=not template_owns_bos(cfg))
        req = self._enqueue(user, ip, model, Family.OPENAI, tokens, sampling,
                            raw_prompt=prompt)
        if any(isinstance(p, dict) and p.get("type") == "image_url"
               for m in messages if isinstance(m, dict)
               for p in (m.get("content") if isinstance(m.get("content"),
                                                        list) else [])):
            req.images_ignored = True
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
                                self._tokenize(model, prompts[0]), sampling,
                                raw_prompt=prompts[0])
            self._openai_reply(req, model, rid, chat=False, stream=True)
            return
        reqs = [self._enqueue(user, ip, model, Family.OPENAI,
                              self._tokenize(model, p), sampling, raw_prompt=p)
                for p in prompts]
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
                          "total_tokens": p + c}, **_warnings(req)})
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
                if getattr(req, "images_ignored", False):
                    yield ("data: " + json.dumps({
                        "id": rid, "object": obj + ".chunk" if chat else obj,
                        "created": created, "model": model, "choices": [],
                        "warnings": [_IMAGES_IGNORED]}) + "\n\n").encode()
                fin = {"index": 0, "finish_reason": _done_reason(item)}
                fin.update({"delta": {}} if chat else {"text": ""})
                yield sse(fin)
                yield b"data: [DONE]\n\n"

        self._stream(req, "text/event-stream", frames)

    # -- fleet admin (a fleet router) ----------------------------------------
    def _positive_float(self, body: dict, key: str) -> Optional[float]:
        if key not in body:
            return None
        try:
            val = float(body[key])
        except (TypeError, ValueError):
            raise ApiError(400, f"'{key}' must be a number")
        if val <= 0:
            raise ApiError(400, f"'{key}' must be > 0")
        return val

    def admin_fleet(self) -> None:
        """Fleet status: each replica's state (healthy, ejected,
        draining), heartbeat age, in-flight streams and firing alerts,
        plus the placement policy and the failover and migration counts."""
        self._ident()
        self._send_json(200, self.server.engine.fleet_status())

    def admin_drain(self, replica: str) -> None:
        """Quiesce one replica: no new placements, its live streams
        migrate off (stragglers past the drain timeout fail over), then
        it hot-restarts and rejoins. 404 for an unknown replica, 409 for
        an ejected one. Poll GET /admin/fleet until it is healthy."""
        self._ident()
        timeout_s = self._positive_float(self._read_body(), "timeout_s")
        try:
            out = self.server.engine.drain_replica(replica,
                                                   timeout_s=timeout_s)
        except KeyError as e:
            raise ApiError(404, str(e.args[0]) if e.args else str(e))
        except RuntimeError as e:
            raise ApiError(409, str(e))
        self._send_json(200, {"status": "success", **out})

    def admin_preempt(self, replica: str) -> None:
        """Serve a preemptible replica a termination notice (spot
        reclamation): its live streams migrate off within the notice
        window, then it leaves the fleet. Body: {"notice_s": N?}
        (default: the drain timeout). 400 for a replica not flagged
        preemptible."""
        self._ident()
        notice_s = self._positive_float(self._read_body(), "notice_s")
        try:
            out = self.server.engine.preempt_replica(replica,
                                                     notice_s=notice_s)
        except KeyError as e:
            raise ApiError(404, str(e.args[0]) if e.args else str(e))
        except ValueError as e:
            raise ApiError(400, str(e))
        except RuntimeError as e:
            raise ApiError(409, str(e))
        self._send_json(200, {"status": "success", **out})

    def admin_tiers(self) -> None:
        """Tiered-fleet status: per-tier membership and states, TTFT
        burn rates and overflow state, the balancer's class-mix EMA,
        and overflow/regroup counters. 404 on an untiered fleet."""
        self._ident()
        tiers = getattr(self.server.engine, "tiers", None)
        if tiers is None:
            raise ApiError(404, "fleet is untiered (--tiers not set)")
        self._send_json(200, tiers.status())

    def admin_retier(self, replica: str) -> None:
        """Move one replica to the other tier: drain, migrate its live
        streams off, hot-restart at the target tier's TP width (or
        re-label an HTTP member), rejoin. Body: {"tier":
        "interactive"|"bulk", "timeout_s": N?}. Poll GET /admin/tiers
        until the regroup commits (tier_regroup done in the journal)."""
        self._ident()
        body = self._read_body()
        tier = body.get("tier")
        if not isinstance(tier, str) or not tier:
            raise ApiError(400, "'tier' must name the target tier")
        timeout_s = self._positive_float(body, "timeout_s")
        try:
            out = self.server.engine.retier_replica(replica, tier,
                                                    timeout_s=timeout_s,
                                                    why="admin")
        except KeyError as e:
            raise ApiError(404, str(e.args[0]) if e.args else str(e))
        except ValueError as e:
            raise ApiError(400, str(e))
        except RuntimeError as e:
            raise ApiError(409, str(e))
        self._send_json(200, {"status": "success", **out})

    # -- router HA -----------------------------------------------------------
    def admin_ha_sync(self) -> None:
        """The warm standby's replication poll: `?seq=N` acks everything
        through N and fetches what follows (records, or a whole-file WAL
        snapshot on cold start / ring overrun) plus the shadow-state
        blob. `snap=1` is the standby's one-time initial-snapshot
        request, `confirm=1` its caught-up handover ack (the only poll
        that releases a SIGTERM wait). 409 unless this router is an HA
        primary right now: a standby polled by mistake must not serve an
        empty stream as truth."""
        self._ident()
        ha = getattr(self.server.engine, "ha", None)
        if ha is None or not hasattr(ha, "sync_batch"):
            raise ApiError(409, "not an HA primary (no replication "
                                "stream here)")
        seq = self._int_query("seq", 0)
        resp = ha.sync_batch(seq, want_snapshot=self.query.get("snap") == "1",
                             confirm_handover=self.query.get("confirm") == "1")
        self._send_json(200, resp)
        ha.sync_reply_sent(resp)

    def admin_ha_register(self) -> None:
        """A router (usually a freshly promoted standby) claims this
        member under its epoch. Equal-or-higher adopts; lower is the
        zombie ex-primary and fences (409 + journal + metric)."""
        self._ident()
        body = self._read_body()
        try:
            epoch = int(body["epoch"])
        except (KeyError, TypeError, ValueError):
            raise ApiError(400, "'epoch' must be an integer")
        self.server.check_epoch(epoch, "register",
                                self.path.partition("?")[0])
        self._send_json(200, {"ok": True, "epoch": epoch})

    # -- the KV migration wire (a fleet member) ------------------------------
    def _migrate_rid(self, body: dict) -> int:
        try:
            return int(body["req_id"])
        except (KeyError, TypeError, ValueError):
            raise ApiError(400, "'req_id' must be an integer")

    def admin_migrate_export(self) -> None:
        """Phase 1 of the two-phase handoff, source side: snapshot and
        PARK one live stream's decode slot and ship it as a binary blob.
        The parked state waits for /admin/migrate/commit (the target
        acknowledged) or /abort (recompute). 409 when the request holds
        no migratable decode state."""
        self._ident()
        self._check_epoch("migrate")
        body = self._read_body()
        rid = self._migrate_rid(body)
        try:
            budget = min(60.0, max(0.1, float(body.get("timeout_s", 10.0))))
        except (TypeError, ValueError):
            raise ApiError(400, "'timeout_s' must be a number")
        blob = self.server.engine.export_stream(
            rid, time.monotonic() + budget)
        if blob is None:
            raise ApiError(409, f"request {rid} holds no migratable decode "
                                "state")
        self._send(200, kvc.pack_migration_blob(blob),
                   "application/octet-stream")

    def admin_migrate_import(self) -> None:
        """Target side: install a shipped stream straight into a decode
        slot and stream its continuation as /api/generate NDJSON. The 200
        status line is the import acknowledgement the source's commit
        waits on, sent only once the slot is installed. 400 on a foreign
        blob (an id outside the model's vocabulary included), 409 when
        nothing landed (the caller recomputes)."""
        _user, ip = self._ident()
        self._check_epoch("migrate")
        try:
            blob = kvc.unpack_migration_blob(self._raw)
        except ValueError as e:
            raise ApiError(400, f"bad migration blob: {e}")
        deadline = None
        hdr = self.headers.get("X-Deadline-Ms")
        if hdr is not None:
            try:
                deadline = time.monotonic() + max(1.0, float(hdr)) / 1e3
            except ValueError:
                raise ApiError(400, "X-Deadline-Ms must be a number")
        try:
            req = self.server.engine.import_stream(
                blob, ip=ip, deadline=deadline, trace_ctx=self._trace_ctx())
        except TokenIdError as e:
            raise ApiError(400, f"bad migration blob: {e}")
        except MigrationError as e:
            raise ApiError(409, f"migration import failed: {e}")
        model = req.model or (blob.get("request") or {}).get("model", "")
        self._ollama_reply(req, model, chat=False, stream=True)

    def admin_migrate_commit(self) -> None:
        self._migrate_resolve(commit=True)

    def admin_migrate_abort(self) -> None:
        self._migrate_resolve(commit=False)

    def _migrate_resolve(self, commit: bool) -> None:
        """Phase 2: release the parked source state (commit and abort
        free alike; abort journals why). 404 when nothing is parked under
        that id."""
        self._ident()
        self._check_epoch("migrate")
        body = self._read_body()
        rid = self._migrate_rid(body)
        why = str(body.get("why") or "transfer_failed")
        if not self.server.engine.resolve_export(rid, commit=commit, why=why):
            raise ApiError(404, f"no parked migration export for request "
                                f"{rid}")
        self._send_json(200, {"status": "success", "req_id": rid})

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
        journal = self.server.engine.journal
        tr = self.server.engine.tracer.find(rid)
        if tr is None:
            # A WAL-recovered stream asked for by its pre-crash id: the
            # recovery pass journaled which id it was re-admitted under.
            alias = _recovered_as(journal, rid)
            if alias is not None:
                self._send_json(200, {
                    "req_id": rid, "state": "recovered",
                    "recovered_as": alias,
                    "timeline": f"/debug/requests/{alias}",
                    "note": ("this id predates a restart; the WAL recovery "
                             f"pass re-admitted the stream as request {alias}")})
                return
            raise ApiError(404, f"no trace for request {rid} (expired from "
                                "the ring, or never existed)")
        out = attribution.timeline(tr)
        # The request's slice of the journal (why it was admitted, batched,
        # preempted), and the WAL cross-links both ways.
        out["journal"] = journal.tail(n=100, req_id=rid)
        for rec in journal.tail(None, kind="recover_replay"):
            if rec.get("req_id") == rid and rec.get("wal_rid") is not None:
                out["wal_rid"] = rec["wal_rid"]
                out["pre_crash_timeline"] = f"/debug/requests/{rec['wal_rid']}"
            elif rec.get("wal_rid") == rid:
                out["recovered_as"] = rec.get("req_id")
        self._send_json(200, out)

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
        section("journal", lambda: _redact(
            {**eng.journal.snapshot(), "events": eng.journal.tail(n=200)}))
        if hasattr(eng, "fleet_status"):
            section("fleet", eng.fleet_status)
        if hasattr(eng, "member_bundles"):
            # One section per member, each error-contained: a dead
            # replica does not cost the rest of the fleet's bundle.
            section("members", lambda: _redact(eng.member_bundles()))
        self._send_json(200, bundle)


def _recovered_as(journal, rid: int):
    """The id a WAL'd pre-crash `rid` was re-admitted under, off the
    journal's recover_replay records (None: no such recovery)."""
    for rec in journal.tail(None, kind="recover_replay"):
        if rec.get("wal_rid") == rid:
            return rec.get("req_id")
    return None


def render_prometheus(engine) -> str:
    """The registry as Prometheus text after refreshing the scrape-time
    gauges: uptime, queue depth per user (rebuilt so departed users'
    series go), the card's HBM (omitted on the CPU, never a fake 0) and
    the firing alerts (rebuilt so resolved ones go), with the other
    ranks' snapshots merged in and a fleet's HTTP members federated."""
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
    # The other ranks of this engine's rank worlds merge into its series
    # (counters and histograms sum): one scrape covers every rank.
    extra = []
    try:
        extra = engine.worker_metric_snapshots()
    except Exception:  # noqa: BLE001 — the local series still render
        log.exception("worker metric snapshot fetch failed")
    # A fleet router re-exports every HTTP member's scraped snapshot with
    # a `replica` label: one scrape sees the fleet.
    federated = []
    fed_fn = getattr(engine, "member_metric_federation", None)
    if fed_fn is not None:
        try:
            federated = fed_fn()
        except Exception:  # noqa: BLE001 — the local series still render
            log.exception("member metric federation failed")
    return REGISTRY.render(extra_snapshots=extra, federated=federated)


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
    # The listen backlog (socketserver's default is 5): a burst of
    # clients connecting at once must wait in the kernel's accept queue,
    # not be reset (the OS caps it at net.core.somaxconn).
    request_queue_size = 1024

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 11434,
                 timeout_s: float = 300.0, allow_all_routes: bool = False):
        super().__init__((host, port), Handler)
        self.engine = engine
        # --allow-all-routes: unhandled paths answer 501, not 404.
        self.allow_all_routes = allow_all_routes
        self.registry = ModelRegistry(engine)
        self.timeout_s = timeout_s
        self.profile_lock = threading.Lock()
        self.profiling = False
        # Router HA epoch fencing (member side): the highest
        # X-Router-Epoch this member has seen. A call carrying a higher
        # or equal epoch adopts it (the new primary owns us even if its
        # explicit /admin/ha/register never arrived); a lower one is a
        # zombie ex-primary and gets 409. 0 = HA never seen; header-less
        # callers always pass. Persisted next to the WAL when one exists,
        # so a member restart cannot regress the fence; WAL-less members
        # re-adopt through the router heartbeat instead. Handler threads
        # run concurrently: one lock covers the compare, the adopt and
        # the persist, so the persisted epoch never goes down and a call
        # below the epoch adopted at that moment is always fenced.
        self._epoch_lock = threading.Lock()
        self._ha_epoch = 0
        self._epoch_path = None
        wal_dir = getattr(getattr(engine, "ecfg", None), "wal_dir", None)
        if wal_dir:
            self._epoch_path = os.path.join(wal_dir, "member_epoch.json")
            try:
                with open(self._epoch_path, encoding="utf-8") as f:
                    self._ha_epoch = max(0, int(json.load(f)["epoch"]))
            except (OSError, KeyError, TypeError, ValueError,
                    json.JSONDecodeError):
                pass

    @property
    def ha_epoch(self) -> int:
        return self._ha_epoch

    def check_epoch(self, got, kind: str, path: str) -> None:
        """The member-side epoch fence: None (no X-Router-Epoch header)
        passes; an epoch at or above the adopted one is adopted; a lower
        one is fenced (journal epoch_fence, count, 409)."""
        if got is None:
            return
        try:
            got = int(got)
        except ValueError:
            raise ApiError(400, "X-Router-Epoch must be an integer")
        with self._epoch_lock:
            cur = self._ha_epoch
            if got >= cur:
                self._adopt_locked(got)
                return
        journal = getattr(self.engine, "journal", None)
        if journal is not None:
            try:
                journal.record("epoch_fence", epoch=cur, stale_epoch=got,
                               path=path, caller=kind)
            except Exception:  # noqa: BLE001
                log.exception("epoch_fence journal failed")
        tm.HA_FENCED_CALLS_TOTAL.labels(kind=kind).inc()
        log.warning("fenced stale-epoch router call: epoch %d < %d (%s)",
                    got, cur, path)
        raise ApiError(409, f"stale router epoch {got} (current {cur}): this "
                            "member was taken over by a newer router")

    def _adopt_epoch(self, epoch: int) -> None:
        with self._epoch_lock:
            self._adopt_locked(int(epoch))

    def _adopt_locked(self, epoch: int) -> None:
        """(`_epoch_lock` held) Adopt a higher router epoch, durably when
        a WAL dir exists: write-new-then-rename + fsync, so a restart
        revives at the fence it held, not at 0."""
        if epoch <= self._ha_epoch:
            return
        self._ha_epoch = epoch
        if self._epoch_path is None:
            return
        tmp = self._epoch_path + ".new"
        try:
            os.makedirs(os.path.dirname(self._epoch_path), exist_ok=True)
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"epoch": int(epoch)}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._epoch_path)
        except OSError:
            log.exception("member epoch persist failed (epoch %d)", epoch)


def serve_in_thread(engine, host: str = "127.0.0.1", port: int = 0,
                    timeout_s: float = 300.0, allow_all_routes: bool = False):
    """Start `engine` and an OllamaServer on (host, port) — port 0 picks a
    free one — with serve_forever on a daemon thread. Returns the server;
    server.server_address has the bound port. Stop with stop_server()."""
    engine.start()
    server = OllamaServer(engine, host, port, timeout_s, allow_all_routes)
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
