"""HTTP front-end on the standard library: Ollama and OpenAI wire formats.

http.server.ThreadingHTTPServer, one thread per connection; each handler
enqueues into the engine (X-User-ID names the user the fair-share core
schedules by) and reads the request's TokenStream, writing NDJSON
(Ollama) or server-sent events (OpenAI) with chunked transfer encoding,
or one JSON body when the client asked for no stream.

Routes: GET /health, GET|POST /api/tags, POST /api/generate,
POST /api/chat, POST /v1/chat/completions.
"""

from __future__ import annotations

import datetime
import json
import logging
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ollamamq_tpu_torch.config import get_model_config
from ollamamq_tpu_torch.core.mqcore import BlockedError, Family
from ollamamq_tpu_torch.engine.request import FinishReason, Request, StreamItem
from ollamamq_tpu_torch.ops.cuda import launch_counts
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.server.templates import render_chat, template_owns_bos

log = logging.getLogger("ollamamq.torch.server")


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


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

    # -- plumbing ------------------------------------------------------------
    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def _dispatch(self, method: str) -> None:
        path = self.path.split("?", 1)[0]
        routes = {
            ("GET", "/health"): self.health,
            ("GET", "/api/tags"): self.api_tags,
            ("POST", "/api/tags"): self.api_tags,
            ("POST", "/api/generate"): self.api_generate,
            ("POST", "/api/chat"): self.api_chat,
            ("POST", "/v1/chat/completions"): self.v1_chat_completions,
        }
        fn = routes.get((method, path))
        try:
            if fn is None:
                self._read_body()
                raise ApiError(404, f"no route for {method} {path}")
            fn()
        except ApiError as e:
            self._send_json(e.status, {"error": e.message})
        except _ClientGone:
            self.close_connection = True

    def _read_body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n > 0 else b""
        if not raw:
            return {}
        try:
            body = json.loads(raw)
        except json.JSONDecodeError:
            raise ApiError(400, "invalid JSON body")
        if not isinstance(body, dict):
            raise ApiError(400, "request body must be a JSON object")
        return body

    def _send_json(self, status: int, obj) -> None:
        data = json.dumps(obj).encode()
        try:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        except (BrokenPipeError, ConnectionResetError):
            raise _ClientGone()

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
        name = body.get("model", "")
        if not name:
            raise ApiError(400, "missing 'model' field")
        cfg = get_model_config(name)
        if cfg is None or self.server.engine.resolve_runtime(name) is None:
            raise ApiError(404, f"model '{name}' not found")
        return name, cfg

    def _enqueue(self, user, ip, model, family, text, sampling,
                 add_bos=True) -> Request:
        rt = self.server.engine.resolve_runtime(model)
        tokens = rt.tokenizer.encode(text, add_bos=add_bos)
        try:
            return self.server.engine.enqueue_request(
                user, ip, model, family, tokens, sampling)
        except BlockedError as e:
            raise ApiError(403, str(e))

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

    # -- routes --------------------------------------------------------------
    def health(self) -> None:
        eng = self.server.engine
        self._send_json(200, {"status": "ok", "device": str(eng.device),
                              "kernel_launches": launch_counts(),
                              **eng.stats()})

    def api_tags(self) -> None:
        self._read_body()
        self._ident()
        models = []
        for name, rt in self.server.engine.runtimes.items():
            p = rt.cfg.param_count()
            models.append({
                "name": name, "model": name,
                "modified_at": _now_iso(),
                "size": rt.param_bytes,
                "details": {"format": "random-init", "family": "qwen2" if rt.cfg.attn_bias else "llama",
                            "parameter_size": f"{p / 1e9:.1f}B" if p >= 1e9 else f"{p / 1e6:.0f}M",
                            "quantization_level": str(rt.dtype).replace("torch.", "").upper()},
            })
        self._send_json(200, {"models": models})

    def api_generate(self) -> None:
        user, ip = self._ident()
        body = self._read_body()
        model, _cfg = self._model(body)
        sampling = SamplingParams.from_ollama_options(
            body.get("options"), self.server.engine.ecfg.max_new_tokens)
        req = self._enqueue(user, ip, model, Family.OLLAMA,
                            body.get("prompt", ""), sampling)
        self._ollama_reply(req, model, chat=False,
                           stream=body.get("stream", True))

    def api_chat(self) -> None:
        user, ip = self._ident()
        body = self._read_body()
        model, cfg = self._model(body)
        sampling = SamplingParams.from_ollama_options(
            body.get("options"), self.server.engine.ecfg.max_new_tokens)
        prompt = render_chat(body.get("messages", []), cfg)
        req = self._enqueue(user, ip, model, Family.OLLAMA, prompt, sampling,
                            add_bos=not template_owns_bos(cfg))
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
            items = list(self._items(req))
            last = items[-1]
            if last.kind == "error":
                raise ApiError(504 if last.finish_reason == FinishReason.DEADLINE
                               else 500, f"engine error: {last.error}")
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
        req = self._enqueue(user, ip, model, Family.OPENAI, prompt, sampling,
                            add_bos=not template_owns_bos(cfg))
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())

        def usage() -> dict:
            p, c = req.stats.prompt_tokens, req.stats.completion_tokens
            return {"prompt_tokens": p, "completion_tokens": c,
                    "total_tokens": p + c}

        if not body.get("stream", False):
            items = list(self._items(req))
            last = items[-1]
            if last.kind == "error":
                raise ApiError(504 if last.finish_reason == FinishReason.DEADLINE
                               else 500, f"engine error: {last.error}")
            text = "".join(i.text for i in items if i.kind == "token")
            self._send_json(200, {
                "id": rid, "object": "chat.completion", "created": created,
                "model": model, "usage": usage(),
                "choices": [{"index": 0, "finish_reason": _done_reason(last),
                             "message": {"role": "assistant", "content": text}}]})
            return

        first = [True]

        def sse(choice: dict) -> bytes:
            return ("data: " + json.dumps({
                "id": rid, "object": "chat.completion.chunk",
                "created": created, "model": model, "choices": [choice]})
                + "\n\n").encode()

        def frames(item: StreamItem):
            if item.kind == "token":
                if item.text:
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
                yield sse({"index": 0, "delta": {},
                           "finish_reason": _done_reason(item)})
                yield b"data: [DONE]\n\n"

        self._stream(req, "text/event-stream", frames)


class OllamaServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 11434,
                 timeout_s: float = 300.0):
        super().__init__((host, port), Handler)
        self.engine = engine
        self.timeout_s = timeout_s


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
