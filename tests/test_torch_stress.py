"""Randomized multi-user stress on the port's stdlib server: the mirror of
tests/test_stress.py (50 users x 1-12 randomized requests across 4
endpoints x 2 models, 10% early cancels, 5% image payloads; then the
64-user VIP / boost / blocked mix of BASELINE config 4).

The port's FakeEngine behind OllamaServer, every request on its own
thread over http.client (the reference's aiohttp client tasks, all in
flight at once). It asserts the reference's accounting invariants: every
request processed or dropped, queues drained, the processing gauges back
to zero, many distinct users served, and no engine stall.
"""

import base64
import http.client
import json
import random
import socket
import threading
import time

from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine.fake import FakeEngine, FakeRuntime
from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
from ollamamq_tpu_torch.server.registry import RegistryEntry

USERS = [f"user{i:02d}" for i in range(50)]
MODELS = ["test-tiny", "qwen-fake"]  # Ollama-style + LM-Studio-style naming
ENDPOINTS = ["/api/generate", "/api/chat", "/v1/chat/completions", "/v1/completions"]
TINY_PNG = base64.b64encode(bytes.fromhex(
    "89504e470d0a1a0a0000000d4948445200000001000000010802000000907753de"
)).decode()


def _body(endpoint: str, model: str, rng: random.Random) -> dict:
    n = rng.randint(1, 6)
    if endpoint == "/api/generate":
        body = {"model": model, "prompt": "stress prompt", "stream": rng.random() < 0.5,
                "options": {"num_predict": n}}
        if rng.random() < 0.05:  # multimodal injection (5%)
            body["images"] = [TINY_PNG]
        return body
    if endpoint == "/api/chat":
        return {"model": model, "stream": rng.random() < 0.5,
                "messages": [{"role": "user", "content": "hello"}],
                "options": {"num_predict": n}}
    if endpoint == "/v1/chat/completions":
        return {"model": model, "stream": rng.random() < 0.5, "max_tokens": n,
                "messages": [{"role": "user", "content": "hello"}]}
    return {"model": model, "prompt": "stress", "max_tokens": n,
            "stream": rng.random() < 0.3}


def _post(port, path, body, user, timeout=60.0):
    """(status, body text) of one POST; the connection closes after."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request("POST", path, json.dumps(body),
                  {"X-User-ID": user, "Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, r.read().decode("utf-8", "replace")
    finally:
        c.close()


def _settle(eng, budget_s=5.0) -> None:
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        if eng.core.total_queued() == 0 and not any(
                rt.has_work() for rt in eng.runtimes.values()):
            return
        time.sleep(0.05)


def test_stress_50_users(tmp_path):
    rng = random.Random(1234)
    eng = FakeEngine(EngineConfig(model="test-tiny", max_slots=16),
                     models={"test-tiny": None},
                     blocklist_path=str(tmp_path / "blocked_items.json"))
    # qwen-fake is no known architecture: a FakeRuntime registered
    # directly (the fake layer needs no ModelConfig), made visible to the
    # registry under test-tiny's config.
    eng.runtimes["qwen-fake"] = FakeRuntime("qwen-fake", eng.ecfg)
    srv = serve_in_thread(eng, port=0, timeout_s=60)
    srv.registry._entries["qwen-fake"] = RegistryEntry(
        "qwen-fake", srv.registry._entries["test-tiny"].config)
    port = srv.server_address[1]
    stats = {"ok": 0, "cancelled": 0, "errors": 0}
    failures = []
    lock = threading.Lock()
    try:
        jobs = []
        for user in USERS:
            for _ in range(rng.randint(1, 12)):
                endpoint = rng.choice(ENDPOINTS)
                model = rng.choice(MODELS)
                jobs.append((user, endpoint, _body(endpoint, model, rng),
                             rng.random() < 0.10))  # 10% early cancel
        rng.shuffle(jobs)

        def one_request(user, endpoint, body, cancel):
            try:
                if cancel:
                    try:
                        _post(port, endpoint, body, user, timeout=0.05)
                        key = "ok"
                    except (socket.timeout, TimeoutError):
                        key = "cancelled"
                    with lock:
                        stats[key] += 1
                    return
                status, text = _post(port, endpoint, body, user)
                if status != 200 or not text.strip():
                    with lock:
                        failures.append(f"{endpoint}: {status} {text[:200]}")
                    return
                with lock:
                    stats["ok"] += 1
            except Exception as e:  # noqa: BLE001 — counted, as the reference does
                with lock:
                    stats["errors"] += 1
                    failures.append(repr(e))

        threads = [threading.Thread(target=one_request, args=job) for job in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not failures, (failures[:5], stats)
        # Drain: the engine must settle with empty queues.
        _settle(eng)
        assert eng.core.total_queued() == 0
        snap = eng.core.snapshot()
        total_processed = sum(u["processed"] for u in snap["users"].values())
        total_dropped = sum(u["dropped"] for u in snap["users"].values())
        total_processing = sum(u["processing"] for u in snap["users"].values())
        assert total_processing == 0  # gauge back to zero
        assert stats["ok"] > 0 and stats["errors"] == 0, stats
        # Everything accounted for: completions + drops >= successful HTTP
        # requests (cancelled ones may land either side).
        assert total_processed + total_dropped >= stats["ok"]
        # Fairness sanity: many distinct users actually got served.
        served_users = [u for u, v in snap["users"].items() if v["processed"] > 0]
        assert len(served_users) >= 40
        # Slots reclaimed: nothing active or pending on either model.
        assert all(not rt.active and not rt.pending_prefill
                   for rt in eng.runtimes.values())
    finally:
        stop_server(srv)
        eng.stop()


def test_stress_with_vip_boost_and_blocks(tmp_path):
    """The 64-user VIP/Boost mix of BASELINE config 4 at the API level."""
    eng = FakeEngine(EngineConfig(model="test-tiny", max_slots=8),
                     models={"test-tiny": None},
                     blocklist_path=str(tmp_path / "blocked_items.json"))
    eng.core.set_vip("vip-user")
    eng.core.set_boost("boost-user")
    eng.core.block_user("blocked-user")
    srv = serve_in_thread(eng, port=0, timeout_s=60)
    port = srv.server_address[1]
    try:
        users = [f"u{i}" for i in range(61)] + ["vip-user", "boost-user", "blocked-user"]
        results = {}

        def go(user):
            results[user] = _post(port, "/api/generate", {
                "model": "test-tiny", "prompt": "x", "stream": False,
                "options": {"num_predict": 2}}, user)[0]

        threads = [threading.Thread(target=go, args=(u,)) for u in users]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert results["blocked-user"] == 403
        assert results["vip-user"] == 200
        assert sum(1 for s in results.values() if s == 200) == 63
        snap = eng.core.snapshot()
        assert snap["users"]["vip-user"]["processed"] == 1
        assert "blocked-user" not in snap["users"] or \
            snap["users"]["blocked-user"]["processed"] == 0
    finally:
        stop_server(srv)
        eng.stop()
