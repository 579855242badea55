"""Concurrency chaos on the port's stdlib server: the mirror of
tests/test_chaos.py::test_admin_mutations_race_traffic.

Five users' generate traffic (streamed or not, 1-6 tokens) races 200
admin mutations against one FakeEngine behind OllamaServer: block /
unblock, VIP and boost flips, /api/pull and /api/delete of a second
model, /metrics polls, 2 ms apart. Threads and http.client stand in for
the reference's aiohttp tasks. Then everyone is unblocked and the system
must settle: no deadlock, queues drained, the processing gauges at zero,
work accounted for, and the engine thread alive and serving.
"""

import http.client
import json
import random
import threading
import time

from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine.fake import FakeEngine
from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server


def _request(port, method, path, body=None, user="chaos", timeout=60.0):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        c.request(method, path, json.dumps(body) if body is not None else None,
                  {"X-User-ID": user, "Content-Type": "application/json"})
        r = c.getresponse()
        return r.status, r.read()  # streams are driven to completion
    finally:
        c.close()


def test_admin_mutations_race_traffic(tmp_path):
    rng = random.Random(7)
    eng = FakeEngine(EngineConfig(model="test-tiny", max_slots=8),
                     models={"test-tiny": None},
                     blocklist_path=str(tmp_path / "blocked_items.json"),
                     token_latency_s=0.002)
    srv = serve_in_thread(eng, port=0, timeout_s=60)
    port = srv.server_address[1]
    stop = threading.Event()
    lock = threading.Lock()  # the shared seeded rng
    thread_errors = []
    try:
        def traffic(user):
            while not stop.is_set():
                with lock:
                    body = {"model": "test-tiny", "prompt": "x",
                            "stream": rng.random() < 0.5,
                            "options": {"num_predict": rng.randint(1, 6)}}
                try:
                    _request(port, "POST", "/api/generate", body, user)
                except Exception:  # noqa: BLE001 — blocked users, races
                    pass

        def admin():
            core = eng.core
            try:
                for _ in range(200):
                    with lock:
                        action = rng.randint(0, 6)
                        user = f"chaos{rng.randint(0, 4)}"
                        pick = rng.random()
                    if action == 0:
                        core.block_user(user)
                    elif action == 1:
                        core.unblock_user(user)
                    elif action == 2:
                        core.set_vip(user if pick < 0.8 else None)
                    elif action == 3:
                        core.set_boost(user if pick < 0.8 else None)
                    elif action == 4:
                        try:
                            _request(port, "POST", "/api/pull",
                                     {"model": "test-tiny-qwen", "stream": False})
                        except Exception:  # noqa: BLE001
                            pass
                    elif action == 5:
                        try:
                            _request(port, "POST", "/api/delete",
                                     {"model": "test-tiny-qwen"})
                        except Exception:  # noqa: BLE001
                            pass
                    else:
                        try:
                            _request(port, "GET", "/metrics")
                        except Exception:  # noqa: BLE001
                            pass
                    time.sleep(0.002)
            except Exception as e:  # noqa: BLE001 — a thread death fails the test
                thread_errors.append(repr(e))
            finally:
                stop.set()

        users = [f"chaos{i}" for i in range(5)]
        threads = ([threading.Thread(target=admin)]
                   + [threading.Thread(target=traffic, args=(u,)) for u in users])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "deadlock"
        assert not thread_errors, thread_errors

        # Unblock everyone, then the system must settle.
        for u in users:
            eng.core.unblock_user(u)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if eng.core.total_queued() == 0 and not any(
                    rt.has_work() for rt in eng.runtimes.values()):
                break
            time.sleep(0.05)
        assert eng.core.total_queued() == 0
        snap = eng.core.snapshot()
        assert sum(u["processing"] for u in snap["users"].values()) == 0
        total = sum(u["processed"] + u["dropped"] for u in snap["users"].values())
        assert total > 0
        # The engine thread is alive and still serves.
        status, data = _request(port, "POST", "/api/generate", {
            "model": "test-tiny", "prompt": "after-chaos", "stream": False,
            "options": {"num_predict": 2}})
        assert status == 200
        assert json.loads(data)["done"] is True
    finally:
        stop_server(srv)
        eng.stop()
