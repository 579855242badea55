"""The port's admission and telemetry surface over HTTP, on the CPU:

- bounded admission answers 429 (a user's queue is full) and 503 (the
  whole queue is full) with a Retry-After and the JAX package's body,
  then serves what it queued;
- after two requests /metrics counts two more TTFT observations and
  tokens equal to the replies' eval_count; /metrics.json and
  /metrics/snapshot parse;
- /debug/stepprof, /debug/trace, /debug/trace/{id}, /debug/prefix_cache
  (GET and the POST flush), /debug/hbm and POST /debug/profile answer;
- the CLI refuses --scheduler bogus (and a bad --slo-target) before the
  engine is built.
"""

import http.client
import json
import re
import threading
import time

import pytest
import torch

from ollamamq_tpu.engine.engine import QueueFullError as JaxQueueFullError
from ollamamq_tpu_torch import cli
from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine import engine as engine_mod
from ollamamq_tpu_torch.engine.engine import QueueFullError, TorchEngine
from ollamamq_tpu_torch.server.app import OllamaServer, serve_in_thread, stop_server

TINY = dict(model="test-tiny", max_slots=4, num_pages=64, page_size=8,
            max_pages_per_seq=16, max_new_tokens=6, max_batch_tokens=48,
            token_granule=8)


def _call(port, method, path, body=None, user="alice"):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    c.request(method, path, json.dumps(body) if body is not None else None,
              {"Content-Type": "application/json", "X-User-ID": user})
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, dict(r.getheaders()), data


def _gen(port, user, out):
    out.append(_call(port, "POST", "/api/generate",
                     {"model": "test-tiny", "prompt": f"hi {user}", "stream": False,
                      "options": {"temperature": 0, "num_predict": 4}}, user))


def _wait(pred, budget=30.0):
    deadline = time.monotonic() + budget
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pred()


def test_shed_429_and_503_with_retry_after():
    eng = TorchEngine(EngineConfig(max_queued=3, max_queued_per_user=2, **TINY),
                      device="cpu", dtype=torch.float32)
    # The HTTP server alone: with the engine loop not started nothing is
    # admitted, so the queue fills deterministically.
    srv = OllamaServer(eng, port=0, timeout_s=120)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.server_address[1]
    queued, threads = [], []
    try:
        for user in ("alice", "alice"):
            threads.append(threading.Thread(target=_gen, args=(port, user, queued)))
            threads[-1].start()
        _wait(lambda: eng.core.total_queued() == 2)
        status, headers, body = _call(port, "POST", "/api/generate",
                                      {"model": "test-tiny", "prompt": "x"}, "alice")
        want = JaxQueueFullError("user_queue_full", eng.retry_after_s(), 2)
        assert status == 429 and json.loads(body) == {"error": str(want)}
        assert int(headers["Retry-After"]) >= 1
        threads.append(threading.Thread(target=_gen, args=(port, "bob", queued)))
        threads[-1].start()
        _wait(lambda: eng.core.total_queued() == 3)
        status, headers, body = _call(port, "POST", "/api/generate",
                                      {"model": "test-tiny", "prompt": "x"}, "carol")
        want = JaxQueueFullError("queue_full", eng.retry_after_s(), 3)
        assert status == 503 and json.loads(body) == {"error": str(want)}
        assert int(headers["Retry-After"]) >= 1
        assert eng.shed_counts == {"user_queue_full": 1, "queue_full": 1}
        eng.start()  # the queued requests are then served
        for t in threads:
            t.join(timeout=120)
        assert [s for s, _, _ in queued] == [200, 200, 200]
        with pytest.raises(QueueFullError):  # quiesced: the door is shut
            eng.quiesce()
            eng.enqueue_request("dave", "", "test-tiny", prompt_tokens=[1, 2, 3])
    finally:
        srv.shutdown()
        srv.server_close()
        eng.stop()


def _metric(text, name, model="test-tiny"):
    m = re.search(rf'^{re.escape(name)}{{model="{model}"}} (\S+)$', text, re.M)
    return float(m.group(1)) if m else 0.0


@pytest.fixture(scope="module")
def server():
    srv = serve_in_thread(TorchEngine(EngineConfig(prefix_cache=True, **TINY),
                                      device="cpu", dtype=torch.float32),
                          port=0, timeout_s=120)
    yield srv
    stop_server(srv)


def test_metrics_count_served_requests(server):
    port = server.server_address[1]
    text0 = _call(port, "GET", "/metrics")[2].decode()
    replies = []
    for user in ("ann", "ben"):
        _gen(port, user, replies)
    status, headers, data = _call(port, "GET", "/metrics")
    assert status == 200 and headers["Content-Type"].startswith("text/plain; version=0.0.4")
    text = data.decode()
    evals = sum(json.loads(b)["eval_count"] for _, _, b in replies)
    assert _metric(text, "ollamamq_ttft_ms_count") - _metric(text0, "ollamamq_ttft_ms_count") == 2
    assert (_metric(text, "ollamamq_tokens_generated_total")
            - _metric(text0, "ollamamq_tokens_generated_total")) == evals == 8
    assert 'ollamamq_queue_depth' in text and "ollamamq_uptime_seconds" in text
    # No HBM series on the CPU: never a fake 0-byte reading.
    assert "ollamamq_hbm_used_bytes{" not in text
    body = json.loads(_call(port, "GET", "/metrics.json")[2])
    assert body["scheduler"]["policy"] == "fcfs" and body["runtimes"][0]["mfu"] >= 0
    assert body["chips"][0]["memory_stats"] is False
    snap = json.loads(_call(port, "GET", "/metrics/snapshot")[2])
    assert "ollamamq_ttft_ms" in json.dumps(snap)


def test_debug_routes_answer_on_cpu(server, tmp_path, monkeypatch):
    port = server.server_address[1]
    replies = []
    _gen(port, "cat", replies)
    rid = max(tr.req_id for tr in server.engine.tracer.traces())
    sp = json.loads(_call(port, "GET", "/debug/stepprof?n=4")[2])
    assert {"ragged", "decode"} <= set(sp["summary"]["modes"]) and len(sp["recent"]) <= 4
    assert set(sp["summary"]["modes"]["decode"]) == {"host_prep", "dispatch", "collect",
                                                     "detok", "step"}
    assert _call(port, "GET", "/debug/stepprof?n=x")[0] == 400
    chrome = json.loads(_call(port, "GET", "/debug/trace")[2])
    assert chrome["traceEvents"]
    one = json.loads(_call(port, "GET", f"/debug/trace/{rid}")[2])
    names = [e["name"] for e in one["traceEvents"]]
    assert {"enqueue", "admit", "place", "prefill_chunk", "first_token"} <= set(names)
    assert {"stop", "length"} & set(names)
    assert _call(port, "GET", "/debug/trace/999999")[0] == 404
    assert _call(port, "GET", "/debug/trace/abc")[0] == 400
    pc = json.loads(_call(port, "GET", "/debug/prefix_cache")[2])
    assert pc["enabled"] and "test-tiny" in pc["models"]
    flushed = json.loads(_call(port, "POST", "/debug/prefix_cache", {})[2])
    assert flushed["status"] == "success" and flushed["freed_pages"] >= 0
    hbm = json.loads(_call(port, "GET", "/debug/hbm")[2])
    assert hbm["period_s"] == 1.0 and hbm["timeline"]
    assert "device" not in hbm["timeline"][-1]  # the CPU has no HBM readings
    assert hbm["timeline"][-1]["models"]["test-tiny"]["pool"] == 63
    monkeypatch.setenv("OLLAMAMQ_PROFILE_DIR", str(tmp_path))
    status, _, body = _call(port, "POST", "/debug/profile", {"seconds": 0.1})
    prof = json.loads(body)
    assert status == 200 and prof["trace_dir"] == str(tmp_path)
    assert json.load(open(prof["trace_file"]))  # a Chrome trace on disk
    assert _call(port, "POST", "/debug/profile", {"seconds": "x"})[0] == 400
    health = json.loads(_call(port, "GET", "/health")[2])
    assert health["status"] == "ok" and health["alerts"] == []
    assert set(health["health"]) == {"status", "device_online", "engine_stalled",
                                     "last_device_check", "alerts"}


def test_cli_rejects_bad_flags_before_the_engine(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the engine must not be built")

    monkeypatch.setattr(engine_mod, "TorchEngine", boom)
    base = ["--model", "test-tiny", "--device", "cpu", "--no-tui"]
    assert cli.main(base + ["--scheduler", "bogus"]) == 2
    assert cli.main(base + ["--slo-target", "1.5"]) == 2
    assert cli.main(base + ["--max-queued", "-1"]) == 2
    args = cli.build_parser().parse_args(["--scheduler", "srpt", "--token-fairness",
                                          "--max-queued", "6", "--max-queued-per-user", "3",
                                          "--slo-ttft-ms", "500", "--trace-ring", "64"])
    ecfg = cli.engine_config(args)
    assert (ecfg.scheduler, ecfg.max_queued, ecfg.max_queued_per_user,
            ecfg.slo_ttft_ms, ecfg.slo_tpot_ms, ecfg.trace_ring) == \
        ("srpt", 6, 3, 500.0, None, 64)
    assert args.token_fairness and args.blocklist == "blocked_items.json"
