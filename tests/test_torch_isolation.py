"""The port stands alone: every module of ollamamq_tpu_torch imports and
serves a request (bf16/f32, then int8 weights and int8 KV pages, then
with the prefix cache, speculation and an injected ragged fault that is
retried, then under srpt with token fairness and a /metrics scrape, then
several models: an encoder pulled, embedded with and deleted over HTTP,
and a safetensors checkpoint written and served, then the fake engine
with a WAL and a journal spill, whose stream is recovered after a crash
and whose spill the journal tool checks) with JAX, the JAX package,
safetensors, tokenizers and ml_dtypes (bf16 migration blobs go without
it) all blocked from import, and without a GPU the engine refuses to
start unless the CPU is asked for. The journal tool's --help runs under
the same block, and so does the CLI serving a
two-member fleet (a stream, then GET /admin/fleet, then SIGTERM), a
tiered elastic fleet (a stream, GET /admin/tiers, the autoscaler's
status), an HA primary and its warm standby (a stream, the standby's
catch-up, a SIGTERM handover, a stream through the promoted standby),
the mixture-of-experts model test-tiny-moe (a chat stream and an embed,
then SIGTERM; int8 weights for Mixtral exit 2), tensor parallelism over
two ranks (`--tp 2 --device cpu`: the leader and the worker rank it
starts both run with the block, installed by a sitecustomize the worker
inherits), pipeline parallelism over two stages (`--pp 2 --device
cpu`, the same way), data-parallel replicas (`--dp 2` in one process,
`--dp 2 --tp 2` over four ranks), fleet members two ranks wide
(`--replicas 2 --tp 2`, every member rank blocked too), and refusing
what the fleet's layers cannot take.

Runs in a subprocess because this test session's conftest imports JAX.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from testutil import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys


class _Blocked:
    # Importing any of these fails: the port needs none of them.
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ollamamq_tpu", "safetensors",
                                  "tokenizers", "ml_dtypes"):
            raise ImportError(f"blocked: {name}")
        return None


sys.meta_path.insert(0, _Blocked())
import importlib, json, pkgutil, tempfile, urllib.request
import ollamamq_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ollamamq_tpu_torch.__path__,
                                               "ollamamq_tpu_torch.")]
for name in names:
    importlib.import_module(name)

import dataclasses
import torch
from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
from ollamamq_tpu_torch.testing.faults import FaultPlan

cfg = EngineConfig(model="test-tiny", max_slots=2, num_pages=32, page_size=8,
                   max_pages_per_seq=8, max_new_tokens=4)


def serve_one(ecfg, **kw):
    srv = serve_in_thread(TorchEngine(ecfg, device="cpu", dtype=torch.float32, **kw))
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    req = urllib.request.Request(
        base + "/api/generate",
        data=json.dumps({"model": "test-tiny", "prompt": "hi", "stream": False,
                         "options": {"temperature": 0}}).encode(),
        headers={"X-User-ID": "solo"})
    body = json.loads(urllib.request.urlopen(req, timeout=60).read())
    stats = srv.engine.stats()
    stats["metrics"] = urllib.request.urlopen(base + "/metrics", timeout=60).read().decode()
    stop_server(srv)
    return body, stats


body, _ = serve_one(cfg)
body8, stats8 = serve_one(dataclasses.replace(cfg, weights_dtype="int8",
                                              kv_dtype="int8"))
body_rt, stats_rt = serve_one(dataclasses.replace(
    cfg, prefix_cache=True, spec=True, retry_backoff_s=0.0,
    fault_plan=FaultPlan([{"site": "ragged", "kind": "exception", "at": [1]}])))

from ollamamq_tpu_torch.core.mqcore import Fairness
body_s, stats_s = serve_one(dataclasses.replace(cfg, scheduler="srpt"),
                            fairness=Fairness.TOKENS)
ttft = [ln for ln in stats_s["metrics"].splitlines()
        if ln.startswith('ollamamq_ttft_ms_count{model="test-tiny"}')]

def http(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers={"X-User-ID": "solo"})
    return urllib.request.urlopen(req, timeout=60).read().decode()


srv = serve_in_thread(TorchEngine(cfg, device="cpu", dtype=torch.float32))
base = f"http://127.0.0.1:{srv.server_address[1]}"
pull = [json.loads(x)["status"] for x in
        http(base, "/api/pull", {"model": "test-tiny-embed"}).splitlines()]
emb = json.loads(http(base, "/api/embed", {"model": "test-tiny-embed",
                                           "input": ["a", "bc"]}))["embeddings"]
deleted = json.loads(http(base, "/api/delete", {"model": "test-tiny-embed"}))
models_after = srv.engine.loaded_models()
from ollamamq_tpu_torch.models import weights
ckpt = tempfile.mkdtemp()
weights.save_safetensors(srv.engine.runtimes["test-tiny"].params,
                         srv.engine.runtimes["test-tiny"].cfg, ckpt)
stop_server(srv)
body_ckpt, _ = serve_one(cfg, models={"test-tiny": ckpt})

import shutil, time
from ollamamq_tpu_torch.engine.fake import FakeEngine
from ollamamq_tpu_torch.ops.sampling import SamplingParams
from ollamamq_tpu_torch.telemetry.journal import check_invariants
from ollamamq_tpu_torch.tools.journal import main as journal_main
wal = tempfile.mkdtemp()
fake = FakeEngine(EngineConfig(model="test-tiny", wal_dir=wal + "/a",
                               wal_fsync_ms=1.0, journal_file=wal + "/j.jsonl"),
                  blocklist_path=None, token_latency_s=0.02)
fake.start()
live = fake.enqueue_request("w", "", "test-tiny", prompt_tokens=[1, 2],
                            sampling=SamplingParams(max_tokens=8))
while len(live.generated_ids) < 3:
    time.sleep(0.005)
fake._running = False  # a crash: the loop dies, nothing is flushed
time.sleep(0.1)
wal_ = fake.durability.wal
wal_._stop.set()
with wal_._cond:
    wal_._cond.notify_all()
wal_._flusher.join(timeout=5)
shutil.copytree(wal + "/a", wal + "/b")
fake.stop()
fake = FakeEngine(EngineConfig(model="test-tiny", wal_dir=wal + "/b",
                               wal_fsync_ms=1.0), blocklist_path=None)
fake.start()
entry = fake.durability.registry.find(live.req_id)
while entry.terminal is None:
    time.sleep(0.01)
recovered = "".join(t for _, t in entry.snapshot(0)[0])
fake_clean = check_invariants(fake.journal.tail(None))
fake.stop()
check_rc = journal_main(["check", wal + "/j.jsonl"])

refused = None
if not torch.cuda.is_available():
    try:
        TorchEngine(cfg)
    except RuntimeError as e:
        refused = str(e)
print(json.dumps({
    "modules": names,
    "eval_count": body["eval_count"],
    "eval_count_int8": body8["eval_count"],
    "dtypes_int8": [stats8["runtimes"][0]["weights_dtype"],
                    stats8["runtimes"][0]["kv_dtype"]],
    "eval_count_runtime": body_rt["eval_count"],
    "retries_runtime": stats_rt["retries"],
    "prefix_cache_runtime": stats_rt["runtimes"][0]["prefix_cache"] is not None,
    "eval_count_srpt": body_s["eval_count"],
    "policy_srpt": stats_s["scheduler"]["policy"],
    "ttft_count": ttft,
    "pull": pull, "embed_dims": [len(v) for v in emb], "deleted": deleted,
    "models_after_delete": models_after, "eval_count_ckpt": body_ckpt["eval_count"],
    "recovered": recovered, "fake_clean": fake_clean, "check_rc": check_rc,
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "ollamamq_tpu",
                                             "safetensors", "tokenizers",
                                             "ml_dtypes")),
    "refused": refused,
    "cuda": torch.cuda.is_available(),
}))
"""


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO + (os.pathsep + os.environ["PYTHONPATH"]
                                if os.environ.get("PYTHONPATH") else "")
    return env


def test_port_imports_and_serves_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["foreign"] == []
    assert out["eval_count"] == 4
    assert out["eval_count_int8"] == 4
    assert out["dtypes_int8"] == ["int8", "int8"]
    assert out["eval_count_runtime"] == 4
    assert out["retries_runtime"] == 1 and out["prefix_cache_runtime"]
    assert out["eval_count_srpt"] == 4 and out["policy_srpt"] == "srpt"
    # Four served requests in this process (one per engine).
    assert out["ttft_count"] == ['ollamamq_ttft_ms_count{model="test-tiny"} 4']
    assert out["pull"] == ["pulling manifest", "loading test-tiny-embed into HBM",
                           "success"]
    assert out["embed_dims"] == [64, 64] and out["deleted"] == {"status": "success"}
    assert out["models_after_delete"] == ["test-tiny"]
    assert out["eval_count_ckpt"] == 4
    assert out["recovered"] == "".join(f"word{i} " for i in range(8))
    assert out["fake_clean"] == [] and out["check_rc"] == 0
    expected = {"ollamamq_tpu_torch.engine.engine", "ollamamq_tpu_torch.server.app",
                "ollamamq_tpu_torch.ops.cuda.paged_attention",
                "ollamamq_tpu_torch.ops.cuda.ragged_attention",
                "ollamamq_tpu_torch.models.llama", "ollamamq_tpu_torch.cli",
                "ollamamq_tpu_torch.ops.quant", "ollamamq_tpu_torch.models.weights",
                "ollamamq_tpu_torch.engine.prefix_cache",
                "ollamamq_tpu_torch.testing.faults",
                "ollamamq_tpu_torch.engine.scheduler", "ollamamq_tpu_torch.engine.health",
                "ollamamq_tpu_torch.admin.tui", "ollamamq_tpu_torch.telemetry.metrics",
                "ollamamq_tpu_torch.telemetry.schema", "ollamamq_tpu_torch.telemetry.mfu",
                "ollamamq_tpu_torch.telemetry.attribution",
                "ollamamq_tpu_torch.telemetry.tracing",
                "ollamamq_tpu_torch.telemetry.stepprof", "ollamamq_tpu_torch.telemetry.slo",
                "ollamamq_tpu_torch.server.registry", "ollamamq_tpu_torch.engine.tokenizer",
                "ollamamq_tpu_torch.engine.fake", "ollamamq_tpu_torch.telemetry.journal",
                "ollamamq_tpu_torch.tools.journal", "ollamamq_tpu_torch.durability",
                "ollamamq_tpu_torch.durability.wal",
                "ollamamq_tpu_torch.durability.manager",
                "ollamamq_tpu_torch.fleet", "ollamamq_tpu_torch.fleet.members",
                "ollamamq_tpu_torch.fleet.router",
                "ollamamq_tpu_torch.fleet.tiering",
                "ollamamq_tpu_torch.fleet.autoscaler",
                "ollamamq_tpu_torch.fleet.ha", "ollamamq_tpu_torch.parallel",
                "ollamamq_tpu_torch.parallel.mesh",
                "ollamamq_tpu_torch.parallel.distributed",
                "ollamamq_tpu_torch.parallel.sharding",
                "ollamamq_tpu_torch.engine.spmd"}
    assert expected <= set(out["modules"])
    if not out["cuda"]:
        # No GPU and no device="cpu": the engine raises, never falls back.
        assert out["refused"] and "no CUDA device" in out["refused"]
    assert torch.cuda.is_available() == out["cuda"]


def test_journal_tool_help_without_jax():
    """`python -m ollamamq_tpu_torch.tools.journal --help` with JAX and
    the JAX package blocked from import."""
    blocker = SCRIPT.split("import importlib")[0]
    code = blocker + (
        "import runpy\n"
        "sys.argv = ['ollamamq_tpu_torch.tools.journal', '--help']\n"
        "runpy.run_module('ollamamq_tpu_torch.tools.journal', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for cmd in ("tail", "explain", "stats", "merge", "check", "record",
                "replay", "simulate"):
        assert cmd in proc.stdout


def _blocked_cli(args):
    """`python -m ollamamq_tpu_torch.cli ARGS` with the JAX block."""
    blocker = SCRIPT.split("import importlib")[0]
    code = blocker + (
        "import runpy\n"
        f"sys.argv = ['ollamamq_tpu_torch.cli'] + {list(args)!r}\n"
        "runpy.run_module('ollamamq_tpu_torch.cli', run_name='__main__')\n")
    return [sys.executable, "-c", code]


def test_cli_serves_a_fleet_without_jax(tmp_path):
    """`--device cpu --replicas 2` serves a stream through the router and
    answers GET /admin/fleet, with JAX and the JAX package blocked; a
    SIGTERM drains it and exits 0."""
    port = free_port()
    log = open(tmp_path / "cli.log", "w")
    proc = subprocess.Popen(
        _blocked_cli(["--model", "test-tiny", "--device", "cpu", "--replicas",
                      "2", "--port", str(port), "--no-tui", "--max-slots", "2",
                      "--num-pages", "32", "--page-size", "8",
                      "--max-pages-per-seq", "8", "--blocklist",
                      str(tmp_path / "blocked.json")]),
        cwd=str(tmp_path), env=_env(), stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            assert proc.poll() is None, (tmp_path / "cli.log").read_text()[-3000:]
            try:
                urllib.request.urlopen(base + "/health", timeout=2).read()
                break
            except OSError:
                time.sleep(0.2)
        req = urllib.request.Request(
            base + "/api/generate",
            data=json.dumps({"model": "test-tiny", "prompt": "hi",
                             "stream": False,
                             "options": {"num_predict": 4}}).encode(),
            headers={"X-User-ID": "solo"})
        body = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert body["done"] and body["eval_count"] == 4
        fleet = json.loads(urllib.request.urlopen(base + "/admin/fleet",
                                                  timeout=10).read())
        assert [r["name"] for r in fleet["replicas"]] == ["r0", "r1"]
        assert fleet["counts"] == {"healthy": 2, "ejected": 0, "draining": 0}
        assert fleet["migrate"] is True and fleet["placement"] == "affinity"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp_path / "cli.log").read_text()
    assert "blocked:" not in text and "graceful shutdown complete" in text


def test_cli_serves_moe_without_jax(tmp_path):
    """`--model test-tiny-moe --device cpu` answers /api/chat and
    /api/embed with JAX and the JAX package blocked, and drains on
    SIGTERM; `--model mixtral:8x7b --weights-dtype int8` exits 2 with
    the JAX package's message before any device work."""
    proc = subprocess.run(
        _blocked_cli(["--model", "mixtral:8x7b", "--weights-dtype", "int8",
                      "--no-tui"]),
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 2, out[-2000:]
    assert ("--weights-dtype=int8 does not cover MoE expert stacks "
            "(model mixtral:8x7b); load it in bfloat16") in out
    port = free_port()
    log = open(tmp_path / "cli.log", "w")
    proc = subprocess.Popen(
        _blocked_cli(["--model", "test-tiny-moe", "--device", "cpu",
                      "--port", str(port), "--no-tui", "--max-slots", "2",
                      "--num-pages", "32", "--page-size", "8",
                      "--max-pages-per-seq", "8", "--blocklist",
                      str(tmp_path / "blocked.json")]),
        cwd=str(tmp_path), env=_env(), stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"

    def post(path, body):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"X-User-ID": "moe"})
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            assert proc.poll() is None, (tmp_path / "cli.log").read_text()[-3000:]
            try:
                urllib.request.urlopen(base + "/health", timeout=2).read()
                break
            except OSError:
                time.sleep(0.2)
        body = post("/api/chat", {"model": "test-tiny-moe", "stream": False,
                                  "messages": [{"role": "user", "content": "hi"}],
                                  "options": {"num_predict": 4, "temperature": 0}})
        assert body["done"] and body["eval_count"] == 4
        emb = post("/api/embed", {"model": "test-tiny-moe", "input": ["a", "bc"]})
        assert [len(v) for v in emb["embeddings"]] == [64, 64]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp_path / "cli.log").read_text()
    assert "blocked:" not in text and "graceful shutdown complete" in text


@pytest.mark.parametrize("flag,message", [
    (["--tiers", "interactive@tp3=r0;bulk=r1"],
     "tier 'interactive' @tp3: --tp 3 for test-tiny: num_heads=4 not "
     "divisible by tp=3"),
    (["--autoscale", "--tp", "3"],
     "--tp 3 for test-tiny: num_heads=4 not divisible by tp=3"),
    (["--ha"], "--ha requires --wal-dir"),
], ids=["tiers", "autoscale", "ha"])
def test_cli_refuses_unported_fleet_layers(flag, message):
    """What the fleet's layers refuse is refused by name, exit 2, with
    JAX blocked: fleet members wider than one rank are ported, so a tier
    width or an autoscaled member's width is refused only when the model
    cannot take it (tp 3 over test-tiny's 4 heads); router HA refuses a
    primary without its WAL with the JAX package's message."""
    proc = subprocess.run(
        _blocked_cli(["--model", "test-tiny", "--device", "cpu", "--no-tui",
                      "--replicas", "2"] + flag),
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    out = proc.stdout + proc.stderr  # the log goes to stdout, as the JAX CLI's
    assert proc.returncode == 2, out[-2000:]
    assert message in out


def test_cli_serves_a_tiered_elastic_fleet_without_jax(tmp_path):
    """`--replicas 2 --tiers ... --autoscale` serves a stream through the
    tiered router with the autoscaler attached, with JAX and the JAX
    package blocked: the fleet.tiering and fleet.autoscaler modules run
    on the port alone. A long cooldown keeps the scaler from acting
    while the test reads it; SIGTERM exits 0."""
    port = free_port()
    log = open(tmp_path / "cli.log", "w")
    proc = subprocess.Popen(
        _blocked_cli(["--model", "test-tiny", "--device", "cpu", "--replicas",
                      "2", "--tiers", "interactive=r0;bulk=r1", "--autoscale",
                      "--max-replicas", "3", "--scale-cooldown-s", "600",
                      "--port", str(port), "--no-tui", "--max-slots", "2",
                      "--num-pages", "32", "--page-size", "8",
                      "--max-pages-per-seq", "8", "--blocklist",
                      str(tmp_path / "blocked.json")]),
        cwd=str(tmp_path), env=_env(), stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            assert proc.poll() is None, (tmp_path / "cli.log").read_text()[-3000:]
            try:
                urllib.request.urlopen(base + "/health", timeout=2).read()
                break
            except OSError:
                time.sleep(0.2)
        req = urllib.request.Request(
            base + "/api/generate",
            data=json.dumps({"model": "test-tiny", "prompt": "hi",
                             "stream": False,
                             "options": {"num_predict": 4}}).encode(),
            headers={"X-User-ID": "solo"})
        body = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert body["done"] and body["eval_count"] == 4
        tiers = json.loads(urllib.request.urlopen(base + "/admin/tiers",
                                                  timeout=10).read())
        assert {t: [m["name"] for m in v["members"]]
                for t, v in tiers["tiers"].items()} == {
                    "interactive": ["r0"], "bulk": ["r1"]}
        fleet = json.loads(urllib.request.urlopen(base + "/admin/fleet",
                                                  timeout=10).read())
        assert fleet["autoscaler"]["fleet"] == 2
        assert fleet["autoscaler"]["provisioner"].startswith("local")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp_path / "cli.log").read_text()
    assert "blocked:" not in text and "graceful shutdown complete" in text


def test_cli_serves_ha_primary_and_standby_without_jax(tmp_path):
    """An HA primary and its warm standby (fleet.ha, the server's sync
    and register routes, the CLI's standby lifecycle) over one member,
    all three CLI processes with JAX and the JAX package blocked: a
    stream through the primary, the standby caught up, a SIGTERM
    handover (the primary exits 0), a stream through the promoted
    standby."""
    ports = {k: free_port() for k in ("m", "p", "s")}
    common = ["--fake-engine", "--model", "test-tiny", "--no-tui",
              "--blocklist", str(tmp_path / "blocked.json")]
    member_url = f"http://127.0.0.1:{ports['m']}"
    argv = {
        "m": common + ["--port", str(ports["m"])],
        "p": common + ["--port", str(ports["p"]), "--replicas", "0",
                       "--replica-urls", member_url, "--ha",
                       "--takeover-grace-s", "1.0",
                       "--wal-dir", str(tmp_path / "wal-p")],
        "s": common + ["--port", str(ports["s"]), "--replicas", "0",
                       "--replica-urls", member_url,
                       "--standby-of", f"http://127.0.0.1:{ports['p']}",
                       "--takeover-grace-s", "1.0",
                       "--wal-dir", str(tmp_path / "wal-s")],
    }
    procs, logs = {}, {}

    def health(key, ok, budget=120):
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            assert procs[key].poll() is None, \
                (tmp_path / f"{key}.log").read_text()[-3000:]
            try:
                body = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{ports[key]}/health", timeout=2).read())
                if ok(body):
                    return body
            except OSError:
                pass
            time.sleep(0.1)
        raise TimeoutError(f"{key} never reached the wanted state")

    def generate(key):
        req = urllib.request.Request(
            f"http://127.0.0.1:{ports[key]}/api/generate",
            data=json.dumps({"model": "test-tiny", "prompt": "hi",
                             "stream": False,
                             "options": {"num_predict": 4}}).encode(),
            headers={"X-User-ID": "solo"})
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    def spawn(key):
        logs[key] = open(tmp_path / f"{key}.log", "w")
        procs[key] = subprocess.Popen(
            _blocked_cli(argv[key]), cwd=str(tmp_path), env=_env(),
            stdout=logs[key], stderr=subprocess.STDOUT)

    try:
        spawn("m")
        health("m", lambda b: True)
        spawn("p")
        assert health("p", lambda b: b.get("role") == "primary")["epoch"] == 1
        body = generate("p")
        assert body["done"] and body["eval_count"] == 4
        spawn("s")
        sb = health("s", lambda b: b.get("sync_lag_records") == 0)
        assert sb["status"] == "standby" and sb["epoch"] == 1
        procs["p"].send_signal(signal.SIGTERM)
        assert procs["p"].wait(timeout=60) == 0
        assert health("s", lambda b: b.get("role") == "primary")["epoch"] == 2
        body = generate("s")
        assert body["done"] and body["eval_count"] == 4
        procs["s"].send_signal(signal.SIGTERM)
        assert procs["s"].wait(timeout=60) == 0
    finally:
        for key, proc in procs.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            logs[key].close()
    texts = {k: (tmp_path / f"{k}.log").read_text() for k in procs}
    assert not any("blocked:" in t for t in texts.values())
    assert "fleet handed over to the standby" in texts["p"]
    assert "why=handover" in texts["s"]


def _serve_ranks_without_jax(tmp_path, flags):
    """The CLI with `flags` (a multi-rank world on the CPU) serving one
    greedy stream with JAX and the JAX package blocked in EVERY rank:
    the block is a sitecustomize on PYTHONPATH, so the worker ranks the
    CLI starts inherit it. SIGTERM exits 0. Returns the log."""
    site = tmp_path / "site"
    site.mkdir()
    blocker = SCRIPT.split("import importlib")[0]
    (site / "sitecustomize.py").write_text(blocker)
    env = _env()
    env["PYTHONPATH"] = str(site) + os.pathsep + env["PYTHONPATH"]
    env["OMP_NUM_THREADS"] = "1"
    probe = subprocess.run([sys.executable, "-c", "import jax"], env=env,
                           capture_output=True, text=True, timeout=60)
    assert probe.returncode != 0 and "blocked: jax" in probe.stderr
    port = free_port()
    log = open(tmp_path / "cli.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ollamamq_tpu_torch.cli", "--model", "test-tiny",
         "--device", "cpu", *flags, "--port", str(port), "--no-tui",
         "--max-slots", "2", "--num-pages", "32", "--page-size", "8",
         "--max-pages-per-seq", "8", "--blocklist", str(tmp_path / "b.json")],
        cwd=str(tmp_path), env=env, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            assert proc.poll() is None, (tmp_path / "cli.log").read_text()[-3000:]
            try:
                urllib.request.urlopen(base + "/health", timeout=2).read()
                break
            except OSError:
                time.sleep(0.2)
        req = urllib.request.Request(
            base + "/api/generate",
            data=json.dumps({"model": "test-tiny", "prompt": "hi",
                             "stream": False,
                             "options": {"num_predict": 4}}).encode(),
            headers={"X-User-ID": "tp"})
        body = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert body["done"] and body["eval_count"] == 4
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    text = (tmp_path / "cli.log").read_text()
    assert "blocked:" not in text and "graceful shutdown complete" in text
    assert "import jax" not in text
    return text


def test_cli_wide_fleet_members_run_without_jax(tmp_path):
    """`--replicas 2 --tp 2 --device cpu` serves a stream through a fleet
    whose members each lead a world of two ranks (fleet/wide.py), with
    JAX and the JAX package blocked in the router and in every member's
    rank. SIGTERM exits 0."""
    text = _serve_ranks_without_jax(tmp_path, ["--replicas", "2", "--tp", "2"])
    assert text.count("wide-member rank 1 of 2") == 2


def test_cli_tp2_leader_and_worker_run_without_jax(tmp_path):
    """`--tp 2 --device cpu` serves a stream with JAX and the JAX package
    blocked in BOTH ranks. SIGTERM exits 0."""
    text = _serve_ranks_without_jax(tmp_path, ["--tp", "2"])
    assert "tensor-parallel worker rank 1 starting" in text


@pytest.mark.parametrize("flags,ranks", [(["--dp", "2"], 1),
                                         (["--dp", "2", "--tp", "2"], 4)],
                         ids=["dp2-in-process", "dp2-tp2-ranks"])
def test_cli_dp2_replicas_run_without_jax(tmp_path, flags, ranks):
    """`--dp 2 --device cpu` serves a stream through a ReplicaSet of two
    replicas in this one process, and `--dp 2 --tp 2` through two
    replicas of two ranks each (replica 1's ranks 2 and 3 do not include
    rank 0), with JAX and the JAX package blocked in every rank. SIGTERM
    exits 0."""
    text = _serve_ranks_without_jax(tmp_path, flags)
    assert "2 data-parallel replicas" in text
    if ranks > 1:
        assert "worker rank 3 starting" in text
    else:
        assert "worker rank" not in text


def test_cli_pp2_stages_run_without_jax(tmp_path):
    """`--pp 2 --device cpu` serves a stream through both pipeline stages
    (the bucketed prefill and the pipelined decode) with JAX and the JAX
    package blocked in both ranks. SIGTERM exits 0."""
    text = _serve_ranks_without_jax(tmp_path, ["--pp", "2"])
    assert "pipeline-parallel worker rank 1 starting" in text
    assert "pp=2 serves the bucketed prefill path" in text
