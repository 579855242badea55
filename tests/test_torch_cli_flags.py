"""The port's CLI flags that the JAX package's CLI has: --timeout (env
TIMEOUT, with --timeout-s kept as an alias), --fault-plan (its schema
checked before any device work), --log-file / --log-rotate-mb /
--log-keep (JSON lines, env OLLAMAMQ_LOG_FILE), --metrics-buckets and
--allow-all-routes (a 501 for every path without a handler, else 404).
Each with the JAX package's exit code or behaviour: invalid values exit
2 before any device work, and one CLI server (a fake engine in a
subprocess) shows the others at work over HTTP. Then --tp and --spmd:
their refusals exit 2 before any device work (fleets of members wider
than one rank validate), `--tp 2 --device cpu`
serves through the CLI's own worker rank (gloo) and leaves no process
behind, on SIGTERM or when the leader is killed."""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from ollamamq_tpu_torch.cli import build_parser, main
from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine.fake import FakeEngine
from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
from testutil import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------- fail fast
def test_fault_plan_cli_flag_fails_fast(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"faults": [{"site": "nope"}]}))
    assert main(["--fault-plan", str(p), "--no-tui"]) == 2


@pytest.mark.parametrize("argv,message", [
    (["--metrics-buckets", "5,fast,500"], "invalid --metrics-buckets"),
    (["--metrics-buckets", ","], "at least one bound"),
    (["--log-keep", "0"], "--log-keep must be >= 1"),
    (["--log-rotate-mb", "-1"], "--log-rotate-mb must be >= 0"),
], ids=["buckets-junk", "buckets-empty", "log-keep", "log-rotate"])
def test_invalid_telemetry_flags_exit_2(argv, message, caplog):
    assert main(argv + ["--no-tui", "--device", "cpu"]) == 2
    assert message in caplog.text


def test_timeout_flag_env_and_alias(monkeypatch):
    monkeypatch.delenv("TIMEOUT", raising=False)
    assert build_parser().parse_args([]).timeout == 300.0
    assert build_parser().parse_args(["--timeout", "12"]).timeout == 12.0
    assert build_parser().parse_args(["--timeout-s", "7.5"]).timeout == 7.5
    monkeypatch.setenv("TIMEOUT", "42")
    assert build_parser().parse_args([]).timeout == 42.0
    assert build_parser().parse_args(["--timeout", "3"]).timeout == 3.0


def test_fallback_route_501_with_allow_all_routes_else_404():
    cfg = EngineConfig(model="test-tiny", max_slots=2)
    for allow, want in ((False, 404), (True, 501)):
        srv = serve_in_thread(FakeEngine(cfg, blocklist_path=None),
                              allow_all_routes=allow)
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            for method in ("GET", "POST", "DELETE"):
                req = urllib.request.Request(base + "/no/such/route",
                                             data=b"{}" if method == "POST"
                                             else None, method=method)
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(req, timeout=10)
                assert e.value.code == want, (allow, method)
                body = json.loads(e.value.read())
                if allow:
                    assert "no native handler" in body["error"]
            # Routes with handlers answer as before.
            with urllib.request.urlopen(base + "/api/version",
                                        timeout=10) as resp:
                assert resp.status == 200
        finally:
            stop_server(srv)


# ------------------------------------------------- a CLI server at work
@pytest.fixture(scope="module")
def cli_server(tmp_path_factory):
    """`python -m ollamamq_tpu_torch.cli --fake-engine` with a JSON-line
    log file, a custom latency-bucket ladder, the fallback route, and
    TIMEOUT=2 in its environment (the fake engine's tokens take 0.3 s
    each, so its longest stream, 16 tokens, outlives it)."""
    tmp = tmp_path_factory.mktemp("cli")
    port = free_port()
    log_file = tmp / "server.jsonl"
    env = dict(os.environ, TIMEOUT="2", FAKE_TOKEN_LATENCY_S="0.3",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ollamamq_tpu_torch.cli", "--fake-engine",
         "--model", "test-tiny", "--no-tui", "--port", str(port),
         "--log-file", str(log_file), "--metrics-buckets", "5,50,500",
         "--allow-all-routes", "--blocklist", str(tmp / "blocked.json")],
        cwd=str(tmp), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        try:
            urllib.request.urlopen(base + "/health", timeout=2).read()
            break
        except OSError:
            time.sleep(0.1)
    else:
        proc.kill()
        raise RuntimeError(proc.communicate()[0].decode()[-2000:])
    yield {"base": base, "log_file": log_file, "proc": proc}
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _generate(base, n, stream=False):
    req = urllib.request.Request(
        base + "/api/generate",
        data=json.dumps({"model": "test-tiny", "prompt": "hi",
                         "stream": stream,
                         "options": {"num_predict": n}}).encode(),
        headers={"X-User-ID": "flags"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read()


def test_metrics_buckets_set_the_latency_histograms(cli_server):
    status, _ = _generate(cli_server["base"], 2)
    assert status == 200
    with urllib.request.urlopen(cli_server["base"] + "/metrics",
                                timeout=10) as resp:
        text = resp.read().decode()
    bounds = [line.split('le="')[1].split('"')[0] for line in
              text.splitlines()
              if line.startswith("ollamamq_ttft_ms_bucket")]
    assert bounds == ["5", "50", "500", "+Inf"]


def test_allow_all_routes_flag_serves_the_501_fallback(cli_server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(cli_server["base"] + "/api/not-a-route",
                               timeout=10)
    assert e.value.code == 501


def test_timeout_env_is_honoured(cli_server):
    """TIMEOUT=2: a request that would take 4.8 s is cut at the server's
    timeout (cancelled engine-side) and answered as an error."""
    t0 = time.monotonic()
    with pytest.raises(urllib.error.HTTPError) as e:
        _generate(cli_server["base"], 16)
    assert e.value.code == 500
    assert "request timeout" in json.loads(e.value.read())["error"]
    assert time.monotonic() - t0 < 8.0


def test_log_file_writes_json_lines(cli_server):
    status, _ = _generate(cli_server["base"], 2)
    assert status == 200
    lines = cli_server["log_file"].read_text().splitlines()
    assert lines
    objs = [json.loads(line) for line in lines]  # every line parses
    for obj in objs:
        assert set(obj) >= {"ts", "level", "logger", "msg"}
        assert obj["ts"].endswith("Z")
    assert any(o["msg"].startswith("serving test-tiny") for o in objs)


# ------------------------------------------------- tensor parallelism
def _assert_valid(argv):
    """The flags validate (a case of the fleet's widths that used to be
    refused, in the parametrized refusal tests)."""
    from ollamamq_tpu_torch.cli import validate

    args = build_parser().parse_args(argv + ["--no-tui", "--model", "test-tiny"])
    assert validate(args) == ""


@pytest.mark.parametrize("argv,message", [
    (["--tp", "3", "--device", "cpu"], "num_heads=4 not divisible by tp=3"),
    (["--tp", "0", "--device", "cpu"], "--tp must be >= 1"),
    (["--tp", "2"], "cuda:1"),
    (["--tp", "2", "--fake-engine", "--device", "cpu"], "--fake-engine runs none"),
    (["--tp", "2", "--replicas", "2", "--device", "cpu"], None),
    (["--spmd", "--fake-engine"], "--spmd and --fake-engine are mutually exclusive"),
    (["--spmd", "--replicas", "2"], "and --spmd are mutually exclusive"),
], ids=["heads", "zero", "missing-device", "fake", "fleet", "spmd-fake",
        "spmd-fleet"])
def test_tp_flags_exit_2(argv, message, caplog):
    """A tp that does not divide the heads, a local --tp whose devices the
    host lacks (named; no fallback to fewer devices), and the --spmd and
    fake-engine combinations exit 2 before any device work. A fleet of
    --tp 2 members on the CPU validates (message None): fleet members
    wider than one rank are ported (fleet/wide.py)."""
    if message is None:
        _assert_valid(argv)
        return
    if argv == ["--tp", "2"] and torch.cuda.device_count() >= 2:
        argv = ["--tp", "64", "--model", "llama3:8b"]
        message = "cuda:63"
    assert main(argv + ["--no-tui", "--model", "test-tiny"]
                if "--model" not in argv else argv + ["--no-tui"]) == 2
    assert message in caplog.text


@pytest.mark.parametrize("argv,message", [
    (["--pp", "4", "--device", "cpu"], "pp=4 must divide num_layers=2 (test-tiny)"),
    (["--pp", "2", "--device", "cpu", "--model", "test-tiny-moe"],
     "pp with an MoE model is not supported"),
    (["--pp", "0", "--device", "cpu"], "--pp must be >= 1"),
    (["--pp", "2"], "cuda:1"),
    (["--pp", "2", "--tp", "2", "--device", "cpu", "--model", "test-tiny-gqa",
      "--pp-microbatches", "-1"], "--pp-microbatches must be >= 0"),
    (["--pp", "2", "--replicas", "2", "--device", "cpu"], None),
    (["--pp", "2", "--autoscale", "--device", "cpu"], None),
    (["--pp", "2", "--replica-urls", "http://127.0.0.1:1", "--device", "cpu"],
     None),
    (["--pp", "2", "--kv-dtype", "int8", "--device", "cpu"],
     "--kv-dtype=int8 needs the ragged attention path"),
], ids=["layers", "moe", "zero", "missing-device", "microbatches", "fleet",
        "autoscale", "replica-urls", "int8-kv"])
def test_pp_flags_exit_2(argv, message, caplog):
    """--pp's refusals exit 2 before any device work: a pp that does not
    divide a model's layers, pp with a mixture-of-experts model, a local
    world whose devices the host lacks (tp x pp ranks, one per device;
    named, no fallback), and int8 KV with pp (the JAX package's message).
    pp with a fleet on the CPU validates (message None): each member
    leads a pipeline world of its own (fleet/wide.py)."""
    if message is None:
        _assert_valid(argv)
        return
    if argv == ["--pp", "2"] and torch.cuda.device_count() >= 2:
        argv = ["--pp", "32", "--model", "llama3:8b"]
        message = "cuda:31"
    assert main(argv + ["--no-tui", "--model", "test-tiny"]
                if "--model" not in argv else argv + ["--no-tui"]) == 2
    assert message in caplog.text


def test_pp_flags_reach_the_engine_config():
    """--pp and --pp-microbatches land in EngineConfig (0 microbatches:
    None, one per stage), with the JAX CLI's defaults."""
    from ollamamq_tpu_torch.cli import build_parser, engine_config

    d = engine_config(build_parser().parse_args([]))
    assert (d.pp, d.pp_microbatches) == (1, None)
    e = engine_config(build_parser().parse_args(["--pp", "2", "--pp-microbatches", "4"]))
    assert (e.pp, e.pp_microbatches) == (2, 4)


# ------------------------------------------------- sequence parallelism
@pytest.mark.parametrize("argv,message", [
    (["--sp", "2", "--kv-dtype", "int8", "--device", "cpu"],
     "--kv-dtype=int8 is unsupported with sequence-parallel prefill"),
    (["--sp", "2", "--pp", "2", "--device", "cpu"],
     "pp and sp cannot combine on one runtime"),
    (["--sp", "0", "--device", "cpu"], "--sp must be >= 1"),
    (["--sp", "2"], "cuda:1"),
    (["--sp", "2", "--tp", "2"], "cuda:3"),
    (["--sp", "2", "--fake-engine", "--device", "cpu"], "--fake-engine runs none"),
    (["--sp", "2", "--replicas", "2"], "cuda:0"),
    (["--sp", "2", "--device", "cpu"], None),
    (["--sp", "2", "--tp", "2", "--dp", "2", "--device", "cpu",
      "--model", "test-tiny-gqa"], None),
], ids=["int8-kv", "pp", "zero", "missing-device", "missing-device-tp", "fake",
        "fleet", "cpu", "dp-tp-cpu"])
def test_sp_flags_exit_2(argv, message, caplog):
    """--sp's refusals exit 2 before any device work: int8 KV with sp and
    pp x sp (the JAX package's messages), a local world whose devices the
    host lacks (sp x tp ranks, one per device; named, no fallback), the
    fake engine, and a fleet whose sp members need cards of their own
    that the host lacks. sp on the CPU, alone or with tp and dp,
    validates (message None)."""
    if message is None:
        _assert_valid(argv)
        return
    if "cuda:" in message and torch.cuda.device_count() >= 2:
        argv, message = ["--sp", "32", "--model", "llama3:8b"], "cuda:31"
    assert main(argv + ["--no-tui", "--model", "test-tiny"]
                if "--model" not in argv else argv + ["--no-tui"]) == 2
    assert message in caplog.text


def test_sp_flag_reaches_the_engine_config_and_the_world():
    """--sp lands in EngineConfig (the JAX CLI's default 1) and sizes the
    local rank world: dp x pp x sp x tp ranks."""
    from ollamamq_tpu_torch.cli import build_parser, engine_config, local_world

    assert engine_config(build_parser().parse_args([])).sp == 1
    args = build_parser().parse_args(["--sp", "2", "--tp", "2", "--dp", "2"])
    assert engine_config(args).sp == 2 and local_world(args) == 8
    assert local_world(build_parser().parse_args(["--sp", "4"])) == 4


# ------------------------------------------------- expert parallelism
@pytest.mark.parametrize("argv,message", [
    (["--ep", "3", "--model", "test-tiny-moe", "--device", "cpu"],
     "ep=3 must divide num_experts=4 (test-tiny-moe)"),
    (["--ep", "3", "--model", "mixtral:8x7b"],
     "ep=3 must divide num_experts=8 (mixtral:8x7b)"),
    (["--ep", "2", "--pp", "2", "--model", "mixtral:8x7b"],
     "pp with an MoE model is not supported"),
    (["--ep", "2", "--weights-dtype", "int8", "--model", "mixtral:8x7b"],
     "--weights-dtype=int8 does not cover MoE expert stacks"),
    (["--ep", "0", "--device", "cpu"], "--ep must be >= 1"),
    (["--ep", "2"], "cuda:1"),
    (["--ep", "2", "--fake-engine", "--device", "cpu"], "--fake-engine runs none"),
    (["--ep", "2", "--device", "cpu"], None),
    (["--ep", "2", "--tp", "2", "--dp", "2", "--device", "cpu"], None),
    (["--ep", "4", "--model", "test-tiny-moe", "--device", "cpu"], None),
], ids=["not-dividing", "not-dividing-mixtral", "pp-moe", "int8-moe", "zero",
        "missing-device", "fake", "dense-cpu", "dp-tp-cpu", "moe-cpu"])
def test_ep_flags_exit_2(argv, message, caplog):
    """--ep's refusals exit 2 before any device work, with the JAX
    package's reasons: an ep that does not divide an MoE model's experts
    (naming both), pp with an MoE model, int8 weights on an MoE model,
    --ep 0, a local world whose devices the host lacks (ep ranks, one per
    device; named, no fallback) and the fake engine. ep on the CPU, on a
    dense model too and with tp and dp, validates (message None)."""
    if message is None:
        from ollamamq_tpu_torch.cli import validate

        args = build_parser().parse_args(argv + ["--no-tui"] + (
            [] if "--model" in argv else ["--model", "test-tiny"]))
        assert validate(args) == ""
        return
    if "cuda:" in message and torch.cuda.device_count() >= 2:
        argv, message = ["--ep", "32", "--model", "llama3:8b"], "cuda:31"
    assert main(argv + ["--no-tui", "--model", "test-tiny"]
                if "--model" not in argv else argv + ["--no-tui"]) == 2
    assert message in caplog.text


def test_ep_flag_reaches_the_engine_config_and_the_world():
    """--ep lands in EngineConfig (the JAX CLI's default 1) and sizes the
    local rank world: dp x pp x sp x ep x tp ranks."""
    from ollamamq_tpu_torch.cli import engine_config, local_world

    assert engine_config(build_parser().parse_args([])).ep == 1
    args = build_parser().parse_args(["--ep", "2", "--tp", "2", "--dp", "2"])
    assert engine_config(args).ep == 2 and local_world(args) == 8
    assert local_world(build_parser().parse_args(["--ep", "4"])) == 4
    assert local_world(build_parser().parse_args(["--ep", "2", "--sp", "2"])) == 4


# ------------------------------------------------- data parallelism
@pytest.mark.parametrize("argv,message", [
    (["--dp", "2"], "no replica falls back to another device"),
    (["--dp", "2", "--tp", "2"], "cuda:3"),
    (["--dp", "0", "--device", "cpu"], "--dp must be >= 1"),
    (["--dp", "2", "--tp", "2", "--replicas", "2", "--device", "cpu"], None),
    (["--dp", "2", "--spmd", "--replicas", "2"],
     "and --spmd are mutually exclusive"),
    (["--dp", "2", "--tp", "3", "--device", "cpu"],
     "num_heads=4 not divisible by tp=3"),
], ids=["too-few-cards", "too-few-cards-for-ranks", "zero", "wide-fleet",
        "spmd-fleet", "heads"])
def test_dp_flags_exit_2(argv, message, caplog):
    """--dp's refusals exit 2 before any device work: a host with fewer
    cards than the replicas (one per replica of --dp alone, one per rank
    of --dp x --tp; the missing ones named, no replica falls back to
    another device or to the CPU), --dp 0, and the reference's --spmd
    rule, which --dp leaves as it is. A fleet of dp x tp members on the
    CPU validates (message None): fleet members wider than one rank are
    ported (fleet/wide.py)."""
    if message is None:
        _assert_valid(argv)
        return
    if torch.cuda.device_count() >= 2 and "--device" not in argv:
        argv = [a if a != "2" or i != 1 else "64" for i, a in enumerate(argv)]
        message = "cuda:63" if "--tp" not in argv else "cuda:127"
    assert main(argv + ["--no-tui", "--model", "test-tiny"]) == 2
    assert message in caplog.text


@pytest.mark.parametrize("argv", [
    ["--dp", "2", "--device", "cpu"],
    ["--dp", "2", "--replicas", "2", "--device", "cpu"],
    ["--dp", "2", "--replicas", "2", "--tiers", "interactive=r0;bulk=r1",
     "--device", "cpu"],
    ["--dp", "2", "--replicas", "1", "--autoscale", "--device", "cpu"],
    ["--dp", "2", "--replica-urls", "http://127.0.0.1:1", "--device", "cpu"],
    ["--dp", "2", "--fake-engine"],
], ids=["alone", "replicas", "tiers", "autoscale", "replica-urls", "fake"])
def test_dp_combinations_follow_the_reference(argv):
    """The JAX CLI's rules for dp: it rides in the engine config, so
    every in-process fleet member (--replicas, the autoscaler's, any
    tier) serves dp replicas of its own; --replica-urls and the fake
    engine take it as they are. None of these is refused."""
    from ollamamq_tpu_torch import cli

    args = build_parser().parse_args(argv + ["--model", "test-tiny"])
    assert cli.validate(args) == ""
    ecfg = cli.engine_config(args)
    assert ecfg.dp == 2
    if cli.is_fleet(args) and args.replicas:
        built = []

        def make(cfg):
            built.append(cfg.dp)
            return FakeEngine(cfg, models={"test-tiny": None},
                              blocklist_path=None)

        router = cli.build_fleet(args, ecfg, make)
        assert built == [2] * args.replicas
        assert len(router.local_members) == args.replicas


def test_dp_cpu_serves_replicas_in_one_process():
    """--dp 2 --device cpu builds one engine whose model is a ReplicaSet
    of two replicas (one per CPU "device"); --dp 1 builds one runtime."""
    from ollamamq_tpu_torch import cli
    from ollamamq_tpu_torch.engine.engine import ReplicaSet, TorchEngine

    for dp, want in ((2, 2), (1, 1)):
        args = build_parser().parse_args(
            ["--dp", str(dp), "--device", "cpu", "--model", "test-tiny",
             "--max-slots", "2", "--num-pages", "16", "--page-size", "8",
             "--max-pages-per-seq", "4"])
        eng = TorchEngine(cli.engine_config(args), device=args.device,
                          blocklist_path=None)
        rt = eng.runtimes["test-tiny"]
        reps = rt.replicas if isinstance(rt, ReplicaSet) else [rt]
        assert len(reps) == want and (eng.mesh is None) == (dp == 1)
        assert len(eng.chip_stats()) == 1  # both replicas on the one CPU


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def _tp2_cli(tmp_path, width=("--tp", "2")):
    """`--tp 2 --device cpu` (or another two-rank `width`) in a
    subprocess, serving; returns (proc, base URL, worker pid, log
    path)."""
    port = free_port()
    log = tmp_path / "tp2.log"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ollamamq_tpu_torch.cli", "--model", "test-tiny",
         "--device", "cpu", *width, "--dtype", "float32", "--no-tui",
         "--port", str(port), "--max-slots", "2", "--num-pages", "32",
         "--page-size", "8", "--max-pages-per-seq", "8",
         "--blocklist", str(tmp_path / "blocked.json")],
        cwd=str(tmp_path), env=env, stdout=open(log, "w"),
        stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        assert proc.poll() is None, log.read_text()[-3000:]
        try:
            urllib.request.urlopen(base + "/health", timeout=2).read()
            break
        except OSError:
            time.sleep(0.2)
    line = next(ln for ln in log.read_text().splitlines()
                if "started 1 worker rank(s)" in ln)
    return proc, base, int(line.split("[")[-1].rstrip("]")), log


def test_tp2_cpu_serves_through_the_cli_and_reaps_its_worker(tmp_path):
    """`--tp 2 --device cpu` starts one worker rank, streams the greedy ids
    of the port at tp 1 (float32, seeded weights), reports both ranks'
    devices, and on SIGTERM drains, releases the worker and exits 0 with
    no process left behind."""
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.ops.sampling import SamplingParams

    proc, base, worker, log = _tp2_cli(tmp_path)
    try:
        assert _alive(worker)
        req = urllib.request.Request(
            base + "/api/generate",
            data=json.dumps({"model": "test-tiny", "prompt": "tensor ranks",
                             "stream": False,
                             "options": {"num_predict": 6,
                                         "temperature": 0}}).encode(),
            headers={"X-User-ID": "tp"})
        body = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert body["done"] and body["eval_count"] == 6
        health = json.loads(urllib.request.urlopen(base + "/health",
                                                   timeout=10).read())
        assert [c["process"] for c in health["chips"]] == [0, 1]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert not _alive(worker), log.read_text()[-3000:]
    assert "graceful shutdown complete" in log.read_text()
    eng = TorchEngine(EngineConfig(model="test-tiny", max_slots=2, num_pages=32,
                                   page_size=8, max_pages_per_seq=8,
                                   dtype="float32"),
                      device="cpu", blocklist_path=None)
    eng.start()
    try:
        r = eng.enqueue_request("tp", "", "test-tiny",
                                prompt_tokens=eng.runtimes["test-tiny"]
                                .tokenizer.encode("tensor ranks"),
                                sampling=SamplingParams(max_tokens=6,
                                                        temperature=0.0))
        while not r.stats.finished_at:
            time.sleep(0.05)
        assert r.generated_ids == body["token_ids"]
    finally:
        eng.stop()


def test_tp2_worker_dies_with_a_killed_leader(tmp_path):
    """kill -9 of the --tp leader leaves no worker rank behind."""
    proc, _, worker, log = _tp2_cli(tmp_path)
    proc.kill()
    proc.wait()
    deadline = time.monotonic() + 20
    while _alive(worker) and time.monotonic() < deadline:
        time.sleep(0.1)
    assert not _alive(worker), log.read_text()[-3000:]


def test_ep2_dense_model_serves_through_the_cli(tmp_path):
    """`--ep 2 --device cpu` on the dense test-tiny starts one worker
    rank and streams the greedy ids of the port at ep 1 (the model is
    replicated over the expert axis); SIGTERM releases the worker."""
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.ops.sampling import SamplingParams

    proc, base, worker, log = _tp2_cli(tmp_path, width=("--ep", "2"))
    try:
        req = urllib.request.Request(
            base + "/api/generate",
            data=json.dumps({"model": "test-tiny", "prompt": "expert ranks",
                             "stream": False,
                             "options": {"num_predict": 6, "temperature": 0,
                                         "repeat_penalty": 1.0}}).encode(),
            headers={"X-User-ID": "ep"})
        body = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert body["done"] and body["eval_count"] == 6
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert not _alive(worker), log.read_text()[-3000:]
    eng = TorchEngine(EngineConfig(model="test-tiny", max_slots=2, num_pages=32,
                                   page_size=8, max_pages_per_seq=8,
                                   dtype="float32"),
                      device="cpu", blocklist_path=None)
    eng.start()
    try:
        r = eng.enqueue_request("ep", "", "test-tiny",
                                prompt_tokens=eng.runtimes["test-tiny"]
                                .tokenizer.encode("expert ranks"),
                                sampling=SamplingParams(max_tokens=6,
                                                        temperature=0.0))
        while not r.stats.finished_at:
            time.sleep(0.05)
        assert r.generated_ids == body["token_ids"]
    finally:
        eng.stop()
