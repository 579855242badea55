"""The port stands alone: every module of ollamamq_tpu_torch imports and
serves a request (bf16/f32, then int8 weights and int8 KV pages, then
with the prefix cache, speculation and an injected ragged fault that is
retried, then under srpt with token fairness and a /metrics scrape, then
several models: an encoder pulled, embedded with and deleted over HTTP,
and a safetensors checkpoint written and served) with JAX, the JAX
package, safetensors and tokenizers all blocked from import, and
without a GPU the engine refuses to start unless the CPU is asked for.

Runs in a subprocess because this test session's conftest imports JAX.
"""

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import sys


class _Blocked:
    # Importing any of these fails: the port needs none of them.
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ollamamq_tpu", "safetensors",
                                  "tokenizers"):
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
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "ollamamq_tpu",
                                             "safetensors", "tokenizers")),
    "refused": refused,
    "cuda": torch.cuda.is_available(),
}))
"""


def test_port_imports_and_serves_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO + (os.pathsep + os.environ["PYTHONPATH"]
                                if os.environ.get("PYTHONPATH") else "")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
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
                "ollamamq_tpu_torch.server.registry", "ollamamq_tpu_torch.engine.tokenizer"}
    assert expected <= set(out["modules"])
    if not out["cuda"]:
        # No GPU and no device="cpu": the engine raises, never falls back.
        assert out["refused"] and "no CUDA device" in out["refused"]
    assert torch.cuda.is_available() == out["cuda"]
