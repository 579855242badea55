"""The port stands alone: every module of ollamamq_tpu_torch imports and
serves a request (bf16/f32, then int8 weights and int8 KV pages) without
JAX or the JAX package ever being imported, and without a GPU the engine
refuses to start unless the CPU is asked for.

Runs in a subprocess because this test session's conftest imports JAX.
"""

import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, json, pkgutil, sys, urllib.request
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

cfg = EngineConfig(model="test-tiny", max_slots=2, num_pages=32, page_size=8,
                   max_pages_per_seq=8, max_new_tokens=4)


def serve_one(ecfg):
    srv = serve_in_thread(TorchEngine(ecfg, device="cpu", dtype=torch.float32))
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.server_address[1]}/api/generate",
        data=json.dumps({"model": "test-tiny", "prompt": "hi", "stream": False,
                         "options": {"temperature": 0}}).encode(),
        headers={"X-User-ID": "solo"})
    body = json.loads(urllib.request.urlopen(req, timeout=60).read())
    stats = srv.engine.stats()["runtimes"][0]
    stop_server(srv)
    return body, stats


body, _ = serve_one(cfg)
body8, stats8 = serve_one(dataclasses.replace(cfg, weights_dtype="int8",
                                              kv_dtype="int8"))

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
    "dtypes_int8": [stats8["weights_dtype"], stats8["kv_dtype"]],
    "foreign": sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "ollamamq_tpu")),
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
    expected = {"ollamamq_tpu_torch.engine.engine", "ollamamq_tpu_torch.server.app",
                "ollamamq_tpu_torch.ops.cuda.paged_attention",
                "ollamamq_tpu_torch.ops.cuda.ragged_attention",
                "ollamamq_tpu_torch.models.llama", "ollamamq_tpu_torch.cli",
                "ollamamq_tpu_torch.ops.quant", "ollamamq_tpu_torch.models.weights"}
    assert expected <= set(out["modules"])
    if not out["cuda"]:
        # No GPU and no device="cpu": the engine raises, never falls back.
        assert out["refused"] and "no CUDA device" in out["refused"]
    assert torch.cuda.is_available() == out["cuda"]
