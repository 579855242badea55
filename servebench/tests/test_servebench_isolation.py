"""No module of the benchmark imports JAX or the JAX package (compared
by whole top-level name: ollamamq_tpu_torch begins with ollamamq_tpu),
the reference imports nothing of the program, and a cell, a
configuration or a metric is added by new files and a new entry alone."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

from servebench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "ollamamq_tpu"}


def _modules():
    for dirpath, _, files in os.walk(spec.HERE):
        if "_cache" in dirpath:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _modules()}
    assert not {p: v for p, v in found.items() if v}


def test_reference_imports_torch_and_the_stdlib_only():
    path = os.path.join(spec.HERE, "reference.py")
    assert set(_imports(path)) <= {"__future__", "math", "typing", "torch"}


def test_a_run_loads_no_jax(tmp_path):
    """Everything a run imports, in a fresh interpreter."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import servebench.run, servebench.cell, servebench.system, servebench.trace\n"
            "import ollamamq_tpu_torch.server.app, ollamamq_tpu_torch.engine.engine\n"
            "print(sorted({m.split('.', 1)[0] for m in sys.modules} & %r))"
            % (spec.ROOT, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_new_cell_and_metric_are_files_and_entries(tmp_path):
    """A copy of the benchmark gains a cell (a traffic file, a limits
    file), a configuration and a per-layer metric (its reader) without
    an edit to any file it had."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "servebench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = spec.benchmark()
    before = {p: open(p, "rb").read() for p in
              (str(x) for x in (root / "servebench").rglob("*") if x.is_file())}
    conf = spec.load_json(os.path.join(spec.ROOT, bench["configs"][0]["file"]))
    (root / "servebench/configs/qwen3-8b-copy.json").write_text(json.dumps(conf))
    tr = spec.load_json(os.path.join(spec.HERE, "traffic", "qwen3-rag.json"))
    tr["streams"][0]["rate_rps"] = 1.0
    (root / "servebench/traffic/slow-rag.json").write_text(json.dumps(tr))
    (root / "servebench/limits/slow-rag.json").write_text(
        json.dumps({"sample": {"served_tokens": 10, "max_total": 100},
                    "compare": {"gap_max": 1.0}}))
    (root / "servebench/metrics/test.requests.py").write_text(
        "def read(run):\n    return float(len(run.requests))\n")
    bench["configs"].append(dict(bench["configs"][0], name="qwen3-8b-copy",
                                 file="servebench/configs/qwen3-8b-copy.json"))
    bench["workloads"].append({"name": "slow-rag", "config": "qwen3-8b-copy",
                               "traffic": "slow-rag", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "test.requests", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "test",
                               "moves": "output_tps", "workloads": ["slow-rag"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell("slow-rag", spec.benchmark(str(root)), str(root))
    assert cell.traffic["streams"][0]["rate_rps"] == 1.0
    assert [m["name"] for m in cell.per_layer][-1] == "test.requests"

    class Run:
        requests = [1, 2, 3]

    got = spec.read_metrics([m for m in cell.per_layer if m["name"] == "test.requests"],
                            Run, cell.here)
    assert got == {"test.requests": {"value": 3.0, "unit": "1"}}
    for p, data in before.items():
        assert open(p, "rb").read() == data
