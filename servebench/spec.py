"""BENCHMARK.json and the files it names: a cell's configuration,
traffic mix and per-layer metric readers, each found by its name.

Stdlib only. A configuration file keeps the published config.json's keys
at its top level (as published, except those `reduced` lists) beside the
keys the harness adds: `engine` (EngineConfig fields), `program` (the
port's own model options), `chat` (the prompt template the port renders
for this model family), `source`, `reduced`, `assumed`, `deployment`.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def arch(conf: dict) -> dict:
    """The sizes the harness computes with, from a configuration file's
    published keys."""
    d = conf["hidden_size"]
    heads = conf["num_attention_heads"]
    experts = conf.get("num_local_experts", 0) or 0
    if conf.get("attention_bias"):
        raise ValueError("attention bias is not covered by the reference")
    return {
        "V": conf["vocab_size"], "D": d, "F": conf["intermediate_size"],
        "L": conf["num_hidden_layers"], "H": heads,
        "Hk": conf["num_key_value_heads"],
        "hd": conf.get("head_dim") or d // heads,
        "E": experts, "K": conf.get("num_experts_per_tok", 0) if experts else 0,
        "tied": bool(conf.get("tie_word_embeddings", False)),
        "qk_norm": conf.get("model_type") == "qwen3",
        "theta": float(conf["rope_theta"]), "eps": float(conf["rms_norm_eps"]),
        "max_pos": conf["max_position_embeddings"],
    }


class Cell:
    """One workload of BENCHMARK.json with everything its name leads to:
    its configuration file, servebench/traffic/<traffic>.json,
    servebench/limits/<workload>.json (what the check compares, and its
    limits) and the metrics it reports."""

    def __init__(self, name: str, bench: dict, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(has {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        entry = configs[self.workload["config"]]
        self.config_name = entry["name"]
        self.conf = load_json(os.path.join(root, entry["file"]))
        self.arch = arch(self.conf)
        self.here = os.path.join(root, "servebench")
        self.traffic = load_json(os.path.join(
            self.here, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(self.here, "limits", name + ".json"))
        self.chips = self.workload["chips"]
        self.end_to_end = [m for m in bench["end_to_end"] if self.reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self.reports(m)]

    def reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def reader(metric_name: str, here: str = HERE) -> Callable:
    """metrics/<name>.py's read(run) -> value or None."""
    path = os.path.join(here, "metrics", metric_name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "servebench.metrics." + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run, here: str = HERE) -> Dict[str, dict]:
    """Each metric that its reader finds something for."""
    out = {}
    for m in metrics:
        value: Optional[float] = reader(m["name"], here)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
