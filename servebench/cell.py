"""One run of one cell: set-up, the measured window, the readings, the
check of the served tokens against the reference.

Set-up (setup_s) runs from the process's start to the first due
request: imports, the weights made on the device, the engine and server
up, and the warm-up of the cell's own shapes. The window then runs for
`seconds` from the first due time: the load generator, a child process,
sends the cell's schedule on time whether or not earlier requests have
finished, and shuts every open connection at the window's close. What a
metric reads is what arrived by the close.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List

import torch

from servebench import check, counts, spec, stats, traffic
from servebench.system import System, device_name

SLICE_S = 4.0  # the traced run's profiled slice: the window's last seconds


class Run:
    """What the metric readers read (servebench/metrics/<name>.py)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _merge(schedule: List[dict], results: List[dict], t0: float) -> List[dict]:
    by_i = {r["i"]: r for r in results}
    out = []
    for s in schedule:
        r = by_i.get(s["i"], {"sent": None, "frames": [], "ids": [], "done": False,
                              "reason": None, "error": "never sent",
                              "prompt_eval_count": None})
        out.append(dict(s, **r, due_at=t0 + s["due"]))
    return out


def _loadgen(job: dict) -> subprocess.Popen:
    proc = subprocess.Popen(
        [sys.executable, os.path.join(spec.HERE, "loadgen.py")],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    proc.stdin.write(json.dumps(job))
    proc.stdin.close()
    proc.stdin = None  # written: communicate() only reads
    return proc


def _wait_until(t: float) -> None:
    while True:
        d = t - time.monotonic()
        if d <= 0:
            return
        time.sleep(min(d, 0.5))


def run(cell, seed: int, seconds: float, trace: bool, device, t_process: float,
        limits: dict, precision: str = "bfloat16", log=print,
        control=None, gen_cpus=None) -> dict:
    """The result object of one run (before the JAX check). `control`
    (servebench/control.py only) reads a control's numbers on the same
    sample after the check. `gen_cpus` pins the window's load generator."""
    from servebench.trace import Hooks

    conf, a, tr = cell.conf, cell.arch, cell.traffic
    system = System(cell.config_name, conf, a, seed, device, precision)
    hooks = None
    try:
        warm = system.warm_up(tr["streams"], tr["sampling"])
        sched = traffic.schedule(tr, conf["chat"], seed, seconds)
        if trace:
            hooks = Hooks(system)
            hooks.install()
        job = {"port": system.port, "model": system.name,
               "sampling": tr["sampling"], "timeout_s": seconds + 600,
               "requests": [{k: r[k] for k in ("i", "due", "user", "text",
                                               "max_tokens")} for r in sched]}
        t0 = time.monotonic() + 0.5
        t1 = t0 + seconds
        proc = _loadgen(dict(job, t0=t0, t_close=t1, cpus=gen_cpus))
        if trace:
            _wait_until(t1 - min(SLICE_S, seconds / 2))
            hooks.begin_slice()
            _wait_until(t1)
            hooks.end_slice()
        out, err = proc.communicate(timeout=seconds + 300)
        if proc.returncode != 0:
            raise RuntimeError(f"load generator exited {proc.returncode}: {err[-2000:]}")
        gen = json.loads(out)
        memory_peak = (torch.cuda.max_memory_allocated(device)
                       if torch.device(device).type == "cuda" else 0)
        summary = engine_reqs = steps = None
        if hooks is not None:
            summary = hooks.export()
            hooks.close()
            engine_reqs = [_req_times(r) for r in hooks.requests]
            wall0 = time.time() - (time.monotonic() - t0)
            lo, hi = hooks.slice_wall
            steps = [s for s in hooks.steps.values()
                     if wall0 <= s["ts"] <= wall0 + seconds and not lo <= s["ts"] <= hi]
    finally:
        if hooks is not None:
            hooks.close()
        system.close()
    reqs = _merge(sched, gen["results"], t0)
    name = device_name(device)
    r = Run(cell=cell, arch=a, conf=conf, traffic=tr, seed=seed, seconds=seconds,
            t0=t0, t1=t1, setup_s=t0 - t_process, requests=reqs,
            device_name=name, peaks=counts.peaks(name) if name else None,
            engine_requests=engine_reqs, steps=steps, trace=summary,
            ragged_calls=hooks.ragged_calls if hooks else None,
            page_size=conf["engine"]["page_size"])
    log(json.dumps({"loadgen": gen["late"], "open_at_close": gen["open_at_close"],
                    "warm_up": warm}))
    if summary is not None:
        log(json.dumps({"trace": {k: summary[k] for k in (
            "window_s", "busy_s", "device_s", "by_range", "range_counts",
            "idle_by_host", "gpu_events", "host_runtime_s")},
            "steps": _phase_means(steps), "ragged_dispatches": len(r.ragged_calls)}))
    here = getattr(cell, "here", spec.HERE)
    metrics = spec.read_metrics(cell.per_layer if trace else cell.end_to_end, r, here)
    # every reading this run can give, on an earlier line
    log(json.dumps({"readings": {k: v["value"] for k, v in spec.read_metrics(
        cell.end_to_end + cell.per_layer, r, here).items()}}))
    failed = sum(1 for q in reqs if q["error"])
    compared, verdict = compare(cell, seed, reqs, t1, device, limits, log, control)
    result = {"correct": verdict, "attempted": len(reqs), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if name else "cpu",
                         "kind": name or "cpu", "count": cell.chips,
                         "memory_peak_bytes": int(memory_peak)}}
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {
            "device_ops": stats.sorted_desc(summary["by_op"].items(), 10),
            "idle_gaps": stats.sorted_desc(summary["idle_by_host"].items(), 10)}
    result["compared"] = compared
    return result


def _phase_means(steps) -> dict:
    """The step profiler's mean ms per phase, by mode."""
    out: Dict[str, dict] = {}
    for s in steps or []:
        m = out.setdefault(s["mode"], {"n": 0})
        m["n"] += 1
        for k, v in s.items():
            if k.endswith("_ms"):
                m[k] = m.get(k, 0.0) + v
    for m in out.values():
        for k in list(m):
            if k.endswith("_ms"):
                m[k] /= m["n"]
    return out


def _req_times(req) -> dict:
    st = req.stats
    return {"user": req.user, "enqueued_at": st.enqueued_at,
            "prefill_started_at": st.prefill_started_at,
            "first_token_at": st.first_token_at}


def compare(cell, seed: int, reqs: List[dict], t1: float, device, limits: dict,
            log=print, control=None):
    """(numbers beside their limits, correct) for the finished requests
    of the window."""
    finished = [q for q in reqs if q["done"] and q.get("t_done", t1 + 1) <= t1
                and q["ids"]]
    sample = check.draw(finished, seed, **limits["sample"])
    if not sample:
        log(json.dumps({"check": "no request finished inside the window"}))
        return {}, False
    chat = cell.conf["chat"]
    bad = check.inputs_agree(sample, chat)
    t = time.monotonic()
    ref = check.reference_logits(cell.arch, seed, sample, chat, device)
    gaps = check.served_gaps(ref, [q["ids"] for q in sample])
    numbers = check.gap_numbers(gaps)
    compared = check.judge(numbers, limits["compare"])
    log(json.dumps({"check": {"requests": len(sample),
                              "served_tokens": int(gaps.numel()),
                              "reference_s": time.monotonic() - t,
                              "numbers": numbers, "input_faults": bad[:5]}}))
    if control is not None:
        log(json.dumps({"control": control(cell, seed, sample, ref, device)}))
    return compared, bool(not bad and check.passed(compared))


