"""The traced run's instruments, from the harness's side of the program.

Installed in a `--trace 1` run only:

- a hook at the top of each engine tick (TorchEngine._loop_once): the
  profiled slice starts and stops there, on the engine thread (whose
  ranges the profiler records), between ticks, with the device idle;
- record_function ranges around the runtime's step_ragged,
  step_decode_dispatch and step_decode_collect (the host ranges the idle
  gaps are labelled by), and around every ragged-attention,
  decode-attention and moe_mlp call of the model (the device time of
  the kernels launched inside them);
- while the slice runs, the host-side inputs of every ragged dispatch
  (each span's q_len and kv_len), from which counts.py counts the
  ragged attention calls' work;
- every Request the engine takes (its RequestStats timestamps), and the
  step profiler's samples (read every second, as its ring is bounded).

The slice is the window's last `seconds`: torch.profiler records CPU
ops, CUDA runtime calls and device activity (a whole window is about a
million kernel events), and its stop, which holds the engine, then falls
after the window's close. summarize() reduces the exported Chrome trace.
"""

from __future__ import annotations

import bisect
import inspect
import json
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch

PREFIX = "servebench."
STEP_RANGES = ("step_ragged", "decode_dispatch", "decode_collect")
CALL_RANGES = ("ragged_attn", "decode_attn", "moe_mlp")
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _ranged(name: str, fn):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(PREFIX + name):
            return fn(*args, **kwargs)

    return wrapped


class Hooks:
    def __init__(self, system):
        from ollamamq_tpu_torch.models import llama
        from ollamamq_tpu_torch.telemetry import stepprof

        self.engine, self.rt = system.engine, system.rt
        self.llama, self.stepprof = llama, stepprof
        # An action the engine thread runs between two ticks (the profiler
        # starts and stops on the thread whose ranges it records).
        self._action = None
        self._action_error = None
        self._action_done = threading.Event()
        self.recording = False
        self.ragged_calls: List[List[tuple]] = []  # per dispatch: (q_len, kv_len)
        self.requests: List = []
        self.steps: Dict[int, dict] = {}
        self._saved_llama = {}
        self._stop = threading.Event()
        self._sampler = None
        self.prof = None
        self.slice_wall = None

    def install(self) -> None:
        eng, rt, llama = self.engine, self.rt, self.llama
        loop_once = eng._loop_once

        def tick():
            act, self._action = self._action, None
            if act is not None:
                try:
                    act()
                except Exception as e:  # noqa: BLE001 — raised in the harness
                    self._action_error = e
                finally:
                    self._action_done.set()
            loop_once()

        eng._loop_once = tick
        rt.step_ragged = _ranged("step_ragged", rt.step_ragged)
        rt.step_decode_dispatch = _ranged("decode_dispatch", rt.step_decode_dispatch)
        rt.step_decode_collect = _ranged("decode_collect", rt.step_decode_collect)
        for attr, name in (("ragged_attention_any", "ragged_attn"),
                           ("paged_decode_attention_any", "decode_attn"),
                           ("moe_mlp", "moe_mlp")):
            self._saved_llama[attr] = getattr(llama, attr)
            setattr(llama, attr, _ranged(name, getattr(llama, attr)))
        ragged = rt._ragged_dispatch
        ragged_sig = inspect.signature(ragged)

        def ragged_dispatch(*args, **kwargs):
            if self.recording:
                b = ragged_sig.bind(*args, **kwargs).arguments
                self.ragged_calls.append([(int(q), int(k)) for q, k in
                                          zip(b["q_len"], b["kv_len"]) if q > 0])
            return ragged(*args, **kwargs)

        rt._ragged_dispatch = ragged_dispatch
        enqueue = eng.enqueue_request

        def enqueue_request(*args, **kwargs):
            req = enqueue(*args, **kwargs)
            self.requests.append(req)
            return req

        eng.enqueue_request = enqueue_request
        # The profiler's first start takes seconds (set-up, not the slice).
        def warm():
            p = self._profiler()
            p.start()
            p.stop()

        self._between_ticks(warm)
        self._sampler = threading.Thread(target=self._sample_steps, daemon=True,
                                         name="servebench-steps")
        self._sampler.start()

    def _read_steps(self) -> None:
        for s in self.stepprof.PROFILER.tail():
            self.steps.setdefault(s["seq"], s)

    def _sample_steps(self) -> None:
        while not self._stop.wait(1.0):
            self._read_steps()

    @staticmethod
    def _profiler():
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def _between_ticks(self, fn, timeout_s: float = 120.0) -> None:
        """Run fn on the engine thread before its next tick; wait for it."""
        self._action_done.clear()
        self._action = fn
        self.engine.notify()
        if not self._action_done.wait(timeout_s):
            raise RuntimeError("the engine thread ran no tick for the profiler")
        err, self._action_error = self._action_error, None
        if err is not None:
            raise err

    def begin_slice(self) -> None:
        def begin():
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof = self._profiler()
            self.prof.start()
            with torch.profiler.record_function(PREFIX + "slice_begin"):
                pass
            self.slice_wall = [time.time(), None]
            self.recording = True

        self._between_ticks(begin)

    def end_slice(self) -> None:
        """Close the slice and stop the profiler (the engine waits)."""
        def end():
            self.recording = False
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            with torch.profiler.record_function(PREFIX + "slice_end"):
                pass
            self.slice_wall[1] = time.time()
            self.prof.stop()

        self._between_ticks(end)

    def export(self) -> dict:
        """The profiled slice reduced (see summarize); the trace file goes
        to a temporary directory and is deleted."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="servebench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.prof = None
        summary = summarize(events)
        if summary is None:
            raise RuntimeError("the trace holds no slice markers")
        return summary

    def close(self) -> None:
        self._stop.set()
        if self._sampler is not None:
            self._sampler.join(timeout=5)
        self._read_steps()
        for attr, fn in self._saved_llama.items():
            setattr(self.llama, attr, fn)


def _intervals(events, names) -> Dict[str, Dict[int, tuple]]:
    """name -> tid -> (sorted starts, matching ends) of annotation ranges."""
    out: Dict[str, Dict[int, list]] = {n: {} for n in names}
    for e in events:
        n = e.get("name", "")
        if n.startswith(PREFIX) and n[len(PREFIX):] in out:
            out[n[len(PREFIX):]].setdefault(e.get("tid"), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
    res = {}
    for n, by_tid in out.items():
        res[n] = {}
        for tid, iv in by_tid.items():
            iv.sort()
            res[n][tid] = ([s for s, _ in iv], [e for _, e in iv])
    return res


def _inside(ranges: Dict[int, tuple], tid, ts) -> bool:
    if tid not in ranges:
        return False
    starts, ends = ranges[tid]
    i = bisect.bisect_right(starts, ts) - 1
    return i >= 0 and ts <= ends[i]


def summarize(events: List[dict]) -> Optional[dict]:
    """From a Chrome trace of the slice: its length, the device's busy
    time (the union of kernel, copy and set intervals), the device time by
    op name, the device time of the kernels launched inside each call
    range (a kernel belongs to the range that was open on the launching
    thread when its launch call ran), the count of each range, and the
    device's idle time by the host range open on the engine thread when
    the device fell idle. None when the slice's markers are missing."""
    marks = {e["name"][len(PREFIX):]: e["ts"] for e in events
             if e.get("cat") == "user_annotation"
             and e.get("name") in (PREFIX + "slice_begin", PREFIX + "slice_end")}
    if "slice_begin" not in marks or "slice_end" not in marks:
        return None
    t0, t1 = marks["slice_begin"], marks["slice_end"]
    gpu = sorted((e for e in events if e.get("cat") in GPU_CATS and "dur" in e
                  and t0 <= e["ts"] <= t1), key=lambda e: e["ts"])
    launch = {}
    runtime: Dict[str, float] = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch[c] = (e.get("tid"), e["ts"])
            if t0 <= e["ts"] <= t1:
                runtime[e["name"]] = runtime.get(e["name"], 0.0) + e.get("dur", 0) * 1e-6
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    ranges = _intervals(ann, CALL_RANGES + STEP_RANGES)
    by_op: Dict[str, float] = {}
    by_range = {n: 0.0 for n in CALL_RANGES}
    total = 0.0
    for e in gpu:
        d = e["dur"] * 1e-6
        total += d
        key = e.get("name", "?")[:96]
        by_op[key] = by_op.get(key, 0.0) + d
        src = launch.get((e.get("args") or {}).get("correlation"))
        if src is None:
            continue
        for n in CALL_RANGES:
            if _inside(ranges[n], *src):
                by_range[n] += d
    # Busy time: the union of the device intervals, and the gaps between.
    busy = 0.0
    gaps = []
    cursor = t0
    for e in gpu:
        s, f = e["ts"], min(t1, e["ts"] + e["dur"])
        if s > cursor:
            gaps.append((cursor, s))
        if f > cursor:
            busy += f - max(s, cursor)
            cursor = f
    if t1 > cursor:
        gaps.append((cursor, t1))
    engine_tids = {tid for n in STEP_RANGES for tid in ranges[n]}
    idle: Dict[str, float] = {}
    for s, f in gaps:
        label = "loop"
        for n in STEP_RANGES:
            if any(_inside(ranges[n], tid, s) for tid in engine_tids):
                label = n
                break
        idle[label] = idle.get(label, 0.0) + (f - s) * 1e-6
    counts = {n: sum(1 for st, _ in ranges[n].values() for x in st
                     if t0 <= x <= t1) for n in CALL_RANGES}
    return {"window_s": (t1 - t0) * 1e-6, "busy_s": busy * 1e-6,
            "device_s": total, "by_op": by_op, "by_range": by_range,
            "range_counts": counts, "idle_by_host": idle,
            "gpu_events": len(gpu), "host_runtime_s": runtime}
