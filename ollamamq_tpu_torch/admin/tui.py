"""Admin TUI front: runs the shared native dashboard (cpp/tui.cpp,
`mqtui_run` in cpp/libmqcore.so) on the calling thread, feeding it the
engine's stats through a callback.

The HTTP server runs on background threads, the TUI owns the terminal,
and quitting the TUI ends the whole process. All admin actions
(VIP/boost/block/unblock) mutate the shared native core directly — the
scheduler sees them on its next pop. The card's name and memory come
from the engine's chip rows (torch.cuda.mem_get_info on a CUDA device).
The JAX package's fleet, HA, tier and journal chips have no source in
this package and are not sent.
"""

from __future__ import annotations

import ctypes
import json
import logging
import time

from ollamamq_tpu_torch.core.mqcore import _get_lib
from ollamamq_tpu_torch.telemetry import stepprof

log = logging.getLogger("ollamamq.tui")

# POINTER(c_char), NOT c_char_p: c_char_p would hand the callback an
# immutable bytes copy and memmove would scribble on interpreter memory.
_STATS_CB = ctypes.CFUNCTYPE(
    ctypes.c_longlong, ctypes.POINTER(ctypes.c_char), ctypes.c_longlong
)


_hbm_cache = {"ts": 0.0, "used": 0, "total": 0, "device": "", "chips": []}


def _engine_stats_brief(engine) -> dict:
    """Compact stats JSON for the chips panel.

    Called at the 10 Hz TUI cadence, so it must stay cheap: per-runtime
    stats only (no core.snapshot — the native TUI reads the queue state
    itself), with device/HBM numbers cached for 2 s.
    """
    models = [rt.stats() for rt in list(engine.runtimes.values())]
    now = time.monotonic()
    if now - _hbm_cache["ts"] > 2.0:
        used = sum(m["param_bytes"] + m["kv_bytes"] for m in models)
        total = 0
        device = ""
        chips = []
        try:
            chips = engine.chip_stats()
            if chips:
                device = chips[0]["device"]
                used = sum(c["hbm_used"] for c in chips) or used
                total = sum(c["hbm_total"] for c in chips)
        except Exception:
            pass
        _hbm_cache.update(ts=now, used=used, total=total, device=device,
                          chips=chips)
    # Firing alerts (SLO burn, watchdog stalls, device loss) for the
    # ALERTS panel — read from the engine's shared alert table at the
    # frame cadence (an in-memory list copy; cheap).
    alerts = []
    am = getattr(engine, "alerts", None)
    if am is not None:
        try:
            alerts = [{"name": a.name, "severity": a.severity,
                       "message": a.message,
                       "age_s": round(max(0.0, time.time() - a.since), 0)}
                      for a in am.active()]
        except Exception:
            alerts = []
    # Degradation chip: total sheds (admission caps / deadlines / kv
    # exhaustion, engine-side mirror of ollamamq_shed_total) and total
    # KV-pressure preemptions across runtimes.
    shed = sum(getattr(engine, "shed_counts", {}).values())
    preempt = sum(m.get("preemptions", 0) or 0 for m in models)
    # Scheduler chip: active policy + output-length predictor accuracy
    # ("acc n/a" in the TUI until the predictor warms up). Engines and
    # the fleet router both expose scheduler_stats().
    sched = None
    ss = getattr(engine, "scheduler_stats", None)
    if ss is not None:
        try:
            sched = ss()
        except Exception:
            sched = None
    out = {
        "models": models,
        "device": _hbm_cache["device"] or "no-device",
        "chips": _hbm_cache["chips"],
        "hbm_used": _hbm_cache["used"],
        "hbm_total": _hbm_cache["total"],
        "shed": shed,
        "preempt": preempt,
        "alerts": alerts,
    }
    if sched is not None:
        out["sched"] = sched
    # Step-profiler chip (`step p99 X ms`): absent until the first
    # dispatch, so the chips column stays quiet on an idle engine.
    sp = stepprof.PROFILER.brief()
    if sp is not None:
        out["stepprof"] = sp
    return out


def run_tui(engine, registry, refresh_ms: int = 100) -> None:
    """Blocks until the operator quits (q/Esc). Returns then — the caller
    shuts the server down (TUI exit == process exit, like the reference)."""
    import signal

    lib = _get_lib()
    lib.mqtui_run.restype = ctypes.c_int
    lib.mqtui_run.argtypes = [ctypes.c_void_p, _STATS_CB, ctypes.c_int]

    # Ctrl-C must not raise inside the ctypes callback (an interrupt at
    # callback entry is uncatchable there and corrupts the return value);
    # instead a flag-setting handler turns it into a clean quit request.
    interrupted = {"flag": False}

    def _on_sigint(signum, frame):
        interrupted["flag"] = True

    prev_handler = signal.signal(signal.SIGINT, _on_sigint)

    def cb(buf, cap):
        if interrupted["flag"]:
            return -9  # tell the C loop to exit cleanly
        try:
            data = json.dumps(_engine_stats_brief(engine)).encode()
        except BaseException:
            return 0
        if len(data) >= cap:
            return 0
        ctypes.memmove(buf, data, len(data))
        return len(data)

    cb_ref = _STATS_CB(cb)  # keep alive for the whole run
    try:
        rc = lib.mqtui_run(engine.core._h, cb_ref, refresh_ms)
    finally:
        signal.signal(signal.SIGINT, prev_handler)
    if rc != 0:
        log.warning("TUI unavailable (not a TTY); running headless")
        try:
            while True:
                time.sleep(1)
        except KeyboardInterrupt:
            pass
