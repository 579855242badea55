"""The port's admin TUI glue (ollamamq_tpu_torch/admin/tui.py) driving
the shared native dashboard (cpp/tui.cpp) through a real pty: the
counterpart of tests/test_tui_pty.py, with the same harness and the
same pinned HBM cache. The child imports only the port (no JAX).

- VIP star, block persisted to blocked_items.json, unblock, clean quit;
- a firing alert in the ALERTS panel, and "(none)" without one;
- the step-profiler chip, and the model row and shed chip fed by a CPU
  TorchEngine's stats (srpt, token fairness), whose callback payload
  also carries the scheduler chip.
"""

import sys
import time

import pytest

from test_tui_pty import _PtyTui, _blocked_items, _stderr

_CHILD = r"""
import sys
from ollamamq_tpu_torch.core.mqcore import MQCore
from ollamamq_tpu_torch.admin import tui as admin_tui

# Pinned like tests/test_tui_pty.py's child: the frames are about the key
# loop and persistence, not the device.
admin_tui._hbm_cache.update(
    ts=float("inf"), used=0, total=0, device="test-device",
    chips=[{"device": f"cuda:{i}", "id": i, "process": i // 4,
            "hbm_used": (i + 1) << 20, "hbm_total": 16 << 20}
           for i in range(8)],
)

core = MQCore(sys.argv[1])
core.enqueue("alice", "10.0.0.1")
core.enqueue("bob", "10.0.0.2")


class Eng:
    pass


eng = Eng()
eng.core = core
eng.runtimes = {}
admin_tui.run_tui(eng, None, refresh_ms=50)
print("TUI_EXIT_OK", flush=True)
"""

_RUN = 'eng.runtimes = {}\nadmin_tui.run_tui(eng, None, refresh_ms=50)'


def _child(extra: str) -> str:
    src = _CHILD.replace(_RUN, extra + "\nadmin_tui.run_tui(eng, None, refresh_ms=50)")
    assert src != _CHILD, "child patch failed to apply"
    return src


_CHILD_ALERTS = _child('''eng.runtimes = {}
from ollamamq_tpu_torch.telemetry.slo import AlertManager
eng.alerts = AlertManager()
eng.alerts.fire("slo_ttft_burn_fast", "page",
                "ttft SLO burning 20.0x budget over 300s", source="slo")''')

_CHILD_STEPPROF = _child('''eng.runtimes = {}
from ollamamq_tpu_torch.telemetry import stepprof
stepprof.PROFILER.reset()
tmr = stepprof.PROFILER.start("decode")
tmr.mark("dispatch")
tmr.phases["dispatch"] = 12.34     # pin the rendered p99 exactly
tmr._last = tmr._t0 + 0.01234
tmr.finish(T_pad=0, k_cap=2, n_prefill=0, n_decode=1, tokens=2,
           padded_tokens=4, compiled=False)''')

# A real (CPU) engine's stats behind the frames: its runtime rows, the
# scheduler chip (srpt), and shed counts from two refused enqueues.
_CHILD_ENGINE = _child('''import torch
from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.core.mqcore import Fairness
from ollamamq_tpu_torch.engine.engine import QueueFullError, TorchEngine
real = TorchEngine(EngineConfig(model="test-tiny", max_slots=2, num_pages=16,
                                page_size=8, max_pages_per_seq=4,
                                scheduler="srpt", max_queued_per_user=1),
                   device="cpu", dtype=torch.float32,
                   blocklist_path=sys.argv[1], fairness=Fairness.TOKENS)
real.enqueue_request("zed", "", "test-tiny", prompt_tokens=[1, 2, 3])
for _ in range(2):
    try:
        real.enqueue_request("zed", "", "test-tiny", prompt_tokens=[1, 2, 3])
    except QueueFullError:
        pass
eng = real''')


def _run_quit(t):
    t.clear()
    t.send("q")
    assert t.wait_output(b"TUI_EXIT_OK"), _stderr(t)
    assert t.proc.wait(timeout=30) == 0


@pytest.mark.skipif(sys.platform != "linux", reason="pty/termios test")
def test_tui_admin_verbs_via_pty(tmp_path):
    t = _PtyTui(tmp_path, child_src=_CHILD)
    try:
        assert t.wait_output(b"USERS"), _stderr(t)
        assert t.wait_output(b"alice") and t.wait_output(b"bob")
        assert t.wait_output(b"chip 0 (host 0)") and t.wait_output(b"chip 7 (host 1)")
        assert t.wait_output(b"cache n/a")
        t.send("\t")
        t.send("p")
        assert t.wait_output("★".encode()), "VIP star never rendered"
        t.send("x")
        items = _blocked_items(t.blockfile, want="alice")
        assert items is not None and "alice" in items, items
        assert t.wait_output("✖".encode())
        t.send("ll")
        t.send("u")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            items = _blocked_items(t.blockfile)
            if items == []:
                break
            time.sleep(0.1)
        assert items == [], items
        _run_quit(t)
    finally:
        t.close()


@pytest.mark.skipif(sys.platform != "linux", reason="pty/termios test")
def test_tui_alerts_panel_via_pty(tmp_path):
    t = _PtyTui(tmp_path, child_src=_CHILD_ALERTS)
    try:
        assert t.wait_output(b"ALERTS (1 firing)"), _stderr(t)
        assert t.wait_output(b"slo_ttft_burn_fast"), _stderr(t)
        assert t.wait_output(b"[page]")
        _run_quit(t)
    finally:
        t.close()


@pytest.mark.skipif(sys.platform != "linux", reason="pty/termios test")
def test_tui_no_alerts_renders_quiet_panel(tmp_path):
    t = _PtyTui(tmp_path, child_src=_CHILD)
    try:
        assert t.wait_output(b"ALERTS"), _stderr(t)
        assert t.wait_output(b"(none)"), _stderr(t)
        _run_quit(t)
    finally:
        t.close()


@pytest.mark.skipif(sys.platform != "linux", reason="pty/termios test")
def test_tui_stepprof_chip_via_pty(tmp_path):
    """No compile events in eager PyTorch: `compiles 0`, and the pinned
    step p99."""
    t = _PtyTui(tmp_path, child_src=_CHILD_STEPPROF)
    try:
        assert t.wait_output(b"compiles 0"), _stderr(t)
        assert t.wait_output(b"step p99 12.34ms"), _stderr(t)
        _run_quit(t)
    finally:
        t.close()


@pytest.mark.skipif(sys.platform != "linux", reason="pty/termios test")
def test_tui_engine_chips_via_pty(tmp_path):
    t = _PtyTui(tmp_path, child_src=_CHILD_ENGINE)
    try:
        assert t.wait_output(b"test-tiny  0/2 slots", budget=90), _stderr(t)
        assert t.wait_output(b"shed 2"), _stderr(t)
        assert t.wait_output(b"zed"), _stderr(t)
        _run_quit(t)
    finally:
        t.close()


def test_stats_brief_of_a_cpu_engine(tmp_path):
    """The callback's payload (the frames above cut the chips column at
    140 columns): runtime rows with the keys the dashboard reads, the
    scheduler chip, sheds, and the engine's device row."""
    import torch

    from ollamamq_tpu_torch.admin import tui as admin_tui
    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.engine.engine import QueueFullError, TorchEngine

    eng = TorchEngine(EngineConfig(model="test-tiny", max_slots=2, num_pages=16,
                                   page_size=8, max_pages_per_seq=4, scheduler="srpt",
                                   max_queued_per_user=1),
                      device="cpu", dtype=torch.float32,
                      blocklist_path=str(tmp_path / "blocked.json"))
    eng.enqueue_request("zed", "", "test-tiny", prompt_tokens=[1, 2, 3])
    with pytest.raises(QueueFullError):
        eng.enqueue_request("zed", "", "test-tiny", prompt_tokens=[1, 2, 3])
    admin_tui._hbm_cache["ts"] = 0.0  # read the engine's chip rows now
    brief = admin_tui._engine_stats_brief(eng)
    assert brief["sched"] == {"policy": "srpt", "pred_accuracy": None,
                              "pred_observed": 0, "decisions": 0}
    assert brief["shed"] == 1 and brief["preempt"] == 0 and brief["alerts"] == []
    assert brief["device"] == "cpu" and brief["chips"][0]["memory_stats"] is False
    row = brief["models"][0]
    assert {"model", "active_slots", "max_slots", "pending_prefill", "pages_used",
            "pages_total", "step_latency_ms", "step_p50_ms", "prefill_latency_ms",
            "ttft_p50_ms", "tokens_generated", "mfu", "param_bytes", "kv_bytes",
            "prefix_cache"} <= set(row)
    assert brief["hbm_used"] == row["param_bytes"] + row["kv_bytes"]
