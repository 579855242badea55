"""The port's HealthMonitor (ollamamq_tpu_torch/engine/health.py): the
counterpart of tests/test_health.py — stall detection and recovery, the
device probe and the status payload — plus the probe on a CPU
TorchEngine's own device and the alert a failed probe raises."""

import time

import pytest
import torch

from ollamamq_tpu_torch.config import EngineConfig
from ollamamq_tpu_torch.engine import health as health_mod
from ollamamq_tpu_torch.engine.engine import TorchEngine
from ollamamq_tpu_torch.engine.health import HealthMonitor, device_memory

STATUS_KEYS = {"status", "device_online", "engine_stalled", "last_device_check",
               "alerts"}


class _FakeCore:
    def __init__(self):
        self.queued = 1

    def total_queued(self):
        return self.queued


class _FakeRt:
    def __init__(self):
        self.tokens_generated = 0

    def has_work(self):
        return True


class _FakeEngine:
    def __init__(self):
        self.core = _FakeCore()
        self.runtimes = {"m": _FakeRt()}


def _wait(pred, budget=10.0):
    deadline = time.monotonic() + budget
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.02)
    return pred()


def test_stall_detected_then_recovers(monkeypatch):
    monkeypatch.setattr(health_mod, "STALL_DEADLINE_S", 0.2)
    eng = _FakeEngine()
    hm = HealthMonitor(eng, period_s=0.05)
    hm.start()
    try:
        assert _wait(lambda: hm.engine_stalled), "stall not flagged"
        eng.runtimes["m"].tokens_generated = 5  # progress resumes
        assert _wait(lambda: not hm.engine_stalled)
        eng.core.queued = 0

        class _IdleRt(_FakeRt):
            def has_work(self):
                return False

        eng.runtimes["m"] = _IdleRt()  # idle is never a stall
        time.sleep(0.5)
        assert not hm.engine_stalled
    finally:
        hm.stop()


def test_device_probe_online_and_status():
    eng = _FakeEngine()
    hm = HealthMonitor(eng, period_s=0.05)
    hm.start()
    try:
        assert _wait(lambda: hm.last_device_check > 0.0, 20)
        assert hm.device_online and hm.probe_device.type == "cpu"
        st = hm.status()
        assert set(st) == STATUS_KEYS
        assert st["status"] == "ok" and st["alerts"] == []
    finally:
        hm.stop()


@pytest.fixture()
def cpu_engine():
    eng = TorchEngine(EngineConfig(model="test-tiny", max_slots=2, num_pages=16,
                                   page_size=8, max_pages_per_seq=4),
                      device="cpu", dtype=torch.float32)
    yield eng
    eng.stop()


def test_engine_probe_runs_on_its_device(cpu_engine):
    """The engine starts its watchdog; a pass probes the engine's own
    device (the CPU here, as asked) and the engine's stats carry it."""
    cpu_engine.start()
    hm = cpu_engine.health
    assert hm is not None and hm.probe_device == cpu_engine.device
    hm.check_once()
    assert hm.probes == 1 and hm.device_online
    st = cpu_engine.stats()["health"]
    assert set(st) == STATUS_KEYS and st["status"] == "ok"
    assert device_memory(cpu_engine.device) is None  # the CPU reports no HBM
    cpu_engine.stop()
    assert cpu_engine.health is None


def test_failed_probe_raises_device_alert(cpu_engine, monkeypatch):
    hm = HealthMonitor(cpu_engine)

    def broken(*a, **k):
        raise RuntimeError("card lost")

    monkeypatch.setattr(health_mod.torch, "ones", broken)
    hm.check_once()
    assert not hm.device_online
    names = [a.name for a in cpu_engine.alerts.active()]
    assert "device_offline" in names
    assert hm.status()["status"] == "degraded"
    monkeypatch.undo()
    hm.check_once()
    assert hm.device_online
    assert "device_offline" not in [a.name for a in cpu_engine.alerts.active()]
