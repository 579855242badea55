"""SLO objectives, multi-window burn-rate alerting, and the alert table.

The operator declares latency objectives at startup (--slo-ttft-ms,
--slo-tpot-ms, --slo-target): "target fraction of requests get their
first token within N ms" and "target fraction of decode steps emit a
token within M ms". The engine hot path records each observation as
good/bad; this module turns those streams into *error-budget burn
rates* over sliding windows and fires alerts the multi-window way
(Google SRE workbook ch.5): an alert needs BOTH a long window over
threshold (sustained, not a blip) and a short window over threshold
(still happening, so resolved incidents clear fast).

    burn_rate(window) = (bad / total over window) / (1 - target)

burn 1.0 = exactly spending budget; 14.4 over 5m/1h = the classic
page-level burn. Defaults here are scaled to a serving engine's
time-horizon (requests arrive in ms, incidents minutes): a fast pair
(5m over 60s gate) at 14.4x pages, a slow pair (1h over 5m gate) at 6x
warns.

AlertManager is the one funnel for everything that can demand operator
attention — SLO burn, the stall watchdog (engine/health.py), device
loss — so /health, /metrics, /debug/bundle, and the TUI alerts panel
all read the same table.

Stdlib-only, thread-safe: the engine thread records, the health thread
evaluates, HTTP threads read.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from ollamamq_tpu_torch.telemetry import schema as tm

log = logging.getLogger("ollamamq.slo")

# (label, long_window_s, short_window_s, burn_factor, severity): fire
# when burn > factor over BOTH windows; resolve when either drops under.
DEFAULT_WINDOWS: Tuple[tuple, ...] = (
    ("fast", 300.0, 60.0, 14.4, "page"),
    ("slow", 3600.0, 300.0, 6.0, "warn"),
)

_SEVERITY_RANK = {"page": 0, "critical": 0, "error": 1, "warn": 2, "info": 3}


@dataclasses.dataclass
class Alert:
    name: str
    severity: str
    message: str
    since: float  # time.time(): operator-facing wall clock
    source: str = "slo"

    def to_dict(self) -> dict:
        return {"name": self.name, "severity": self.severity,
                "message": self.message, "since": self.since,
                "age_s": round(max(0.0, time.time() - self.since), 1),
                "source": self.source}


class AlertManager:
    """Active-alert table + bounded history of resolved alerts."""

    def __init__(self, history: int = 64):
        self._lock = threading.Lock()
        self._active: Dict[str, Alert] = {}
        self._history: collections.deque = collections.deque(maxlen=history)

    def fire(self, name: str, severity: str, message: str,
             source: str = "slo") -> bool:
        """Raise (or refresh the message of) an alert. Returns True only
        on the inactive->active transition, so callers can count/log
        firings without flapping on every evaluation tick."""
        with self._lock:
            cur = self._active.get(name)
            if cur is not None:
                cur.message = message
                cur.severity = severity
                return False
            self._active[name] = Alert(name, severity, message,
                                       since=time.time(), source=source)
        log.error("ALERT firing [%s/%s]: %s", severity, name, message)
        return True

    def resolve(self, name: str) -> bool:
        with self._lock:
            alert = self._active.pop(name, None)
            if alert is None:
                return False
            self._history.append(
                {**alert.to_dict(), "resolved_at": time.time()})
        log.warning("alert resolved [%s]", name)
        return True

    def active(self) -> List[Alert]:
        with self._lock:
            alerts = list(self._active.values())
        alerts.sort(key=lambda a: (_SEVERITY_RANK.get(a.severity, 9),
                                   a.since))
        return alerts

    def history(self) -> List[dict]:
        with self._lock:
            return list(self._history)

    def degraded(self) -> bool:
        with self._lock:
            return bool(self._active)

    def to_dict(self) -> dict:
        return {"active": [a.to_dict() for a in self.active()],
                "recently_resolved": self.history()}


class WindowedCounts:
    """Good/bad observation counts in one-second buckets over a bounded
    horizon; totals(window) sums the trailing window. O(1) record, O(60)
    worst-case trim per record, O(window) read — reads happen at the
    health-check cadence, not per token."""

    def __init__(self, horizon_s: float = 3600.0):
        self.horizon_s = float(horizon_s)
        self._lock = threading.Lock()
        self._buckets: collections.deque = collections.deque()  # [sec, good, bad]

    def record(self, good: int = 0, bad: int = 0,
               now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        sec = int(now)
        with self._lock:
            if self._buckets and self._buckets[-1][0] == sec:
                self._buckets[-1][1] += good
                self._buckets[-1][2] += bad
            else:
                self._buckets.append([sec, good, bad])
                horizon = sec - self.horizon_s
                while self._buckets and self._buckets[0][0] < horizon:
                    self._buckets.popleft()

    def totals(self, window_s: float,
               now: Optional[float] = None) -> Tuple[int, int]:
        now = time.monotonic() if now is None else now
        cutoff = now - window_s
        good = bad = 0
        with self._lock:
            for sec, g, b in reversed(self._buckets):
                if sec < cutoff:
                    break
                good += g
                bad += b
        return good, bad


class Objective:
    """One latency objective: observations over threshold_ms burn budget."""

    def __init__(self, name: str, threshold_ms: float, target: float,
                 horizon_s: float = 3600.0):
        if not (0.0 < target < 1.0):
            raise ValueError(f"slo target must be in (0, 1), got {target}")
        self.name = name
        self.threshold_ms = float(threshold_ms)
        self.target = float(target)
        self.counts = WindowedCounts(horizon_s)
        self._tm_violations = tm.SLO_VIOLATIONS_TOTAL.labels(objective=name)

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def record(self, latency_ms: float, n: int = 1,
               now: Optional[float] = None) -> None:
        if latency_ms > self.threshold_ms:
            self.counts.record(bad=n, now=now)
            self._tm_violations.inc(n)
        else:
            self.counts.record(good=n, now=now)

    def burn_rate(self, window_s: float, now: Optional[float] = None) -> float:
        good, bad = self.counts.totals(window_s, now=now)
        total = good + bad
        if total == 0:
            return 0.0
        return (bad / total) / self.budget


class SLOEngine:
    """Owns the configured objectives; evaluate() runs on the health
    thread, updating the ollamamq_slo_* gauges and raising/resolving
    burn-rate alerts through the shared AlertManager."""

    def __init__(self, alerts: AlertManager,
                 ttft_ms: Optional[float] = None,
                 tpot_ms: Optional[float] = None,
                 target: float = 0.99,
                 windows: Tuple[tuple, ...] = DEFAULT_WINDOWS):
        self.alerts = alerts
        self.windows = windows
        self.objectives: Dict[str, Objective] = {}
        horizon = max((w[1] for w in windows), default=3600.0)
        if ttft_ms:
            self.objectives["ttft"] = Objective("ttft", ttft_ms, target,
                                                horizon_s=horizon)
        if tpot_ms:
            self.objectives["tpot"] = Objective("tpot", tpot_ms, target,
                                                horizon_s=horizon)

    @property
    def enabled(self) -> bool:
        return bool(self.objectives)

    # -- hot path ----------------------------------------------------------
    def record(self, objective: str, latency_ms: float, n: int = 1) -> None:
        obj = self.objectives.get(objective)
        if obj is not None:
            obj.record(latency_ms, n=n)

    # -- health-thread cadence ---------------------------------------------
    def evaluate(self, now: Optional[float] = None) -> dict:
        """Recompute burn rates, publish gauges, fire/resolve alerts.
        Returns the summary dict /health and /debug/bundle embed."""
        now = time.monotonic() if now is None else now
        summary: dict = {"enabled": self.enabled, "objectives": {}}
        for name, obj in self.objectives.items():
            rec = {"threshold_ms": obj.threshold_ms, "target": obj.target,
                   "windows": {}}
            for label, long_w, short_w, factor, severity in self.windows:
                burn_long = obj.burn_rate(long_w, now=now)
                burn_short = obj.burn_rate(short_w, now=now)
                tm.SLO_BURN_RATE.labels(objective=name, window=label).set(
                    burn_long)
                firing = burn_long > factor and burn_short > factor
                alert_name = f"slo_{name}_burn_{label}"
                if firing:
                    self.alerts.fire(
                        alert_name, severity,
                        f"{name} SLO burning {burn_long:.1f}x budget "
                        f"over {int(long_w)}s (threshold "
                        f"{obj.threshold_ms:g}ms, target {obj.target:g})")
                else:
                    self.alerts.resolve(alert_name)
                rec["windows"][label] = {
                    "burn_rate": round(burn_long, 3),
                    "burn_rate_short": round(burn_short, 3),
                    "factor": factor, "firing": firing,
                }
            summary["objectives"][name] = rec
        return summary

    def summary(self) -> dict:
        """Read-only snapshot (no alert transitions) for endpoints that
        must not race the health thread's evaluate cadence."""
        now = time.monotonic()
        out: dict = {"enabled": self.enabled, "objectives": {}}
        for name, obj in self.objectives.items():
            out["objectives"][name] = {
                "threshold_ms": obj.threshold_ms, "target": obj.target,
                "burn_rates": {
                    label: round(obj.burn_rate(long_w, now=now), 3)
                    for label, long_w, _s, _f, _sev in self.windows
                },
            }
        return out
