"""Health monitor + stall watchdog: device liveness, engine progress,
stuck requests — all raised as alerts.

The JAX package's watchdog on the engine's torch device:

  - device liveness: a small matmul on the engine's device, then
    torch.cuda.synchronize(device), must complete within a deadline on a
    side thread (a wedged card or CUDA runtime hangs rather than erroring). On
    a CPU engine the probe runs on the CPU, because that IS the engine's
    device; it never switches devices to report "online";
  - engine-step progress: work exists but no token has been produced —
    or the engine loop's liveness tick has gone stale (a dispatch wedged
    INSIDE a step blocks the loop thread without erroring);
  - requests stuck in a phase: an in-flight trace whose last lifecycle
    event is older than the deadline (the phase it is stuck in reads
    straight off the attribution layer);
  - preemption storms (KV pressure). The JAX package's compile-storm
    rule has no counterpart: eager PyTorch compiles nothing per shape;
  - scheduler invariants: the decision journal's ring swept by
    check_invariants (pages conserved, no slot held twice, the VIP
    never a victim, sheds only over their bounds, no starvation);
  - on a fleet router: replicas heartbeat-stale or ejected
    (replica_stale), a placement-overhead p99 over its budget
    (router_overhead), tier regroups or autoscaler events flapping
    (regroup_storm, scale_storm);
  - router HA: a standby trailing the primary or gone silent
    (standby_lag), a promotion in flight too long (takeover_stuck).

HBM headroom (`device_memory`) reads torch.cuda.mem_get_info and the
caching allocator's counters; the engine's HBM timeline and chip rows
and the admin TUI read it.

Every detection raises a named alert through the engine's AlertManager
(telemetry/slo.py) — the same table the SLO burn-rate evaluator feeds —
so /health, /metrics (`ollamamq_slo_alerts_firing`) and the TUI alerts
panel show one picture. On a tensor-parallel engine (engine/spmd.py)
worker ranks whose heartbeat went stale raise worker_stale, the JAX
package's worker-host rule.
"""

from __future__ import annotations

import logging
import threading
import time

from typing import Optional

import torch

from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.telemetry.attribution import phase_of
from ollamamq_tpu_torch.telemetry.journal import check_invariants

log = logging.getLogger("ollamamq.health")

CHECK_PERIOD_S = 10.0  # reference cadence (dispatcher.rs:385)
DEVICE_DEADLINE_S = 30.0
STALL_DEADLINE_S = 30.0
# A request whose trace has not moved to a new lifecycle event in this
# long is stuck-in-phase. Generous: a long chunked prefill emits an event
# per chunk and a decode stream an event every 16 tokens, so any healthy
# request beats this by orders of magnitude.
REQUEST_STALL_S = 120.0
# Preemption-storm rule: occasional KV-pressure preemptions are the
# system degrading gracefully; this many per minute means the page pool
# is undersized for the live workload and recompute is eating throughput
# (alert "preempt_storm", resolves when the rate drops).
PREEMPT_STORM_PER_MIN = 30.0
PREEMPT_STORM_WINDOW_S = 60.0
# Regroup-storm rule (tiered fleets): each tier regroup costs a drain +
# stream migrations + an engine restart — a healthy balancer regroups
# occasionally as the class mix shifts; this many per minute means the
# hysteresis is mis-tuned (or the mix is adversarial) and the fleet is
# burning capacity on churn (alert "regroup_storm", resolves when the
# rate drops).
REGROUP_STORM_PER_MIN = 4.0
# Scale-storm rule (elastic fleets): the autoscaler's hysteresis exists
# so an oscillating load produces ZERO scale events — sustained churn
# above this rate means the cooldown/sustain windows are mis-tuned for
# the workload and the fleet is paying spawn + drain + migration costs
# in a loop (alert "scale_storm", resolves when the rate drops). Unlike
# the preempt/regroup storms this one counts into
# ollamamq_watchdog_stalls_total{kind="scale"}: a flapping scaler is a
# watchdog-grade malfunction, not graceful degradation.
SCALE_STORM_PER_MIN = 6.0
# Router-HA rules (--ha primaries): a standby whose replication cursor
# trails the primary by more than this many records — or that stopped
# polling entirely — would lose that much admitted/progress state at
# takeover (alert "standby_lag", kind "standby"). And a promotion that
# has been in flight longer than this is wedged, not slow: recovery
# re-admission is hung while the fleet has no serving router (alert
# "takeover_stuck", kind "takeover").
STANDBY_LAG_ALERT_RECORDS = 2048
TAKEOVER_STUCK_S = 30.0


def device_memory(device) -> Optional[dict]:
    """HBM readings of a CUDA device: free and total bytes from
    torch.cuda.mem_get_info, the caching allocator's allocated and
    reserved bytes. None for a CPU device (no memory statistics)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    return {"allocated_bytes": int(torch.cuda.memory_allocated(device)),
            "reserved_bytes": int(torch.cuda.memory_reserved(device)),
            "free_bytes": int(free), "total_bytes": int(total)}


class HealthMonitor:
    def __init__(self, engine, period_s: float = CHECK_PERIOD_S,
                 stall_s: float | None = None,
                 request_stall_s: float | None = None):
        self.engine = engine
        self.period_s = period_s
        # None = read the module globals at check time (tests monkeypatch
        # those); an explicit value pins this instance.
        self._stall_s = stall_s
        self._request_stall_s = request_stall_s
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.device_online = True
        self.engine_stalled = False
        self.last_device_check = 0.0
        self._last_progress = (0, time.monotonic())  # (tokens, ts)
        # (ts, cumulative preemptions) samples for the storm-rate window.
        self._preempt_samples: list = []
        # The device the probe runs on: the engine's own (CUDA unless the
        # engine was built for the CPU).
        self.probe_device = torch.device(getattr(engine, "device", "cpu"))
        self.probes = 0  # completed probe passes

    @property
    def stall_s(self) -> float:
        return self._stall_s if self._stall_s is not None else STALL_DEADLINE_S

    @property
    def request_stall_s(self) -> float:
        return (self._request_stall_s if self._request_stall_s is not None
                else REQUEST_STALL_S)

    def start(self) -> None:
        if self._thread:
            return
        self._thread = threading.Thread(target=self._loop, name="health", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    # ------------------------------------------------------------------
    def _alert(self, name: str, firing: bool, severity: str, message: str,
               kind: str) -> None:
        """Raise/clear one watchdog alert; the firing transition counts
        into ollamamq_watchdog_stalls_total{kind}. No-op on engines
        without an alert table (unit-test stubs)."""
        alerts = getattr(self.engine, "alerts", None)
        if alerts is None:
            return
        if firing:
            if alerts.fire(name, severity, message, source="watchdog"):
                tm.WATCHDOG_STALLS_TOTAL.labels(kind=kind).inc()
        else:
            alerts.resolve(name)

    def _probe_device(self) -> bool:
        """Run a trivial computation with a deadline on a side thread — a
        hung runtime must not take the monitor down with it. While a probe
        thread is still blocked (runtime wedged), no new probe is spawned;
        the device stays marked offline."""
        prev = getattr(self, "_probe_thread", None)
        if prev is not None and prev.is_alive():
            self.last_device_check = time.time()
            return False
        result = {}

        device = self.probe_device

        def go():
            try:
                x = torch.ones((8, 8), device=device)
                y = x @ x
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                result["ok"] = bool(float(y[0, 0]) == 8.0)
            except Exception as e:  # noqa: BLE001
                result["err"] = str(e)

        t = threading.Thread(target=go, daemon=True)
        self._probe_thread = t
        t.start()
        t.join(timeout=DEVICE_DEADLINE_S)
        self.last_device_check = time.time()
        self.probes += 1
        return result.get("ok", False)

    def _check_progress(self) -> bool:
        """True if the engine is making progress (or rightly idle)."""
        # Snapshot: /api/pull and /api/delete mutate runtimes concurrently.
        runtimes = list(self.engine.runtimes.values())
        tokens = sum(getattr(rt, "tokens_generated", 0) for rt in runtimes)
        has_work = any(rt.has_work() for rt in runtimes) or bool(
            self.engine.core.total_queued()
        )
        last_tokens, last_ts = self._last_progress
        now = time.monotonic()
        if tokens != last_tokens or not has_work:
            self._last_progress = (tokens, now)
            return True
        if (now - last_ts) < self.stall_s:
            return True
        # No token for stall_s with work pending. Distinguish "loop alive
        # but starved" from "loop thread wedged inside a dispatch": the
        # liveness tick at the top of _loop_once goes stale in the latter.
        tick = getattr(self.engine, "last_tick_at", None)
        if tick is not None and (now - tick) > self.stall_s:
            return False  # loop thread itself is stuck
        return False

    def _check_stuck_requests(self) -> list:
        """In-flight traces whose last lifecycle event is older than the
        request-stall deadline: (req_id, phase, age_s) rows, worst first."""
        tracer = getattr(self.engine, "tracer", None)
        if tracer is None:
            return []
        now = time.monotonic()
        out = []
        for tr in tracer.traces():
            if tr.finished:
                continue
            evs = tr.events  # engine thread appends; index reads are safe
            if not evs:
                continue
            name, t = evs[-1][0], evs[-1][1]
            age = now - t
            if age > self.request_stall_s:
                out.append((tr.req_id, phase_of(name), age))
        out.sort(key=lambda r: -r[2])
        return out

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.check_once()
            except Exception:
                # The watchdog must outlive anything it watches.
                log.exception("health check iteration failed")

    def check_once(self) -> None:
        """One full watchdog pass (the loop cadence; callable directly in
        tests)."""
        ok = self._probe_device()
        if ok != self.device_online:
            if ok:
                log.info("device %s is back ONLINE", self.probe_device)
            else:
                log.error("device %s probe FAILED (CUDA runtime hung or card lost)",
                          self.probe_device)
            self.device_online = ok
        self._alert("device_offline", not ok, "page",
                    "device probe failed: CUDA runtime hung or card lost", "device")

        progressing = self._check_progress()
        if not progressing and not self.engine_stalled:
            log.error(
                "engine STALLED: %d queued, work pending, no tokens for %ds",
                self.engine.core.total_queued(), int(self.stall_s),
            )
        self.engine_stalled = not progressing
        self._alert(
            "engine_stall", self.engine_stalled, "page",
            f"work pending but no token produced for {self.stall_s:g}s "
            "(wedged engine step?)", "engine_step")

        stuck = self._check_stuck_requests()
        for r, p, a in stuck:
            # req_id rides as a structured field so the JSON log line
            # correlates with /debug/requests/{id}.
            log.error("request %d stuck in phase '%s' for %.0fs",
                      r, p, a, extra={"req_id": r})
        self._alert(
            "request_stall", bool(stuck), "warn",
            (f"{len(stuck)} request(s) stuck; worst: req {stuck[0][0]} in "
             f"'{stuck[0][1]}' for {stuck[0][2]:.0f}s") if stuck else "",
            "request_phase")

        # Tensor-parallel engines only (engine/spmd.py): worker ranks
        # whose heartbeat stopped advancing.
        hosts_fn = getattr(self.engine, "stale_worker_hosts", None)
        stale = (hosts_fn() or []) if hosts_fn is not None else []
        self._alert(
            "worker_stale", bool(stale), "page",
            f"SPMD worker host(s) {stale} stopped publishing registry "
            "snapshots/heartbeats", "worker_host")

        # Fleet routers only (fleet/router.py stale_replicas): replicas
        # whose heartbeat went stale or that the router ejected.
        reps_fn = getattr(self.engine, "stale_replicas", None)
        stale_reps = (reps_fn() or []) if reps_fn is not None else []
        self._alert(
            "replica_stale", bool(stale_reps), "page",
            f"fleet replica(s) {stale_reps} heartbeat-stale or ejected "
            "from rotation (in-flight streams fail over; capacity is "
            "reduced until they heal)", "replica")

        self._check_preempt_storm()
        self._check_regroup_storm()
        self._check_scale_storm()
        self._check_router_overhead()
        self._check_ha()
        self._check_journal_invariants()

        slo = getattr(self.engine, "slo", None)
        if slo is not None:
            slo.evaluate()

    def preempt_rate_per_min(self) -> float:
        """Preemptions per minute over the storm window, from cumulative
        engine counts sampled at the check cadence."""
        count_fn = getattr(self.engine, "preemption_count", None)
        if count_fn is None:
            return 0.0
        now = time.monotonic()
        self._preempt_samples.append((now, int(count_fn())))
        cutoff = now - PREEMPT_STORM_WINDOW_S
        self._preempt_samples = [
            (t, c) for t, c in self._preempt_samples if t >= cutoff
        ][-64:]
        if len(self._preempt_samples) < 2:
            return 0.0
        t0, c0 = self._preempt_samples[0]
        t1, c1 = self._preempt_samples[-1]
        span = t1 - t0
        if span <= 0:
            return 0.0
        # Rebuilds reset per-runtime counters; a negative delta is a
        # reset, not negative preemptions.
        return max(0, c1 - c0) * 60.0 / span

    def _check_preempt_storm(self) -> None:
        """AlertManager rule for preemption storms: sustained KV-pressure
        preemptions above PREEMPT_STORM_PER_MIN mean the pool is
        undersized and recompute is eating throughput. Not routed through
        _alert: a storm is degradation pressure, not a watchdog stall, so
        it must not count into ollamamq_watchdog_stalls_total."""
        alerts = getattr(self.engine, "alerts", None)
        if alerts is None:
            return
        rate = self.preempt_rate_per_min()
        if rate > PREEMPT_STORM_PER_MIN:
            alerts.fire(
                "preempt_storm", "warn",
                f"preemption storm: {rate:.0f} preemptions/min under KV "
                "pressure (pool undersized for the live workload; "
                "recompute is eating throughput)", source="watchdog")
        else:
            alerts.resolve("preempt_storm")

    def _check_regroup_storm(self) -> None:
        """AlertManager rule for tier-regroup storms (tiered fleets
        only: the engine exposes a TierManager at `.tiers`). Like the
        preemption storm, this is degradation pressure rather than a
        watchdog stall, so it bypasses _alert and its stall counter."""
        alerts = getattr(self.engine, "alerts", None)
        tiers = getattr(self.engine, "tiers", None)
        if alerts is None or tiers is None:
            return
        try:
            rate = tiers.regroup_rate_per_min()
        except Exception:  # noqa: BLE001
            log.exception("regroup-rate read failed")
            return
        if rate > REGROUP_STORM_PER_MIN:
            alerts.fire(
                "regroup_storm", "warn",
                f"tier regroup storm: {rate:.0f} regroups/min — the "
                "balancer is flapping members between tiers (hysteresis "
                "mis-tuned for this class mix); each regroup costs a "
                "drain + migrations + a restart", source="watchdog")
        else:
            alerts.resolve("regroup_storm")

    def _check_scale_storm(self) -> None:
        """Watchdog rule for autoscaler flap (elastic fleets only: the
        engine exposes an AutoscalerManager at `.autoscaler`). Routed
        through _alert — each fire transition counts into
        ollamamq_watchdog_stalls_total{kind="scale"} — because a scaler
        churning members is a control-loop malfunction the operator
        must tune out, not load the fleet absorbs gracefully."""
        scaler = getattr(self.engine, "autoscaler", None)
        if scaler is None:
            return
        try:
            rate = scaler.scale_rate_per_min()
        except Exception:  # noqa: BLE001
            log.exception("scale-rate read failed")
            return
        self._alert(
            "scale_storm", rate > SCALE_STORM_PER_MIN, "warn",
            f"scale storm: {rate:.0f} scale events/min — the autoscaler "
            "is flapping fleet size (cooldown/sustain mis-tuned for "
            "this load); each flap costs a spawn or a drain + "
            "migrations", "scale")

    def _check_router_overhead(self) -> None:
        """Overhead-storm rule (fleet routers only: the engine exposes
        router_overhead_p99_ms). A windowed placement p99 above
        --router-overhead-budget-ms means the router's hot path itself
        eats the latency budget. Degradation pressure like the preempt
        storm: it bypasses _alert and its stall counter, and resolves as
        the window ages the spike out."""
        alerts = getattr(self.engine, "alerts", None)
        p99_fn = getattr(self.engine, "router_overhead_p99_ms", None)
        if alerts is None or p99_fn is None:
            return
        budget = getattr(getattr(self.engine, "ecfg", None),
                         "router_overhead_budget_ms", None)
        if not budget:
            return
        try:
            p99 = p99_fn()
        except Exception:  # noqa: BLE001
            log.exception("router overhead read failed")
            return
        if p99 is not None and p99 > budget:
            alerts.fire(
                "router_overhead", "warn",
                f"router overhead storm: placement p99 {p99:.2f}ms over "
                f"the {budget:g}ms budget — the router hot path itself "
                "is eating the latency budget", source="watchdog")
        else:
            alerts.resolve("router_overhead")

    def _check_ha(self) -> None:
        """Router-HA watchdog rules (engines exposing ha_status; None =
        HA off). Both route through _alert — a lagging/lost standby and
        a wedged promotion are exactly the failures HA exists to
        prevent, so each fire transition counts into
        ollamamq_watchdog_stalls_total{kind="standby"|"takeover"}."""
        hs_fn = getattr(self.engine, "ha_status", None)
        hs = hs_fn() if hs_fn is not None else None
        if hs is None:
            return
        role = hs.get("role")
        if role == "primary":
            lag = hs.get("sync_lag_records")
            # lag None = no standby has EVER polled (single-router HA
            # primary is a config choice, not a fault); once one has,
            # losing it or trailing past the threshold is alert-worthy.
            bad = lag is not None and (
                lag > STANDBY_LAG_ALERT_RECORDS
                or not hs.get("standby_connected", True))
            self._alert(
                "standby_lag", bad, "warn",
                (f"standby replication lag {lag} record(s) (threshold "
                 f"{STANDBY_LAG_ALERT_RECORDS}) or standby disconnected "
                 "— a takeover NOW would replay from that far behind"),
                "standby")
        stuck = (role == "promoting"
                 and hs.get("promote_elapsed_s", 0.0) > TAKEOVER_STUCK_S)
        self._alert(
            "takeover_stuck", stuck, "page",
            (f"router takeover in flight for "
             f"{hs.get('promote_elapsed_s', 0):.0f}s (budget "
             f"{TAKEOVER_STUCK_S:g}s) — recovery re-admission is wedged "
             "while the fleet has no serving router"), "takeover")

    def _check_journal_invariants(self) -> None:
        """The invariant sweep over the decision journal's ring: a
        violation is a live scheduler bug, alerted loudly; the alert
        resolves once the offending records age out of the ring."""
        alerts = getattr(self.engine, "alerts", None)
        journal = getattr(self.engine, "journal", None)
        if alerts is None or journal is None:
            return
        try:
            bad = check_invariants(journal.tail(None))
        except Exception:  # noqa: BLE001 — the sweep must not kill the monitor
            log.exception("journal invariant sweep failed")
            return
        if bad:
            log.error("scheduler invariant violation(s): %s", "; ".join(bad[:3]))
            alerts.fire(
                "journal_invariant", "page",
                f"{len(bad)} scheduler invariant violation(s) in the "
                f"decision journal; first: {bad[0]}", source="watchdog")
        else:
            alerts.resolve("journal_invariant")

    def status(self) -> dict:
        alerts = getattr(self.engine, "alerts", None)
        active = alerts.active() if alerts is not None else []
        return {
            "status": "degraded" if active else "ok",
            "device_online": self.device_online,
            "engine_stalled": self.engine_stalled,
            "last_device_check": self.last_device_check,
            "alerts": [a.to_dict() for a in active],
        }
