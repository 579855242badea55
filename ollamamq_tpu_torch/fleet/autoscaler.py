"""Elastic fleet: an SLO-burn-driven autoscaler with preemptible
members and scale-to-zero.

The JAX package's fleet/autoscaler.py over this package's FleetRouter.

UELLM's framing (PAPERS.md): SLO-aware deployment holds latency targets
at measurably lower resource cost — which is also the precondition for
the spot-style preemptible capacity real GPU fleets run on. The fleet
already has everything elasticity needs: per-tier SLO burn rates
(tiering.py / slo.py), live-stream migration, drain/retier machinery,
and a WAL that makes any member's death survivable. This module closes
the loop from observed load to fleet size:

  Control loop   a per-tier scaler (one group = one tier; the whole
                 fleet when untiered) watches sustained SLO burn +
                 queue backlog each router tick and decides scale-up /
                 scale-down ONE member at a time, with the TierBalancer
                 hysteresis discipline: a cooldown after every event,
                 and the burn/idle signal must be SUSTAINED (windows
                 derived from --scale-cooldown-s) — an oscillating load
                 must produce ZERO scale events. Scale-down is always
                 drain -> migrate-off -> retire (router.retire_replica),
                 never a kill.

  Provisioner    MemberProvisioner is the seam between the decision
                 loop and capacity. SubprocessProvisioner spawns
                 `python -m ollamamq_tpu_torch.cli` engine servers on
                 free ports and retires them with
                 SIGTERM; LocalProvisioner builds in-process engine
                 replicas from the CLI's engine factory (tests, and
                 fleets whose members share the local card). A cloud
                 provisioner (GPU VM create/delete through a cloud API)
                 implements the same three methods — provision /
                 retire / describe — and plugs in here unchanged; it is
                 deliberately NOT shipped: this repo has no cloud
                 credentials to test it against. Provisioned members
                 join through the existing probe/rejoin path and
                 inherit tier + scheduler + model config from the
                 member config the provisioner closed over.

  Preemptible    members flagged `preemptible` accept a termination
                 notice (POST /admin/preempt/{replica}, or the fault
                 plan's "preempt" site) that triggers migrate-off-then-
                 retire within the notice window instead of failover —
                 spot reclamation costs zero dropped streams.

  Scale-to-zero  the bulk tier may scale to zero members overnight:
                 queued bulk work PARKS at the router (the tier-
                 isolation path holds it; tiering.py's scaled_to_zero
                 set stops the empty-tier cross-tier fallback), and the
                 parked backlog is the pending-work signal that wakes
                 the tier — a wake bypasses cooldown AND sustain,
                 because parked streams must never wait out a timer
                 that exists to stop flapping. The interactive tier
                 (and an untiered fleet) keeps the --min-replicas
                 floor.

Every decision lands in the journal (scale_up / scale_down /
preempt_notice — paired by tools/journal.py's multi-spill checker),
metrics (ollamamq_fleet_scale_events_total / _member_hours_total /
_preemptions_total), and the TUI fleet chip.
"""

from __future__ import annotations

import logging
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.telemetry.slo import DEFAULT_WINDOWS, Objective

log = logging.getLogger("ollamamq.autoscaler")

# Decision cadence: signals are cheap (a pending-dict scan + cached burn
# reads) but there is no reason to re-decide faster than the probe loop.
TICK_PERIOD_S = 0.25

# Untiered fleets get their own TTFT objective at this threshold when
# the operator configured no --slo-ttft-ms (tiering.py's interactive
# default).
FLEET_TTFT_MS = 500.0

# Cold spawn estimate (seconds) before the first observed spawn: what a
# scaled-to-zero tier's Retry-After accounts for. Observed spawn
# durations fold in with this EMA weight.
SPAWN_EST_S = 5.0
SPAWN_EST_ALPHA = 0.5

# Scale-down low-water fraction: a group may shrink only when its load
# fits in HALF the remaining members' slots (plus zero backlog and no
# burn) — the surviving members must absorb the retiree with headroom,
# not at 100% occupancy.
IDLE_LOAD_FRACTION = 0.5


class MemberProvisioner:
    """The seam between the scale decision and actual capacity.

    provision(name, tier=None, tp=None) -> an UNSTARTED member object
        (fleet/members.py shape) named `name`; may block for seconds
        (it runs on the scaler's spawn thread, never the router loop).
        Raise on failure — the scaler journals scale_up aborted.
    retire(member) -> tear down what provision built (kill the
        subprocess, delete the VM); called after the member's drain
        emptied and it left the roster. Must not raise.
    describe() -> one-line provenance string for status surfaces.

    A cloud provisioner (GPU VM create/delete) implements exactly this
    interface; see the module docstring for why none ships here.
    """

    def provision(self, name: str, tier: Optional[str] = None,
                  tp: Optional[int] = None):
        raise NotImplementedError

    def retire(self, member) -> None:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class LocalProvisioner(MemberProvisioner):
    """In-process members from engine factories (the CLI's: same models,
    scheduler, fairness as the seed members). The cheap path for tests
    and for fleets whose replicas share the local card.
    `factory_for(name)` returns the engine factory of the member named
    `name` (the CLI's fleet/wide.py MemberFactory, which builds at any
    width on that member's own cards); `release(name)` runs at retire,
    so a retired member's cards are free again."""

    def __init__(self, factory_for, release=None):
        self.factory_for = factory_for
        self.release = release or (lambda name: None)

    def provision(self, name: str, tier: Optional[str] = None,
                  tp: Optional[int] = None):
        from ollamamq_tpu_torch.fleet.members import LocalMember

        factory = self.factory_for(name)
        return LocalMember(name, factory(tp), engine_factory=factory)

    def retire(self, member) -> None:
        try:
            member.stop()
        except Exception:  # noqa: BLE001
            log.exception("stopping retired member %s failed", member.name)
        self.release(member.name)

    def describe(self) -> str:
        return "local (in-process engine factory)"


class SubprocessProvisioner(MemberProvisioner):
    """Subprocess HttpMember engines as a provisioner: spawn `python -m
    ollamamq_tpu_torch.cli` on a free port, wait for /health, hand the
    router an HttpMember; retire is SIGTERM (the member server drains + flushes before exit).

    `member_argv` carries everything after the port (--fake-engine,
    --models, --scheduler, --max-slots, ... — the member_cfg the
    provisioned member inherits); `env` overlays os.environ."""

    # Router-level configuration that must NOT leak into a provisioned
    # member's environment: the member is a plain single-engine server,
    # and inheriting these turns it into a second router (TIERS without
    # a fleet fail-fasts the child; REPLICAS forks a nested fleet; a
    # shared WAL_DIR / JOURNAL_FILE has two processes appending to one
    # durability log). The in-process path strips the same fields from
    # member_cfg; this is the subprocess analog.
    ROUTER_ONLY_ENV = frozenset({
        "TIERS", "AUTOSCALE", "MIN_REPLICAS", "MAX_REPLICAS",
        "SCALE_COOLDOWN_S", "PREEMPTIBLE", "REPLICAS", "REPLICA_URLS",
        "PLACEMENT", "WAL_DIR", "JOURNAL_FILE", "BLOCKLIST", "PORT",
    })

    def __init__(self, member_argv: List[str],
                 env: Optional[dict] = None,
                 log_dir: Optional[str] = None,
                 health_timeout_s: float = 60.0):
        self.member_argv = list(member_argv)
        self.env = dict(env or {})
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="ollamamq-scale-")
        self.health_timeout_s = float(health_timeout_s)
        self._procs: Dict[str, tuple] = {}  # name -> (proc, log handle)

    def child_env(self) -> dict:
        env = {k: v for k, v in os.environ.items()
               if k not in self.ROUTER_ONLY_ENV}
        env.update(self.env)
        return env

    @staticmethod
    def _free_port() -> int:
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def _wait_health(self, url: str, deadline: float) -> None:
        import json
        import urllib.request

        last = "no response"
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(f"{url}/health",
                                            timeout=2.0) as resp:
                    body = json.loads(resp.read().decode())
                if body.get("state") != "recovering":
                    return
                last = "recovering"
            except Exception as e:  # noqa: BLE001
                last = str(e)
            time.sleep(0.1)
        raise RuntimeError(f"member at {url} never became healthy "
                           f"({last})")

    def provision(self, name: str, tier: Optional[str] = None,
                  tp: Optional[int] = None):
        from ollamamq_tpu_torch.fleet.members import HttpMember

        port = self._free_port()
        argv = [sys.executable, "-m", "ollamamq_tpu_torch.cli",
                "--no-tui", "--host", "127.0.0.1", "--port", str(port)]
        argv += self.member_argv
        if tp is not None and tp > 0:
            argv += ["--tp", str(tp)]
        logf = open(os.path.join(self.log_dir, f"{name}.log"), "ab")
        proc = subprocess.Popen(argv, env=self.child_env(),
                                stdout=logf, stderr=subprocess.STDOUT)
        url = f"http://127.0.0.1:{port}"
        try:
            self._wait_health(
                url, time.monotonic() + self.health_timeout_s)
        except Exception:
            proc.terminate()
            try:
                proc.wait(timeout=5.0)
            except Exception:  # noqa: BLE001
                proc.kill()
            logf.close()
            raise
        member = HttpMember(name, url)
        self._procs[name] = (proc, logf)
        return member

    def retire(self, member) -> None:
        try:
            member.stop()
        except Exception:  # noqa: BLE001
            pass
        proc, logf = self._procs.pop(member.name, (None, None))
        if proc is None:
            return
        proc.terminate()  # SIGTERM: the member drains + flushes first
        try:
            proc.wait(timeout=10.0)
        except Exception:  # noqa: BLE001
            proc.kill()
        if logf is not None:
            logf.close()

    def shutdown(self) -> None:
        """Kill any members still alive (router stop / test teardown)."""
        for name in list(self._procs):
            proc, logf = self._procs.pop(name)
            proc.terminate()
            try:
                proc.wait(timeout=5.0)
            except Exception:  # noqa: BLE001
                proc.kill()
            logf.close()

    def describe(self) -> str:
        return "subprocess (HttpMember engine servers)"


class AutoscalerManager:
    """The control loop. Owned by FleetRouter (constructed under
    --autoscale); tick() runs on the router loop thread right after the
    TierBalancer's. Provisioning runs on a spawn thread — the router
    loop must keep serving while a member boots — and the booted member
    joins on the next tick."""

    def __init__(self, router, provisioner: MemberProvisioner,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 sustain_s: Optional[float] = None,
                 idle_sustain_s: Optional[float] = None,
                 backlog_high: Optional[int] = None,
                 scale_to_zero: bool = True,
                 provision_preemptible: bool = False,
                 windows: Tuple[tuple, ...] = DEFAULT_WINDOWS,
                 tick_period_s: float = TICK_PERIOD_S):
        ecfg = router.ecfg
        self.router = router
        self.journal = router.journal
        self.provisioner = provisioner
        self.min_replicas = int(
            getattr(ecfg, "min_replicas", 1)
            if min_replicas is None else min_replicas)
        self.max_replicas = int(
            getattr(ecfg, "max_replicas", 4)
            if max_replicas is None else max_replicas)
        self.cooldown_s = float(
            getattr(ecfg, "scale_cooldown_s", 30.0)
            if cooldown_s is None else cooldown_s)
        # Hysteresis windows derive from the one operator knob unless a
        # test overrides them: pressure must hold a third of a cooldown
        # before a scale-up; idleness must hold a FULL cooldown before a
        # scale-down (shrinking too eagerly costs a spawn to undo).
        self.sustain_s = (max(0.5, self.cooldown_s / 3.0)
                          if sustain_s is None else float(sustain_s))
        self.idle_sustain_s = (self.cooldown_s if idle_sustain_s is None
                               else float(idle_sustain_s))
        self.backlog_high = int(
            max(1, getattr(ecfg, "max_slots", 8))
            if backlog_high is None else backlog_high)
        self.scale_to_zero = bool(scale_to_zero)
        self.provision_preemptible = bool(provision_preemptible)
        self.windows = windows
        self.tick_period_s = float(tick_period_s)
        # Untiered fleets carry their own TTFT objective (tiered ones
        # read the TierManager's per-tier burn).
        self.objective: Optional[Objective] = None
        if router.tiers is None:
            ttft = getattr(ecfg, "slo_ttft_ms", None) or FLEET_TTFT_MS
            horizon = max((w[1] for w in windows), default=3600.0)
            self.objective = Objective(
                "autoscale_fleet", ttft,
                getattr(ecfg, "slo_target", 0.99) or 0.99,
                horizon_s=horizon)
        # Control-loop state.
        self._last_tick = 0.0
        self._hot_since: Dict[Optional[str], float] = {}
        self._idle_since: Dict[Optional[str], float] = {}
        self.last_event_at = 0.0
        self.scale_times: deque = deque(maxlen=128)
        self.scale_counts: Dict[str, int] = {}
        self.spawn_est_s = SPAWN_EST_S
        self._spawn: Optional[dict] = None  # {"name","tier","t0","why"}
        self._spawn_done: "queue.Queue" = queue.Queue()
        self._next_id = 0
        # Member-hours ledger (the metric is cumulative; the float here
        # backs the bench/status readout).
        self.member_seconds = 0.0
        self._hours_at = time.monotonic()

    # ------------------------------------------------------------- signals
    def record_ttft(self, ttft_ms: float) -> None:
        """Router first-token hook for UNTIERED fleets (tiered ones
        feed TierManager.record_ttft, which this scaler reads)."""
        if self.objective is not None:
            self.objective.record(ttft_ms)

    def _groups(self) -> List[Optional[str]]:
        if self.router.tiers is not None:
            return ["interactive", "bulk"]
        return [None]

    def _floor(self, group: Optional[str]) -> int:
        if group == "bulk" and self.scale_to_zero:
            return 0
        return self.min_replicas

    def _members_of(self, group: Optional[str]) -> List[object]:
        return [m for m in self.router.members
                if group is None or getattr(m, "tier", None) == group]

    def _burn_state(self, group: Optional[str]) -> Tuple[bool, float]:
        if self.router.tiers is not None:
            return self.router.tiers.overflow_state(group)
        obj = self.objective
        now = time.monotonic()
        active, burn = False, 0.0
        for _label, long_w, short_w, factor, _sev in self.windows:
            burn_long = obj.burn_rate(long_w, now=now)
            burn_short = obj.burn_rate(short_w, now=now)
            if burn_long > factor and burn_short > factor:
                active, burn = True, max(burn, burn_long)
        return active, burn

    def _backlog(self, group: Optional[str]) -> int:
        """Queued streams waiting at the router for this group — parked
        work on a scaled-to-zero tier shows up here (the wake signal)."""
        router = self.router
        with router._pending_lock:
            flights = list(router.pending.values())
        if group is None or router.tiers is None:
            return len(flights)
        tiers = router.tiers
        n = 0
        for f in flights:
            t = getattr(f, "tier", None)
            if t is None:
                try:
                    t = tiers.tier_of_class(
                        tiers.class_of(f.user, f.req.deadline))
                except Exception:  # noqa: BLE001
                    t = "bulk"
            if t == group:
                n += 1
        return n

    def _inflight(self, group: Optional[str]) -> int:
        mems = set(id(m) for m in self._members_of(group))
        return sum(1 for f in self.router.flights
                   if not f.done and f.member is not None
                   and id(f.member) in mems)

    def _slot_cap(self, group: Optional[str]) -> int:
        caps = [self.router._slot_cap(m) for m in self._members_of(group)]
        return max(caps) if caps else int(
            getattr(self.router.ecfg, "max_slots", 8) or 8)

    # ---------------------------------------------------------------- tick
    def tick(self) -> None:
        now = time.monotonic()
        self._accrue_member_hours(now)
        self._reap_spawn(now)
        if now - self._last_tick < self.tick_period_s:
            return
        self._last_tick = now
        # One scale operation in flight fleet-wide: a pending spawn, or
        # any member mid-retire/mid-regroup, parks the decision loop.
        busy = self._spawn is not None or any(
            getattr(m, "retiring", False) or m.retier_to is not None
            for m in self.router.members)
        for group in self._groups():
            self._evaluate(group, now, busy)

    def _accrue_member_hours(self, now: float) -> None:
        dt = now - self._hours_at
        if dt <= 0:
            return
        self._hours_at = now
        n = sum(1 for m in self.router.members if m.state != "ejected")
        if n:
            self.member_seconds += dt * n
            tm.FLEET_MEMBER_HOURS_TOTAL.inc(dt * n / 3600.0)

    def _evaluate(self, group: Optional[str], now: float,
                  busy: bool) -> None:
        mems = self._members_of(group)
        healthy = [m for m in mems
                   if m.state == "healthy"
                   and not getattr(m, "retiring", False)]
        n = len(mems)
        fleet = len(self.router.members)
        backlog = self._backlog(group)
        firing, burn = self._burn_state(group)
        inflight = self._inflight(group)
        cap = self._slot_cap(group)
        # --- wake: a scaled-to-zero group with parked work bypasses
        # every hysteresis timer — capacity now, debate later.
        if (not healthy and backlog > 0 and not busy
                and fleet < self.max_replicas):
            self._launch_scale_up(group, "wake", burn, backlog)
            return
        # --- scale-up pressure: sustained burn, or a backlog more than
        # one member's worth of slots deep.
        hot = (firing or backlog > self.backlog_high) and n > 0
        if hot:
            self._idle_since.pop(group, None)
            since = self._hot_since.setdefault(group, now)
            if (not busy and fleet < self.max_replicas
                    and now - since >= self.sustain_s
                    and now - self.last_event_at >= self.cooldown_s):
                why = "burn" if firing else "backlog"
                self._hot_since.pop(group, None)
                self._launch_scale_up(group, why, burn, backlog)
            return
        self._hot_since.pop(group, None)
        # --- scale-down: no burn, no backlog, and the group's load fits
        # comfortably in one fewer member — sustained a full cooldown.
        floor = self._floor(group)
        idle = (n > floor and backlog == 0 and not firing
                and inflight <= (n - 1) * cap * IDLE_LOAD_FRACTION)
        if not idle:
            self._idle_since.pop(group, None)
            return
        since = self._idle_since.setdefault(group, now)
        if (busy or now - since < self.idle_sustain_s
                or now - self.last_event_at < self.cooldown_s):
            return
        victim = self._pick_victim(group)
        if victim is None:
            return
        self._idle_since.pop(group, None)
        try:
            self.router.retire_replica(victim.name, why="idle",
                                       burn=round(burn, 2),
                                       queued=backlog)
        except (KeyError, ValueError, RuntimeError) as e:
            log.warning("scale-down of %s skipped: %s", victim.name, e)

    def _pick_victim(self, group: Optional[str]):
        """Least-loaded healthy member of the group, preferring ones
        this scaler provisioned (operator-defined seed members retire
        last), then preemptible ones (spot capacity is the cheapest to
        give back)."""
        cands = [m for m in self._members_of(group)
                 if m.state == "healthy"
                 and not getattr(m, "retiring", False)
                 and m.retier_to is None]
        if not cands:
            return None
        for pool in (
                [m for m in cands
                 if getattr(m, "provisioned_by", None) is not None],
                [m for m in cands if getattr(m, "preemptible", False)],
                cands):
            if pool:
                return min(pool, key=self.router._load_of)
        return None

    # ------------------------------------------------------------ scale-up
    def _next_name(self) -> str:
        taken = {m.name for m in self.router.members}
        while True:
            name = f"a{self._next_id}"
            self._next_id += 1
            if name not in taken:
                return name

    def _launch_scale_up(self, group: Optional[str], why: str,
                         burn: float, backlog: int) -> None:
        name = self._next_name()
        self.journal.record(
            "scale_up", replica=name, phase="start",
            tier=group, why=why,
            burn=round(burn, 2) if burn else None,
            queued=backlog, fleet=len(self.router.members))
        log.warning("scaler growing tier %s: provisioning %s (%s, "
                    "%d queued)", group or "fleet", name, why, backlog)
        self._spawn = {"name": name, "tier": group,
                       "t0": time.monotonic(), "why": why}
        tp = (self.router.tiers.widths.get(group)
              if self.router.tiers is not None else None)
        threading.Thread(target=self._spawn_worker,
                         args=(name, group, tp),
                         name=f"scale-up-{name}", daemon=True).start()

    def _spawn_worker(self, name: str, tier: Optional[str],
                      tp: Optional[int]) -> None:
        try:
            member = self.provisioner.provision(name, tier=tier, tp=tp)
        except Exception as e:  # noqa: BLE001
            log.exception("provisioning member %s failed", name)
            self._spawn_done.put(("error", name, str(e)))
        else:
            self._spawn_done.put(("ok", name, member))
        self.router.notify()

    def _reap_spawn(self, now: float) -> None:
        try:
            status, name, payload = self._spawn_done.get_nowait()
        except queue.Empty:
            return
        spawn = self._spawn or {}
        self._spawn = None
        tier = spawn.get("tier")
        spawn_s = now - spawn.get("t0", now)
        if status != "ok":
            self.journal.record(
                "scale_up", replica=name, phase="aborted", tier=tier,
                why=str(payload)[:120], fleet=len(self.router.members))
            self.note_scale_event("up", "aborted")
            log.error("scale-up of %s ABORTED: %s", name, payload)
            return
        member = payload
        member.provisioned_by = self.provisioner
        member.preemptible = self.provision_preemptible
        try:
            member.start()
        except Exception as e:  # noqa: BLE001
            log.exception("starting provisioned member %s failed", name)
            self.provisioner.retire(member)
            self.journal.record(
                "scale_up", replica=name, phase="aborted", tier=tier,
                why=f"start_failed: {e}"[:120],
                fleet=len(self.router.members))
            self.note_scale_event("up", "aborted")
            return
        self.spawn_est_s = (SPAWN_EST_ALPHA * spawn_s
                            + (1.0 - SPAWN_EST_ALPHA) * self.spawn_est_s)
        router = self.router
        router.members.append(member)
        if router.tiers is not None and tier is not None:
            router.tiers.note_member_added(member, tier)  # clears park
        self.journal.record(
            "scale_up", replica=name, phase="done", tier=tier,
            why=spawn.get("why"), spawn_ms=round(spawn_s * 1e3, 1),
            fleet=len(router.members))
        self.journal.record("replica_join", replica=name, why="scale_up")
        self.note_scale_event("up", "done")
        log.warning("member %s joined tier %s in %.1fs; fleet -> %d",
                    name, tier or "fleet", spawn_s, len(router.members))
        router._update_gauges()
        router.notify()

    # --------------------------------------------------------- bookkeeping
    def note_scale_event(self, direction: str, outcome: str) -> None:
        """Every completed/aborted scale event: metrics, the rate window
        the scale_storm watchdog reads, and the cooldown clock (aborted
        events cool down too — retrying a failing spawn in a tight loop
        IS flapping)."""
        tm.FLEET_SCALE_EVENTS_TOTAL.labels(direction=direction,
                                           outcome=outcome).inc()
        key = f"{direction}_{outcome}"
        self.scale_counts[key] = self.scale_counts.get(key, 0) + 1
        self.scale_times.append(time.monotonic())
        self.last_event_at = time.monotonic()

    def scale_rate_per_min(self, window_s: float = 60.0) -> float:
        """Scale events per minute over the trailing window — the
        health watchdog's scale_storm signal."""
        cutoff = time.monotonic() - window_s
        n = sum(1 for t in self.scale_times if t >= cutoff)
        return n * 60.0 / window_s

    def wake_wait_s(self) -> float:
        """Estimated seconds until a scaled-to-zero tier serves again:
        0 when nothing is parked at zero; otherwise the spawn estimate
        (minus elapsed spawn time when a wake is already in flight) —
        what retry_after_s adds to a 503 so clients don't hammer a
        Retry-After computed from the completion rate of members that
        don't exist."""
        tiers = self.router.tiers
        if tiers is None or not tiers.scaled_to_zero:
            return 0.0
        if self._spawn is not None:
            return max(0.0, self.spawn_est_s
                       - (time.monotonic() - self._spawn["t0"]))
        return self.spawn_est_s + self.tick_period_s

    def member_hours(self) -> float:
        self._accrue_member_hours(time.monotonic())
        return self.member_seconds / 3600.0

    def brief(self) -> dict:
        """TUI fleet chip payload: `fleet N (+P preemptible)`."""
        members = self.router.members
        return {
            "n": len(members),
            "preemptible": sum(1 for m in members
                               if getattr(m, "preemptible", False)),
            "min": self.min_replicas,
            "max": self.max_replicas,
        }

    def status(self) -> dict:
        tiers = self.router.tiers
        return {
            "enabled": True,
            "provisioner": self.provisioner.describe(),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "cooldown_s": self.cooldown_s,
            "sustain_s": self.sustain_s,
            "idle_sustain_s": self.idle_sustain_s,
            "fleet": len(self.router.members),
            "preemptible": [m.name for m in self.router.members
                            if getattr(m, "preemptible", False)],
            "spawn_in_flight": (self._spawn or {}).get("name"),
            "spawn_est_s": round(self.spawn_est_s, 2),
            "scaled_to_zero": (sorted(tiers.scaled_to_zero)
                               if tiers is not None else []),
            "scale_events": dict(self.scale_counts),
            "scale_rate_per_min": round(self.scale_rate_per_min(), 2),
            "member_hours": round(self.member_hours(), 4),
        }
