"""Fleet router: a thin dispatcher-over-engines front-end.

The source dispatcher's reason to exist is serving DESPITE backend churn
(dispatcher.rs health loop: probe, eject, re-dispatch, least-loaded
placement). This module is that role over N engine replicas:

  - the router owns the per-user fair-share queues (its own native
    MQCore + blocklist) and the fleet-wide bounded-admission caps;
    members never second-guess an admitted placement;
  - placement is least-loaded with optional prefix-cache affinity
    (--placement=affinity, the default: route to the replica whose
    radix tree already holds the prompt's prefix, falling back to
    least-loaded with round-robin tie rotation);
  - replica health = the member's /health alert table + heartbeat
    staleness; an unhealthy member is EJECTED from rotation and
    re-probed with exponential backoff before re-admission;
  - when a replica dies or is ejected mid-stream, its victim streams
    recover by MIGRATION first: the dying member's KV pages + request
    state ship to a healthy member in a journaled two-phase handoff
    (export/park -> import ack -> commit), so the stream resumes from
    shipped state with ZERO recomputed tokens. Only when the source
    can't export (or the transfer fails) does the stream FAIL OVER the
    old way: replay prompt + every already-emitted token on a healthy
    replica. Both paths keep greedy streams byte-identical to an
    unkilled run;
  - POST /admin/drain/{replica} quiesces a member: no new placements,
    live streams MIGRATE to healthy members (stragglers that can't
    migrate run to completion, failing over past the drain timeout),
    then hot-restart and rejoin — rolling restarts drop nothing;
  - affinity misses may ship the cached prompt prefix to the chosen
    member instead of routing around it.

Every fleet decision is journaled (replica_eject / replica_failover /
replica_drain / replica_join) with the inputs that justified it, under
the STREAM's original router request id — stable across failovers and
requeues — so tools/journal.py can audit that no stream a replica
failure touched was ever dropped.

The router presents the same surface the HTTP server expects of an
engine (core / enqueue_request / cancel / stats / alerts / journal /
tracer / health ...), so server/app.py serves a fleet unchanged.

This is the JAX package's fleet/router.py, with its policy layers:
replica tiers (fleet/tiering.py, under `tiers`), the autoscaler
(fleet/autoscaler.py, under `engine_cfg.autoscale`) and router HA
(fleet/ha.py: `epoch` stamps every member-facing call; `engine_cfg.ha`
attaches the primary's replication coordinator, a standby process gets
an HAStandby attached by the CLI instead). Preemptible members work
without the autoscaler, as in the JAX package.
"""

from __future__ import annotations

import collections
import copy
import logging
import threading
import time
from typing import Dict, List, Optional

from ollamamq_tpu_torch.core.mqcore import (BlockedError, Fairness, Family,
                                            MQCore, StuckQueue)
from ollamamq_tpu_torch.engine import kv_cache as kvc
from ollamamq_tpu_torch.config import get_model_config
from ollamamq_tpu_torch.engine.engine import (QueueFullError, check_token_ids,
                                              merge_prefix_cache_stats)
from ollamamq_tpu_torch.engine.health import HealthMonitor
from ollamamq_tpu_torch.engine.request import FinishReason, Request
from ollamamq_tpu_torch.fleet.members import HttpMember, LocalMember  # noqa: F401
from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.telemetry.journal import Journal
from ollamamq_tpu_torch.telemetry.slo import AlertManager, SLOEngine
from ollamamq_tpu_torch.telemetry.tracing import Tracer

log = logging.getLogger("ollamamq.fleet")

# Health-loop defaults (constructor-overridable; tests shrink them).
PROBE_PERIOD_S = 0.25        # member health sweep cadence
EJECT_HEARTBEAT_S = 3.0      # heartbeat staleness that ejects a member
REPROBE_BACKOFF_S = 0.5      # first re-probe delay after ejection...
REPROBE_BACKOFF_MAX_S = 30.0  # ...doubling per failed probe up to this
EVAC_GRACE_S = 2.0           # max wait for a dying member to ack eviction


class _Flight:
    """One client stream through the fleet: the router-owned Request the
    server consumes, plus its current member attempt. `rid0` is the
    stream's stable identity in the router journal (req.req_id rotates
    on requeue; the audit trail must not)."""

    __slots__ = ("req", "rid0", "user", "ip", "model", "family", "kind",
                 "raw_prompt", "prompt_tokens", "sampling", "member",
                 "attempt", "resume", "failed_from", "evac_since",
                 "evac_deadline", "begin_failures", "done",
                 "migrate_tried", "tier", "cls", "ctx", "place_ms")

    def __init__(self, req: Request, ip: str, family) -> None:
        self.req = req
        self.rid0 = req.req_id
        # Fleet-stable trace context, minted at router admission and
        # propagated to every member attempt (in-process / traceparent
        # header) so all processes' spans stitch under rid0.
        self.ctx = req.trace.ctx if req.trace is not None else None
        # Router overhead of the LAST placement decision for this
        # flight (perf-counter ms) — journaled on the place record.
        self.place_ms: Optional[float] = None
        self.user = req.user
        self.ip = ip
        self.model = req.model
        self.family = family
        self.kind = req.kind
        self.raw_prompt = req.raw_prompt
        self.prompt_tokens = list(req.prompt_tokens)
        self.sampling = req.sampling
        self.member = None
        self.attempt = None
        self.resume: Optional[dict] = None
        self.failed_from: Optional[str] = None
        self.evac_since: Optional[float] = None
        self.evac_deadline = 0.0
        self.begin_failures = 0
        self.done = False
        self.migrate_tried = False  # one migration attempt per drain
        # Tiered fleet: the request's class (vip/boost/deadline/default)
        # and home tier, set at first placement and carried through
        # failover/migration so evacuated streams land back IN-TIER.
        self.tier: Optional[str] = None
        self.cls: Optional[str] = None


class FleetRouter:
    """Engine-shaped facade over N members; see module docstring."""

    def __init__(self, members: List[object], engine_cfg,
                 blocklist_path: Optional[str] = "blocked_items.json",
                 fairness: Fairness = Fairness.REQUESTS,
                 placement: str = "affinity",
                 drain_timeout_s: float = 30.0,
                 probe_period_s: float = PROBE_PERIOD_S,
                 eject_heartbeat_s: float = EJECT_HEARTBEAT_S,
                 reprobe_backoff_s: float = REPROBE_BACKOFF_S,
                 evac_grace_s: float = EVAC_GRACE_S,
                 migrate: Optional[bool] = None,
                 migrate_timeout_s: Optional[float] = None,
                 tiers: Optional[str] = None,
                 tiering_kw: Optional[dict] = None,
                 provisioner=None,
                 autoscale_kw: Optional[dict] = None):
        assert members, "a fleet needs at least one member"
        if placement not in ("affinity", "least_loaded"):
            raise ValueError(f"unknown placement policy {placement!r} "
                             "(want 'affinity' or 'least_loaded')")
        self.members = list(members)
        names = [m.name for m in self.members]
        assert len(set(names)) == len(names), "member names must be unique"
        self.ecfg = engine_cfg
        # The device the health monitor probes: the in-process members'
        # (an HTTP-only router holds none and probes its own CPU).
        local = [m for m in self.members if isinstance(m, LocalMember)]
        self.device = (getattr(local[0].engine, "device", "cpu") if local
                       else "cpu")
        self.placement = placement
        self.drain_timeout_s = float(drain_timeout_s)
        self.probe_period_s = float(probe_period_s)
        self.eject_heartbeat_s = float(eject_heartbeat_s)
        self.reprobe_backoff_s = float(reprobe_backoff_s)
        self.evac_grace_s = float(evac_grace_s)
        # KV page migration: failover/drain ships state instead of
        # recomputing it (falling back to recompute when it can't).
        self.migrate = bool(getattr(engine_cfg, "migrate", True)
                            if migrate is None else migrate)
        self.migrate_timeout_s = float(
            getattr(engine_cfg, "migrate_timeout_s", 10.0)
            if migrate_timeout_s is None else migrate_timeout_s)
        self.migration_count = 0
        self.migrate_abort_count = 0
        self.core = MQCore(blocklist_path)
        self.core.set_fairness(fairness)
        self.pending: Dict[int, _Flight] = {}  # queued, keyed by CURRENT rid
        self.flights: List[_Flight] = []       # placed, loop-thread-owned
        self._pending_lock = threading.Lock()
        self._cond = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self.started_at = time.time()
        self.last_tick_at = time.monotonic()
        self.tracer = Tracer(capacity=engine_cfg.trace_ring,
                             origin="router")
        # Router-overhead self-profiling: a rolling window of placement
        # decision costs (ms) behind router_overhead_p99_ms() — the
        # health monitor's overhead-storm alert and the bench gate read
        # the windowed p99 so a one-off spike ages out; the cumulative
        # story lives in the ollamamq_router_overhead_ms histogram.
        self._place_window: collections.deque = collections.deque(
            maxlen=512)
        self.alerts = AlertManager()
        # The router's SLOEngine exists for the shared alert/evaluate
        # surface; latency objectives stay member-side (each member's
        # runtimes record into its own SLOEngine) to avoid double-counting
        # the global ollamamq_slo_* series.
        self.slo = SLOEngine(self.alerts)
        tiers_spec = (getattr(engine_cfg, "tiers", None)
                      if tiers is None else tiers)
        meta = {"fleet": len(self.members), "placement": placement,
                "model": engine_cfg.model}
        if tiers_spec:
            meta["tiers"] = tiers_spec
        self.journal = Journal(
            capacity=engine_cfg.journal_ring,
            path=engine_cfg.journal_file,
            rotate_bytes=int(engine_cfg.journal_rotate_mb * 1e6),
            keep=engine_cfg.journal_keep,
            sample=getattr(engine_cfg, "journal_sample", 1.0),
            meta=meta)
        # Always-on journal-record self-timer: every flight-recorder
        # append the ROUTER makes lands in
        # ollamamq_router_overhead_ms{site="journal"} — the "journal"
        # half of ROADMAP's "router overhead (placement + journal)
        # measured and bounded". Wrapped at the instance so every
        # record site (and TierManager, which shares this journal)
        # is covered without touching them.
        _record = self.journal.record
        _jhist = tm.ROUTER_OVERHEAD_MS.labels(site="journal")

        def _timed_record(kind, *a, **kw):
            t0 = time.perf_counter_ns()
            try:
                return _record(kind, *a, **kw)
            finally:
                _jhist.observe((time.perf_counter_ns() - t0) / 1e6)

        self.journal.record = _timed_record
        self.health = None
        self.shed_counts: Dict[str, int] = {}
        self.failover_count = 0
        self._rr = 0  # least-loaded tie-rotation cursor
        self._last_probe = 0.0
        self._last_stuck_log = 0.0
        self._plan_down: set = set()  # members downed by a device_loss rule
        self._mirrored: Dict[str, set] = {}  # member -> mirrored alert names
        self._model_names = [engine_cfg.model] if engine_cfg.model else []
        self.fault_plan = None
        if engine_cfg.fault_plan:
            from ollamamq_tpu_torch.testing.faults import FaultPlan

            self.fault_plan = (
                FaultPlan.load(engine_cfg.fault_plan)
                if isinstance(engine_cfg.fault_plan, str)
                else engine_cfg.fault_plan)
        # Graceful-shutdown gate, mirrored from TorchEngine.
        self.accepting = True
        # Crash durability: in fleet mode the ROUTER owns the WAL (like
        # the journal spill); recovery re-places WAL'd streams across
        # the surviving members through the normal placement path.
        self.durability = None
        if getattr(engine_cfg, "wal_dir", None):
            from ollamamq_tpu_torch.durability import DurabilityManager

            self.durability = DurabilityManager(
                engine_cfg, journal=self.journal, alerts=self.alerts,
                fault_plan=self.fault_plan)
        # Tiered fleet (fleet/tiering.py): class-aware placement, per-
        # tier SLO burn overflow, and the adaptive-regrouping balancer.
        # None = untiered (every member interchangeable).
        self.tiers = None
        if tiers_spec:
            from ollamamq_tpu_torch.fleet.tiering import TierManager

            self.tiers = TierManager(self.members, tiers_spec,
                                     core=self.core, journal=self.journal,
                                     ecfg=engine_cfg,
                                     **(tiering_kw or {}))
        # Preemptible members: flagged members accept a termination
        # notice (POST /admin/preempt/{replica} or the fault plan's
        # "preempt" site) -> migrate-off-then-retire within the notice
        # window. Flags work without the autoscaler.
        preempt_spec = getattr(engine_cfg, "preemptible", None)
        if preempt_spec:
            want = {s.strip() for s in str(preempt_spec).split(",")
                    if s.strip()}
            unknown = want - set(names)
            if unknown:
                raise ValueError(
                    f"--preemptible names unknown members: "
                    f"{', '.join(sorted(unknown))} (fleet: "
                    f"{', '.join(names)})")
            for mem in self.members:
                if mem.name in want:
                    mem.preemptible = True
        # Elastic fleet (fleet/autoscaler.py): SLO-burn-driven sizing
        # behind --autoscale. None = fixed fleet.
        self.autoscaler = None
        if getattr(engine_cfg, "autoscale", False):
            from ollamamq_tpu_torch.fleet.autoscaler import (
                AutoscalerManager, LocalProvisioner)

            if provisioner is None:
                from ollamamq_tpu_torch.fleet.wide import MemberFactory

                factory = getattr(self.members[0], "engine_factory", None)
                if factory is None:
                    raise ValueError(
                        "--autoscale needs a MemberProvisioner (none "
                        "given, and the seed members carry no engine "
                        "factory to build a LocalProvisioner from)")
                if isinstance(factory, MemberFactory):
                    # It builds its own member, on that member's cards.
                    raise ValueError(
                        "--autoscale over members with cards of their "
                        "own needs a LocalProvisioner that makes each new "
                        "member's factory (cli.build_fleet's); the seed "
                        "member's factory builds only that member")
                provisioner = LocalProvisioner(lambda name: factory)
            self.autoscaler = AutoscalerManager(
                self, provisioner, **(autoscale_kw or {}))
        # Router HA (fleet/ha.py): `epoch` stamps every member-facing
        # call (members adopt newer epochs and fence older ones, so a
        # zombie ex-primary can't split-brain the fleet). --ha attaches
        # the primary-side replication coordinator here; a standby
        # process gets an HAStandby attached by the CLI instead and
        # stays unstarted until promotion.
        self.epoch = 1
        self.ha = None
        if getattr(engine_cfg, "ha", False):
            from ollamamq_tpu_torch.fleet.ha import HACoordinator

            self.ha = HACoordinator(self)
        for mem in self.members:
            self.journal.record("replica_join", replica=mem.name,
                                why="start")
        self._update_gauges()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        try:
            for mem in self.members:
                mem.start()  # member starts are idempotent
            if self.ha is not None and hasattr(self.ha, "on_router_start"):
                # Stamp every member with our epoch before placements
                # land.
                self.ha.on_router_start()
            self._thread = threading.Thread(target=self._loop,
                                            name="fleet", daemon=True)
            self._thread.start()
            if self.health is None:
                self.health = HealthMonitor(self)
                self.health.start()
            if self.durability is not None:
                # Fleet-wide recovery: WAL'd streams re-enter the
                # router queue and re-place across whichever members
                # survived.
                self.durability.start(self)
        except Exception:
            # A partial start must stay retryable (HA promotion retries
            # start() after an abort): clear the running flag so the
            # retry re-runs the ladder instead of no-opping, and wake
            # the fleet thread (if it got up) so it exits.
            self._running = False
            self.notify()
            raise

    def stop(self) -> None:
        self._running = False
        self.notify()
        if self._thread:
            self._thread.join(timeout=10)
            self._thread = None
        if self.health is not None:
            self.health.stop()
            self.health = None
        for mem in self.members:
            try:
                if getattr(mem, "provisioned_by", None) is not None:
                    # Tear down what the provisioner built (e.g. kill
                    # the subprocess behind an HttpMember).
                    mem.provisioned_by.retire(mem)
                else:
                    mem.stop()
            except Exception:  # noqa: BLE001
                log.exception("stopping member %s failed", mem.name)
        if self.durability is not None:
            self.durability.close()  # final WAL flush + fsync
        self.journal.close()

    def quiesce(self) -> None:
        """Graceful-shutdown gate: no new admissions; in-flight streams
        keep draining on their members."""
        self.accepting = False

    def inflight_count(self) -> int:
        return (self.core.total_queued() + len(self.pending)
                + sum(1 for f in self.flights if not f.done))

    def notify(self) -> None:
        with self._cond:
            self._cond.notify()

    # -------------------------------------------------------- engine facade
    @property
    def local_members(self) -> List[LocalMember]:
        return [m for m in self.members if isinstance(m, LocalMember)]

    @property
    def runtimes(self) -> dict:
        """Merged member runtimes keyed uniquely (model@member) — the
        health monitor's progress check and the TUI read this. Ejected
        members are excluded: their parked work must not read as an
        engine-wide stall."""
        out = {}
        for mem in self.local_members:
            if mem.state == "ejected":
                continue
            for name, rt in mem.engine.runtimes.items():
                out[f"{name}@{mem.name}"] = rt
        return out

    def loaded_models(self) -> List[str]:
        locals_ = self.local_members
        if locals_:
            return locals_[0].engine.loaded_models()
        return list(self._model_names)

    def load_model(self, name: str, checkpoint_path: Optional[str] = None):
        if not self.local_members:
            raise NotImplementedError(
                "runtime pull is not supported for HTTP fleet members; "
                "load models on the member services")
        for mem in self.local_members:
            mem.engine.load_model(name, checkpoint_path)
        if name not in self._model_names:
            self._model_names.append(name)

    def evict_model(self, name: str) -> bool:
        ok = False
        for mem in self.local_members:
            ok = mem.engine.evict_model(name) or ok
        return ok

    def resolve_runtime(self, model: str, kind: str = "generate"):
        for mem in self.local_members:
            if mem.state != "ejected":
                rt = mem.engine.resolve_runtime(model, kind=kind)
                if rt is not None:
                    return rt
        for mem in self.local_members:
            rt = mem.engine.resolve_runtime(model, kind=kind)
            if rt is not None:
                return rt
        return None

    def chip_stats(self) -> List[dict]:
        locals_ = self.local_members
        return locals_[0].engine.chip_stats() if locals_ else []

    def worker_metric_snapshots(self) -> List[dict]:
        """The worker ranks' snapshots of every member wider than one
        rank. In-process members, and the rank 0 of each wide member's
        world, record into this process's registry already; the other
        ranks of a wide member's world run in processes of their own
        (fleet/wide.py). A member that cannot answer is skipped."""
        out: List[dict] = []
        for mem in self.local_members:
            try:
                out.extend(mem.engine.worker_metric_snapshots())
            except Exception:  # noqa: BLE001 — a rebuilding or dead member
                log.exception("member %s: worker metric snapshots failed",
                              mem.name)
        return out

    def stale_worker_hosts(self) -> List[int]:
        return []

    def stale_replicas(self) -> List[str]:
        """Members out of rotation or heartbeat-stale — the fleet-level
        analogue of stale_worker_hosts; the health watchdog raises
        `replica_stale` (kind="replica") from this."""
        out = []
        for mem in self.members:
            if mem.state == "ejected" \
                    or mem.heartbeat_age() > self.eject_heartbeat_s:
                out.append(mem.name)
        return out

    def ha_status(self) -> Optional[dict]:
        """Role/epoch/sync-lag readout (None = HA off): /health's role
        block, the TUI ha chip, and the health watchdog's standby-lag /
        stuck-takeover rules all read this one dict."""
        return self.ha.status() if self.ha is not None else None

    def ha_handover(self, timeout_s: float = 10.0) -> bool:
        """Graceful SIGTERM on an HA primary: quiesce, then hand the
        fleet to the caught-up standby (it promotes with why="handover")
        instead of draining the world. False = no standby ever synced or
        it never confirmed — the caller falls back to a normal drain."""
        if self.ha is None or not hasattr(self.ha, "request_handover"):
            return False
        self.quiesce()
        return self.ha.request_handover(timeout_s)

    def preemption_count(self) -> int:
        return sum(mem.engine.preemption_count()
                   for mem in self.local_members)

    def retry_count(self) -> int:
        return sum(mem.engine.retry_count() for mem in self.local_members)

    def prefix_cache_stats(self) -> dict:
        per_model: Dict[str, list] = {}
        for mem in self.local_members:
            stats = mem.engine.prefix_cache_stats()
            for name, row in (stats.get("models") or {}).items():
                if row is not None:
                    per_model.setdefault(name, []).append(row)
        merged = {name: merge_prefix_cache_stats(rows)
                  for name, rows in per_model.items()}
        return {"enabled": bool(merged), "models": merged}

    def prefix_cache_flush(self) -> int:
        return sum(mem.engine.prefix_cache_flush()
                   for mem in self.local_members)

    def _count_shed(self, reason: str) -> None:
        tm.SHED_TOTAL.labels(reason=reason).inc()
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1

    def retry_after_s(self) -> float:
        """Fleet-wide Retry-After for shed responses: queue depth over
        the completion rate OBSERVED AT THE ROUTER — every member's
        finishes land in the router tracer's window, so the estimate
        tracks the whole fleet's drain rate (and degrades honestly when
        a replica is ejected) instead of one member's share overstating
        the wait.

        Scaled-to-zero wrinkle: with a tier parked at zero members its
        completion rate is a stale window (or nothing), and a
        Retry-After computed from it tells clients to hammer a fleet
        that first has to WAKE — so when the autoscaler has a tier at
        zero, the estimate adds the wake + spawn time on top of the
        queue estimate."""
        queued = max(1, self.core.total_queued())
        wake = (self.autoscaler.wake_wait_s()
                if self.autoscaler is not None else 0.0)
        window = self.tracer.finish_times
        if window and len(window) >= 2:
            span = window[-1] - window[0]
            if span > 0:
                rate = (len(window) - 1) / span
                return float(min(300.0, wake + max(1.0, queued / rate)))
        return float(min(300.0,
                         wake + min(10.0, max(2.0, float(queued)))))

    # -------------------------------------------------------------- ingress
    def enqueue_request(self, user: str, ip: str, model: str, family=None,
                        prompt_tokens=None, sampling=None,
                        kind: str = "generate",
                        raw_prompt: str = "",
                        context_ids=None, trace_ctx=None) -> Request:
        """Fleet-wide bounded admission + fair-share enqueue. Mirrors
        TorchEngine.enqueue_request; the caps apply to the ROUTER queue
        (members run uncapped — the router already admitted).
        `context_ids` (Ollama `context`) seeds the flight's resume state
        so the first placement already replays in token space. Raises
        TokenIdError for an id outside the model's vocabulary."""
        cfg = self.ecfg
        if not self.accepting:
            self._count_shed("queue_full")
            retry_s = 5.0
            if self.ha is not None:
                # Promotion shed: tell clients when the takeover is
                # EXPECTED to let them in (the measured takeover-cost
                # EMA), not a blind cold-start clamp.
                eta = self.ha.promote_eta_s()
                if eta is not None:
                    retry_s = eta
            self.journal.record(
                "shed", user=user, model=model or None, reason="queue_full",
                queued=self.core.total_queued(), limit=0,
                retry_after_s=round(retry_s, 3),
                n_prompt=len(prompt_tokens or []))
            raise QueueFullError("queue_full", retry_s, 0)
        if cfg.max_queued and self.core.total_queued() >= cfg.max_queued:
            self._count_shed("queue_full")
            retry_s = self.retry_after_s()
            self.journal.record(
                "shed", user=user, model=model or None, reason="queue_full",
                queued=self.core.total_queued(), limit=cfg.max_queued,
                retry_after_s=round(retry_s, 3),
                n_prompt=len(prompt_tokens or []),
                max_tokens=getattr(sampling, "max_tokens", None))
            raise QueueFullError("queue_full", retry_s, cfg.max_queued)
        if (cfg.max_queued_per_user
                and self.core.queue_len(user) >= cfg.max_queued_per_user):
            self._count_shed("user_queue_full")
            retry_s = self.retry_after_s()
            self.journal.record(
                "shed", user=user, model=model or None,
                reason="user_queue_full", queued=self.core.queue_len(user),
                limit=cfg.max_queued_per_user,
                retry_after_s=round(retry_s, 3),
                n_prompt=len(prompt_tokens or []),
                max_tokens=getattr(sampling, "max_tokens", None))
            raise QueueFullError("user_queue_full", retry_s,
                                 cfg.max_queued_per_user)
        if kind == "generate":
            # As the single engine does: an id outside the vocabulary
            # never reaches a member (on the card it would poison the
            # CUDA context that every in-process member shares).
            rt = self.resolve_runtime(model, kind)
            check_token_ids(getattr(rt, "cfg", None)
                            or get_model_config(model), model,
                            prompt=prompt_tokens, context=context_ids)
        with self._pending_lock:
            rid = self.core.enqueue(
                user, ip, model,
                family if family is not None else Family.UNKNOWN, kind=kind)
            req = Request(rid, user, model, prompt_tokens or [], sampling,
                          kind=kind, raw_prompt=raw_prompt)
            if context_ids:
                # Prior-turn ids: widen the budget (max_tokens buys NEW
                # tokens) and dispatch as a token-space resume.
                ctx = [int(t) for t in context_ids]
                sp = copy.copy(req.sampling)  # skip __post_init__ refold
                sp.max_tokens = sp.max_tokens + len(ctx)
                req.sampling = sp
                req.generated_ids = list(ctx)
                req._replay_gen = len(ctx)
            req.trace = self.tracer.begin(rid, user, model, kind=kind,
                                          ctx=trace_ctx)
            flight = _Flight(req, ip, family if family is not None
                             else Family.UNKNOWN)
            if context_ids:
                flight.resume = {"gen_ids": list(req.generated_ids),
                                 "n_gen": len(req.generated_ids),
                                 "inc": None, "detok": "", "emitted": 0,
                                 "text": ""}
            ticket = None
            if self.durability is not None:
                # The tap goes in before the loop can see the flight.
                ticket = self.durability.capture(
                    req, prompt_tokens=prompt_tokens or [])
            self.pending[rid] = flight
        self.journal.record(
            "enqueue", req_id=flight.rid0, user=user, model=model or None,
            n_prompt=len(flight.prompt_tokens),
            queued=self.core.total_queued(), kind_req=kind,
            max_tokens=req.sampling.max_tokens,
            deadline_ms=getattr(req.sampling, "deadline_ms", 0.0) or None)
        if self.durability is not None:
            # Fsync-before-ACK, same contract as the single engine; the
            # router's prompt is already pristine (members fold replay).
            # The gate's full hold (group-commit wait + fsync) is a
            # router hot-path cost: measured always-on.
            t0 = time.perf_counter_ns()
            try:
                self.durability.commit(req, ticket)
            finally:
                tm.ROUTER_OVERHEAD_MS.labels(site="wal_fsync").observe(
                    (time.perf_counter_ns() - t0) / 1e6)
        self.notify()
        return req

    def cancel(self, req_id: int) -> None:
        with self._pending_lock:
            flight = self.pending.get(req_id)
        if flight is not None:
            flight.req.cancelled.set()
            if self.core.cancel(req_id):
                with self._pending_lock:
                    self.pending.pop(req_id, None)
                flight.done = True
                self.journal.record("finish", req_id=flight.rid0,
                                    user=flight.user, reason="cancelled")
                flight.req.finish(FinishReason.CANCELLED)
            self.notify()
            return
        for flight in list(self.flights):
            if flight.req.req_id == req_id and not flight.done:
                flight.req.cancelled.set()
                att, mem = flight.attempt, flight.member
                if att is not None and mem is not None:
                    mem.cancel(att)
                break
        self.notify()

    # ----------------------------------------------------------- main loop
    def _loop(self) -> None:
        while self._running:
            try:
                self._loop_once()
            except Exception:
                # The router thread must never die: a routing bug would
                # park every queued stream forever.
                log.exception("fleet loop iteration failed; continuing")
                time.sleep(0.1)

    def _loop_once(self) -> None:
        self.last_tick_at = time.monotonic()
        self.journal.tick += 1
        self._probe()
        if self.tiers is not None:
            # Balancer tick: retier ONE member toward the observed class
            # mix once the hysteresis clears (no-op most ticks).
            self.tiers.maybe_balance(self)
        if self.autoscaler is not None:
            # Elastic sizing AFTER the balancer: regroup/retire are
            # mutually exclusive, and the scaler parks while any
            # balancer move is in flight.
            self.autoscaler.tick()
        # Drain BEFORE admission: a draining member's migrating streams
        # get first claim on slots other members just freed — fresh
        # placements must not starve the evacuation that unblocks the
        # rolling restart.
        self._drain_progress()
        self._admit()
        did_work = self._pump()
        if not did_work:
            with self._cond:
                self._cond.wait(timeout=0.02)

    # ------------------------------------------------------------ placement
    def _load_of(self, mem) -> int:
        return sum(1 for f in self.flights
                   if f.member is mem and not f.done)

    def _slot_cap(self, mem) -> int:
        cap = mem.slot_cap() if hasattr(mem, "slot_cap") else 0
        return cap or self.ecfg.max_slots

    def _can_place(self, mem, model: str, kind: str) -> bool:
        if mem.state != "healthy":
            return False
        if mem.router_bounded \
                and self._load_of(mem) >= self.ecfg.max_slots:
            return False
        return mem.can_take(model, kind)

    def _eligible_models(self):
        gen_ok, emb_ok = [], []
        for model in self.loaded_models():
            if any(self._can_place(m, model, "generate")
                   for m in self.members):
                gen_ok.append(model)
            if any(self._can_place(m, model, "embed")
                   for m in self.members):
                emb_ok.append(model)
        return gen_ok, emb_ok

    def _choose_member_timed(self, flight: _Flight):
        """The placement decision under the always-on overhead timer:
        every pick (fresh placement, failover re-dispatch, evacuation)
        lands in ollamamq_router_overhead_ms{site="place"} and the
        rolling window behind router_overhead_p99_ms() — the bounded
        number in ROADMAP's 'router overhead measured and bounded'."""
        t0 = time.perf_counter_ns()
        try:
            return self._choose_member(flight)
        finally:
            ms = (time.perf_counter_ns() - t0) / 1e6
            flight.place_ms = ms
            self._place_window.append(ms)
            tm.ROUTER_OVERHEAD_MS.labels(site="place").observe(ms)

    def _choose_member(self, flight: _Flight):
        elig = [m for m in self.members
                if self._can_place(m, flight.model, flight.kind)]
        tinfo = None
        if self.tiers is not None and flight.kind == "generate" and elig:
            # Tier filter FIRST: affinity and least-loaded then operate
            # WITHIN the home tier (plus any journaled overflow targets).
            elig, tinfo = self.tiers.placement_filter(
                flight, elig, self._load_of, self._slot_cap)
        if not elig:
            return None
        # Never fail BACK to the member that just dropped this stream —
        # unless it is the only one left.
        others = [m for m in elig if m.name != flight.failed_from]
        if others:
            elig = others
        if self.placement == "affinity" and flight.kind == "generate" \
                and flight.prompt_tokens:
            scored = [(m.affinity_pages(flight.model, flight.prompt_tokens),
                       m) for m in elig]
            best = max(s for s, _ in scored)
            if best >= 1:
                tm.FLEET_AFFINITY_HITS_TOTAL.inc()
                elig = [m for s, m in scored if s == best]
        # Least-loaded; ties rotate after the previous pick (the
        # reference's last_backend_idx round-robin).
        best_load = min(self._load_of(m) for m in elig)
        ties = [m for m in elig if self._load_of(m) == best_load]
        cand = ties[0]
        n = len(self.members)
        for off in range(1, n + 1):
            c = self.members[(self._rr + off) % n]
            if c in ties:
                self._rr = (self._rr + off) % n
                cand = c
                break
        if tinfo is not None:
            self.tiers.journal_place(flight, cand, tinfo)
        return cand

    def _admit(self) -> int:
        placed = 0
        unplaceable: set = set()  # flights requeued THIS pass (by id)
        while True:
            gen_ok, emb_ok = self._eligible_models()
            if not gen_ok and not emb_ok:
                break
            try:
                item = self.core.next(eligible_models=gen_ok,
                                      eligible_embed=emb_ok)
            except StuckQueue:
                now = time.monotonic()
                if now - self._last_stuck_log > 10.0:
                    self._last_stuck_log = now
                    log.warning(
                        "fleet pick needs a model no healthy replica "
                        "serves (ready: %s; %d queued)", gen_ok,
                        self.core.total_queued())
                break
            if item is None:
                break
            rid, user, model = item
            with self._pending_lock:
                flight = self.pending.pop(rid, None)
            if flight is None:
                continue
            self.journal.record("admit", req_id=flight.rid0, user=user,
                                model=model or None,
                                queued=self.core.total_queued())
            flight.req.trace_event("admit")
            if flight.req.cancelled.is_set() \
                    or self.core.is_user_or_ip_blocked(user):
                self._finish(flight, FinishReason.CANCELLED)
                continue
            if flight.req.expired():
                self._expire(flight)
                continue
            mem = self._choose_member_timed(flight)
            if mem is None:
                # Capacity raced away between the gate and the pick — or
                # the flight's home TIER is full (tier isolation: it
                # waits rather than leaking cross-tier). Wait-in-queue,
                # FIFO preserved; keep admitting OTHER users this pass
                # (a full bulk tier must not park the interactive queue
                # behind it), breaking once the same flight cycles back.
                self._requeue(flight, why="unplaceable")
                if id(flight) in unplaceable:
                    break
                unplaceable.add(id(flight))
                continue
            self._maybe_ship_prefix(flight, mem)
            if self._dispatch(flight, mem):
                placed += 1
        return placed

    def _dispatch(self, flight: _Flight, mem) -> bool:
        try:
            attempt = mem.begin(flight, flight.resume, on_item=self.notify)
        except Exception as e:  # noqa: BLE001
            log.exception("dispatch of req %d to %s failed",
                          flight.rid0, mem.name)
            flight.begin_failures += 1
            if flight.begin_failures > 2:
                self._finish(flight, FinishReason.ERROR,
                             error=f"fleet dispatch failed: {e}")
            else:
                self._requeue(flight, why="dispatch_failed")
            return False
        flight.member = mem
        flight.attempt = attempt
        if flight not in self.flights:
            # A failover re-dispatch happens while the flight is still in
            # the list; a fresh placement appends it.
            self.flights.append(flight)
        replayed = flight.resume.get("n_gen", 0) if flight.resume else 0
        flight.resume = None
        if flight.failed_from is not None:
            self.failover_count += 1
            tm.FLEET_FAILOVERS_TOTAL.inc()
            self.journal.record(
                "replica_failover", req_id=flight.rid0, user=flight.user,
                model=flight.model or None, replica=flight.failed_from,
                to_replica=mem.name, replayed_tokens=replayed)
            flight.req.trace_event("failover", src=flight.failed_from,
                                   dst=mem.name, replayed=replayed)
            log.warning("req %d failed over %s -> %s (%d token(s) replayed)",
                        flight.rid0, flight.failed_from, mem.name, replayed)
            flight.failed_from = None
        overhead = (round(flight.place_ms, 4)
                    if flight.place_ms is not None else None)
        self.journal.record("place", req_id=flight.rid0, user=flight.user,
                            model=flight.model or None, runtime=mem.name,
                            overhead_ms=overhead)
        flight.req.trace_event("place", runtime=mem.name,
                               overhead_ms=overhead)
        if not flight.req.started:
            self.core.mark_started(flight.user)
            flight.req.started = True
        return True

    def _requeue(self, flight: _Flight, why: str) -> None:
        try:
            with self._pending_lock:
                rid = self.core.requeue_front(flight.user, "", flight.model,
                                              flight.family,
                                              kind=flight.kind)
                flight.req.req_id = rid
                self.pending[rid] = flight
            flight.req.trace_event("requeue")
            self.journal.record("requeue", req_id=flight.rid0,
                                user=flight.user, why=why)
        except BlockedError:
            self._finish(flight, FinishReason.CANCELLED)

    # --------------------------------------------------------------- pumping
    def _pump(self) -> bool:
        did = False
        for flight in list(self.flights):
            if flight.done:
                continue
            if flight.req.cancelled.is_set():
                self._cancel_flight(flight)
                did = True
                continue
            if flight.evac_since is not None:
                if self._evac_step(flight):
                    did = True
                continue
            if self._forward(flight):
                did = True
        if any(f.done or f.member is None for f in self.flights):
            self.flights = [f for f in self.flights
                            if not f.done and f.member is not None]
        return did

    def _forward(self, flight: _Flight) -> bool:
        att = flight.attempt
        if flight.req.stream.overflowed:
            # Consumer stopped draining and the client stream filled: the
            # engine-side convention is client-gone (dispatcher.rs's
            # failed channel send) — cancel rather than buffer forever.
            flight.req.cancelled.set()
            self._cancel_flight(flight)
            return True
        did = False
        while (item := att.req.stream.get_nowait()) is not None:
            did = True
            if item.kind == "token":
                self._forward_token(flight, item)
            else:
                self._finish_from_item(flight, item)
                return True
        if att.transport_dead and flight.evac_since is None:
            # The member's HTTP stream died under this one request while
            # the member itself still looks healthy: try to migrate just
            # this stream (the member may still serve /admin/migrate),
            # else fail it over via recompute replay.
            if self._try_migrate(flight, flight.member,
                                 why="transport") != "migrated":
                self._begin_evac(flight)
            did = True
        return did

    def _forward_token(self, flight: _Flight, item) -> None:
        if not item.text and item.token_id < 0:
            return
        if item.text and not flight.req.stats.first_token_at:
            flight.req.stats.first_token_at = time.monotonic()
            flight.req.trace_event(
                "first_token", ttft_ms=round(flight.req.stats.ttft_ms, 3))
            if self.tiers is not None and flight.tier is not None:
                # Feed the per-tier burn-rate engine: TTFT is recorded
                # against the stream's HOME tier — the tier whose SLO
                # the placement policy is protecting.
                self.tiers.record_ttft(flight.tier,
                                       flight.req.stats.ttft_ms)
            elif self.autoscaler is not None:
                # Untiered elastic fleet: the scaler's own objective is
                # the burn signal the tier engine would otherwise give.
                self.autoscaler.record_ttft(flight.req.stats.ttft_ms)
        # Empty-text items still forward: they carry the sampled token
        # ids the NDJSON writer folds into the next written frame.
        flight.req.stream.push(item)

    def _finish_from_item(self, flight: _Flight, item) -> None:
        reason = item.finish_reason or (
            FinishReason.ERROR if item.kind == "error" else FinishReason.STOP)
        tokens = flight.attempt.tokens_done()
        if flight.kind == "embed":
            flight.req.embedding = flight.attempt.embedding()
        flight.req.stats.completion_tokens = tokens
        self._finish(flight, reason, error=item.error, tokens=tokens)

    def _finish(self, flight: _Flight, reason: FinishReason,
                error: str = "", tokens: int = 0) -> None:
        if flight.done:
            return
        flight.done = True
        if reason in (FinishReason.STOP, FinishReason.LENGTH):
            self.core.mark_done(flight.user, tokens=tokens)
        else:
            self.core.mark_dropped(flight.user, started=flight.req.started)
        self.journal.record("finish", req_id=flight.rid0, user=flight.user,
                            model=flight.model or None, reason=reason.value,
                            tokens=tokens)
        flight.req.finish(reason, error=error)

    def _expire(self, flight: _Flight) -> None:
        slack_ms = 0.0
        if flight.req.deadline is not None:
            slack_ms = (time.monotonic() - flight.req.deadline) * 1e3
        tm.DEADLINE_DROPS_TOTAL.labels(model=flight.model or "?").inc()
        self._count_shed("deadline")
        self.journal.record("deadline_drop", req_id=flight.rid0,
                            user=flight.user, model=flight.model or None,
                            slack_ms=round(slack_ms, 1))
        flight.done = True
        self.core.mark_dropped(flight.user, started=flight.req.started)
        flight.req.finish(
            FinishReason.DEADLINE,
            error=f"deadline expired {slack_ms:.0f}ms ago (fleet re-dispatch)")

    def _cancel_flight(self, flight: _Flight) -> None:
        att, mem = flight.attempt, flight.member
        if att is not None and mem is not None and not att.closed:
            mem.cancel(att)
        self._finish(flight, FinishReason.CANCELLED)

    # ------------------------------------------------------------- migration
    def _choose_migration_target(self, flight: _Flight, source):
        """Healthy member to receive a shipped stream: least-loaded
        among those that can take the model and speak import. Tiered
        fleets prefer the victim's HOME tier — an evacuated stream
        lands back in-tier, not just least-loaded fleet-wide — and
        only fall cross-tier (journaled by the caller) when the tier
        has no import-capable capacity."""
        elig = [m for m in self.members
                if m is not source
                and getattr(m, "import_stream", None) is not None
                and self._can_place(m, flight.model, "generate")]
        if not elig:
            return None
        if self.tiers is not None and flight.tier is not None:
            same = [m for m in elig
                    if getattr(m, "tier", None) == flight.tier]
            if same:
                elig = same
        return min(elig, key=self._load_of)

    def _try_migrate(self, flight: _Flight, source, why: str) -> str:
        """Two-phase KV handoff of one live stream off `source`: export
        (snapshot + park the source slot), ship, import (the target's
        ack), then commit the source release. Journaled at every phase
        under the stream's stable rid0 so the no-dropped-streams audit
        can pair each export with its import or abort.

        Returns "migrated" (the stream now lives on the target),
        "intact" (nothing was exported — the source stream is untouched
        and may keep serving), or "aborted" (the export happened but the
        transfer failed: the parked source state is RELEASED, so the
        caller MUST recover the stream via the recompute replay —
        migration is an optimization, recompute is the guarantee)."""
        if not self.migrate or flight.kind != "generate":
            return "intact"
        att = flight.attempt
        if att is None or att.closed \
                or getattr(source, "export_stream", None) is None:
            return "intact"
        # Target first: exporting detaches the source slot, so never
        # start a handoff nobody can receive (a full fleet would turn
        # every drain attempt into a pointless abort+recompute).
        if self._choose_migration_target(flight, source) is None:
            return "intact"
        deadline = time.monotonic() + self.migrate_timeout_s
        t_export = time.perf_counter_ns()
        try:
            blob = source.export_stream(att, deadline)
        except Exception:  # noqa: BLE001 — unexportable => recompute
            log.exception("migration export of req %d from %s failed",
                          flight.rid0, source.name)
            blob = None
        export_ms = (time.perf_counter_ns() - t_export) / 1e6
        tm.ROUTER_OVERHEAD_MS.labels(site="migrate_export").observe(
            export_ms)
        if blob is None:
            return "intact"
        nbytes = kvc.migration_blob_bytes(blob)
        state = blob.get("request") or {}
        n_gen = len(state.get("generated_ids") or ())
        self.journal.record(
            "migrate_export", req_id=flight.rid0, user=flight.user,
            model=flight.model or None, replica=source.name,
            tokens=n_gen, kv_len=blob.get("kv_len"),
            pages=blob.get("n_pages"), bytes=nbytes,
            overhead_ms=round(export_ms, 4))
        t_ship = time.perf_counter_ns()
        abort_why = None
        # Fault site "migrate": chaos kills the transfer at every phase
        # of the handoff — mid-flight failure, a stall past the budget,
        # source death after export.
        if self.fault_plan is not None:
            try:
                fired = self.fault_plan.draw("migrate")
            except Exception:  # noqa: BLE001
                log.exception("fault-plan draw failed")
                fired = []
            for kind, rule in fired:
                if kind == "exception":
                    abort_why = "fault_injected"
                elif kind == "slow" and rule is not None:
                    time.sleep(rule.delay_s)
                elif kind == "device_loss":
                    source.crash()  # source dies after export
        if abort_why is None and time.monotonic() > deadline:
            abort_why = "timeout"
        target = None
        if abort_why is None:
            target = self._choose_migration_target(flight, source)
            if target is None:
                abort_why = "no_target"
        tm.ROUTER_OVERHEAD_MS.labels(site="migrate_ship").observe(
            (time.perf_counter_ns() - t_ship) / 1e6)
        new_att = None
        import_ms = 0.0
        if abort_why is None:
            t_import = time.perf_counter_ns()
            try:
                new_att = target.import_stream(blob, flight,
                                               on_item=self.notify)
            except Exception as e:  # noqa: BLE001
                log.warning("migration import of req %d on %s failed: %s",
                            flight.rid0, target.name, e)
                abort_why = "import_failed"
            import_ms = (time.perf_counter_ns() - t_import) / 1e6
            tm.ROUTER_OVERHEAD_MS.labels(site="migrate_import").observe(
                import_ms)
        if abort_why is not None:
            try:
                source.resolve_export(att, commit=False, why=abort_why)
            except Exception:  # noqa: BLE001 — dead source resolves itself
                pass
            self.migrate_abort_count += 1
            tm.FLEET_MIGRATIONS_TOTAL.labels(outcome="aborted").inc()
            self.journal.record(
                "migrate_abort", req_id=flight.rid0, user=flight.user,
                model=flight.model or None, replica=source.name,
                to_replica=target.name if target is not None else None,
                why=abort_why)
            log.warning("req %d migration off %s aborted (%s); falling "
                        "back to recompute", flight.rid0, source.name,
                        abort_why)
            return "aborted"
        # Import acked: release the parked source copy; the stream now
        # lives on the target with zero recomputed tokens.
        try:
            source.resolve_export(att, commit=True)
        except Exception:  # noqa: BLE001 — a dead source's parked state
            pass  # dies with it; the import already owns the stream
        # Flush the OLD attempt before swapping: the export froze the
        # source, but its last pre-freeze tokens may still be in flight
        # (an HTTP reader mid-socket). The commit just terminated the
        # member-side stream, so drain until that terminal (the handoff
        # ack, never client output) — only then does the target's
        # continuation forward, keeping the client stream ordered.
        flush_deadline = time.monotonic() + max(1.0,
                                                self.migrate_timeout_s)
        while time.monotonic() < flush_deadline:
            item = att.req.stream.get_nowait()
            if item is None:
                if att.thread is None or att.reader_dead():
                    break  # local attempt / dead reader: nothing more
                time.sleep(0.002)
                continue
            if item.kind == "token":
                self._forward_token(flight, item)
            else:
                break  # the commit's cancelled ack
        att.closed = True
        flight.member = target
        flight.attempt = new_att
        flight.resume = None
        flight.failed_from = None
        flight.evac_since = None
        self.migration_count += 1
        tm.FLEET_MIGRATIONS_TOTAL.labels(outcome="migrated").inc()
        tm.FLEET_MIGRATE_BYTES_TOTAL.inc(nbytes)
        if self.tiers is not None:
            # A migration that had to land cross-tier (home tier full)
            # is still an overflow — journaled, never silent.
            self.tiers.journal_failover_overflow(flight, target)
        self.journal.record(
            "migrate_import", req_id=flight.rid0, user=flight.user,
            model=flight.model or None, replica=source.name,
            to_replica=target.name, tokens=n_gen,
            pages=blob.get("n_pages"), bytes=nbytes,
            overhead_ms=round(import_ms, 4))
        self.journal.record("place", req_id=flight.rid0, user=flight.user,
                            model=flight.model or None,
                            runtime=target.name)
        flight.req.trace_event("migrate", src=source.name,
                               dst=target.name, why=why)
        if why == "retier":
            # A regroup's drain evacuated this stream: its trace says so
            # explicitly (the router-span vocabulary's "regroup" row).
            flight.req.trace_event("regroup", src=source.name,
                                   dst=target.name,
                                   to_tier=getattr(source, "retier_to",
                                                   None))
        log.warning("req %d migrated %s -> %s (%s): %d token(s) shipped, "
                    "0 recomputed", flight.rid0, source.name, target.name,
                    why, n_gen)
        return "migrated"

    def _maybe_ship_prefix(self, flight: _Flight, target) -> None:
        """Affinity miss with the cache elsewhere: ship the cached
        prefix pages TO the chosen member instead of routing around it,
        so the admission that follows prefills only the tail. Best
        effort — any failure just means a cold prefill."""
        if not self.migrate or self.placement != "affinity":
            return
        if flight.kind != "generate" or not flight.prompt_tokens:
            return
        if getattr(target, "import_prefix", None) is None:
            return
        try:
            if target.affinity_pages(flight.model,
                                     flight.prompt_tokens) > 0:
                return  # the chosen member already holds a prefix
            best, best_pages = None, 0
            for mem in self.members:
                if mem is target or mem.state == "ejected" \
                        or not mem.alive() \
                        or getattr(mem, "export_prefix", None) is None:
                    continue
                pages = mem.affinity_pages(flight.model,
                                           flight.prompt_tokens)
                if pages > best_pages:
                    best, best_pages = mem, pages
            if best is None:
                return
            blob = best.export_prefix(flight.model, flight.prompt_tokens)
            if blob is None:
                return
            adopted = target.import_prefix(flight.model, blob)
        except Exception:  # noqa: BLE001 — a cold prefill, not an error
            log.exception("prefix shipping for req %d failed",
                          flight.rid0)
            return
        if not adopted:
            return
        nbytes = kvc.migration_blob_bytes(blob)
        tm.FLEET_MIGRATIONS_TOTAL.labels(outcome="prefix").inc()
        tm.FLEET_MIGRATE_BYTES_TOTAL.inc(nbytes)
        self.journal.record(
            "migrate_import", req_id=flight.rid0, user=flight.user,
            model=flight.model or None, what="prefix",
            replica=best.name, to_replica=target.name,
            pages=adopted, bytes=nbytes)

    # -------------------------------------------------------------- failover
    def _begin_evac(self, flight: _Flight) -> None:
        now = time.monotonic()
        flight.evac_since = now
        flight.evac_deadline = now + self.evac_grace_s
        if flight.attempt is not None and flight.member is not None:
            flight.member.cancel(flight.attempt)

    def _evac_step(self, flight: _Flight) -> bool:
        """One evacuation tick: keep forwarding whatever valid output the
        dying member produced, then — once the member acked the eviction,
        its loop/reader is dead, or the grace expired — replay the stream
        (prompt + every emitted token) on a healthy replica."""
        att = flight.attempt
        did = False
        while (item := att.req.stream.get_nowait()) is not None:
            did = True
            if item.kind == "token":
                self._forward_token(flight, item)
                continue
            if item.finish_reason == FinishReason.CANCELLED:
                att.acked = True  # our eviction bounced back, as designed
            else:
                # A genuine terminal raced the eviction: the stream is
                # complete — deliver it, nothing to fail over.
                self._finish_from_item(flight, item)
                return True
        mem = flight.member
        ready = (att.acked or not mem.alive() or att.reader_dead()
                 or time.monotonic() >= flight.evac_deadline)
        if not ready:
            return did
        if flight.req.cancelled.is_set():
            self._finish(flight, FinishReason.CANCELLED)
            return True
        if flight.req.expired():
            self._expire(flight)
            return True
        flight.resume = att.resume_state()
        flight.failed_from = mem.name
        flight.evac_since = None
        flight.member = None
        flight.attempt = None
        target = self._choose_member_timed(flight)
        if target is not None:
            self._dispatch(flight, target)
        else:
            # No healthy capacity right now: back to the FRONT of the
            # router queue; the replica_failover record lands when the
            # stream is re-placed.
            self._requeue(flight, why="replica_down")
        return True

    # --------------------------------------------------------------- health
    def _probe(self) -> None:
        now = time.monotonic()
        if now - self._last_probe < self.probe_period_s:
            return
        self._last_probe = now
        for mem in list(self.members):
            plan_holds_down = self._draw_faults(mem)
            self._draw_preempt(mem)
            if mem.state == "healthy":
                age = mem.heartbeat_age()
                fatal = mem.fatal_alerts()
                if not mem.alive():
                    self._eject(mem, "crash", age)
                elif age > self.eject_heartbeat_s:
                    self._eject(mem, "stale_heartbeat", age)
                elif fatal:
                    self._eject(mem, f"alert:{fatal[0]}", age)
            elif mem.state == "ejected" and now >= mem.next_probe_at:
                self._reprobe(mem, plan_holds_down)
            self._mirror_alerts(mem)
        self._update_gauges()

    def _draw_faults(self, mem) -> bool:
        """Evaluate the "replica" fault site for this member's probe slot
        (members are probed in order, so the per-site call counter
        indexes (sweep, member) deterministically). Returns True while a
        device_loss rule holds this member down."""
        if self.fault_plan is None:
            return False
        try:
            fired = self.fault_plan.draw("replica")
        except Exception:  # noqa: BLE001
            log.exception("fault-plan draw failed")
            return False
        holds = False
        for kind, rule in fired:
            if kind == "device_loss" and rule is None:
                # A previously drawn device_loss is still unhealed.
                holds = mem.name in self._plan_down
            elif kind == "device_loss":
                self._plan_down.add(mem.name)
                mem.crash()
                holds = True
            elif kind == "exception":
                mem.crash()
            elif kind == "slow":
                mem.force_stale(rule.delay_s)
        return holds

    def _draw_preempt(self, mem) -> None:
        """Evaluate the "preempt" fault site for this member's probe
        slot — the chaos seam for spot reclamation. A fired rule serves
        the member a termination notice: "exception" with the default
        (drain-timeout) window, "slow" with the rule's delay_s as the
        notice window. Fires on non-preemptible members are ignored —
        the plan indexes (sweep, member) over the whole roster."""
        if self.fault_plan is None:
            return
        try:
            fired = self.fault_plan.draw("preempt")
        except Exception:  # noqa: BLE001
            log.exception("fault-plan draw failed")
            return
        for kind, rule in fired:
            if kind not in ("exception", "slow"):
                continue
            if not getattr(mem, "preemptible", False) \
                    or getattr(mem, "retiring", False) \
                    or mem.state == "ejected":
                continue
            notice = rule.delay_s if kind == "slow" else None
            try:
                self.preempt_replica(mem.name, notice_s=notice)
            except (KeyError, ValueError, RuntimeError) as e:
                log.warning("planned preemption of %s skipped: %s",
                            mem.name, e)

    def _eject(self, mem, why: str, age: float) -> None:
        victims = [f for f in self.flights
                   if f.member is mem and not f.done
                   and f.evac_since is None]
        mem.state = "ejected"
        mem.eject_count += 1
        mem.backoff_s = self.reprobe_backoff_s
        mem.next_probe_at = time.monotonic() + mem.backoff_s
        if mem.retier_to is not None:
            # A crash mid-retier aborts the regroup: the member keeps
            # (and later rejoins) its ORIGINAL tier; its streams ride
            # the normal eject ladder below (migrate -> recompute ->
            # never drop).
            self._abort_retier(mem, f"eject:{why}")
        if getattr(mem, "retiring", False):
            # A crash mid-retire aborts the retire: the member heals
            # through the normal re-probe path and stays in rotation;
            # the scaler re-decides from live signals.
            self._abort_retire(mem, f"eject:{why}")
        self.journal.record(
            "replica_eject", replica=mem.name, why=why,
            victims=len(victims),
            heartbeat_age_s=round(age, 2) if age != float("inf") else None,
            backoff_s=mem.backoff_s)
        log.error("replica %s is now OFFLINE (%s); %d in-flight stream(s) "
                  "failing over", mem.name, why, len(victims))
        for flight in victims:
            # Migration first: a crashed member's loop is dead but its
            # KV pool and slot tables are frozen in place — exporting
            # them beats re-deriving every emitted token. Fallback is
            # the recompute evacuation (mandatory after an aborted
            # handoff: the parked source state is gone).
            if self._try_migrate(flight, mem, why="eject") == "migrated":
                continue
            self._begin_evac(flight)
        self._update_gauges()

    def _reprobe(self, mem, plan_holds_down: bool) -> None:
        now = time.monotonic()
        if plan_holds_down:
            ok = False
        else:
            if not mem.alive():
                try:
                    mem.restart()
                except Exception:  # noqa: BLE001
                    log.exception("restart of member %s failed", mem.name)
            ok = (mem.alive()
                  and mem.heartbeat_age() <= self.eject_heartbeat_s
                  and not mem.fatal_alerts())
        if ok:
            mem.state = "healthy"
            mem.backoff_s = self.reprobe_backoff_s
            self._plan_down.discard(mem.name)
            self.journal.record("replica_join", replica=mem.name, why="heal")
            log.warning("replica %s is back ONLINE (healed); rejoining "
                        "rotation", mem.name)
        else:
            mem.backoff_s = min(REPROBE_BACKOFF_MAX_S, mem.backoff_s * 2
                                or self.reprobe_backoff_s)
            mem.next_probe_at = now + mem.backoff_s

    def _mirror_alerts(self, mem) -> None:
        """Surface each member's firing alerts in the router's alert
        table as `<member>:<alert>` rows, so one /health read shows the
        whole fleet's degradation picture."""
        try:
            current = {name: sev for name, sev in mem.active_alerts()
                       if name}
        except Exception:  # noqa: BLE001
            current = {}
        prev = self._mirrored.get(mem.name, set())
        for name, sev in current.items():
            self.alerts.fire(f"{mem.name}:{name}", sev or "warn",
                             f"replica {mem.name} alert: {name}",
                             source="fleet")
        for name in prev - set(current):
            self.alerts.resolve(f"{mem.name}:{name}")
        self._mirrored[mem.name] = set(current)

    def _update_gauges(self) -> None:
        counts = {"healthy": 0, "ejected": 0, "draining": 0}
        for mem in self.members:
            counts[mem.state] = counts.get(mem.state, 0) + 1
        for state, n in counts.items():
            tm.FLEET_REPLICAS.labels(state=state).set(n)
        if self.tiers is not None:
            self.tiers.update_gauges()

    # ---------------------------------------------------------------- drain
    def _member(self, name: str):
        for mem in self.members:
            if mem.name == name:
                return mem
        return None

    def drain_replica(self, name: str,
                      timeout_s: Optional[float] = None) -> dict:
        """Quiesce one member: no new placements; in-flight streams run
        to completion (stragglers past the timeout fail over); then
        hot-restart and rejoin. Callable from any thread (HTTP admin)."""
        mem = self._member(name)
        if mem is None:
            raise KeyError(f"no replica named {name!r} "
                           f"(members: {[m.name for m in self.members]})")
        if mem.state == "ejected":
            raise RuntimeError(
                f"replica {name} is ejected; drain applies to serving "
                "replicas (it will rejoin via the health re-probe)")
        inflight = self._load_of(mem)
        if mem.state != "draining":
            self._start_drain(mem, timeout_s)
        return {"replica": mem.name, "state": mem.state,
                "inflight": inflight}

    def _start_drain(self, mem, timeout_s: Optional[float]) -> None:
        now = time.monotonic()
        inflight = self._load_of(mem)
        mem.state = "draining"
        mem.drain_started_at = now
        mem.drain_deadline = now + (timeout_s if timeout_s is not None
                                    else self.drain_timeout_s)
        self.journal.record(
            "replica_drain", replica=mem.name, inflight=inflight,
            timeout_s=round(mem.drain_deadline - now, 1))
        log.warning("replica %s draining: %d in-flight stream(s) "
                    "running to completion, no new placements",
                    mem.name, inflight)
        self._update_gauges()
        self.notify()

    # ------------------------------------------------------------- retiring
    def retire_replica(self, name: str, why: str = "manual",
                       timeout_s: Optional[float] = None,
                       burn: Optional[float] = None,
                       queued: Optional[int] = None) -> dict:
        """Permanently remove one member: drain (no new placements),
        migrate its live streams off, then drop it from the roster and
        tear it down — NEVER a kill. The autoscaler's scale-down and
        spot preemption both land here; callable from any thread (HTTP
        admin). Journaled as a paired scale_down start -> done/aborted
        regardless of who asked, so the journal checker audits every
        retire with one vocabulary."""
        mem = self._member(name)
        if mem is None:
            raise KeyError(f"no replica named {name!r} "
                           f"(members: {[m.name for m in self.members]})")
        if mem.state == "ejected":
            raise RuntimeError(
                f"replica {name} is ejected; retire applies to serving "
                "replicas (eject it from the config instead)")
        if getattr(mem, "retiring", False):
            raise RuntimeError(f"replica {name} is already retiring")
        if mem.retier_to is not None:
            raise RuntimeError(f"replica {name} is mid-regroup; retire "
                               "after the regroup settles")
        serving = [m for m in self.members
                   if m.state != "ejected"
                   and not getattr(m, "retiring", False)]
        if len(serving) <= 1:
            raise RuntimeError(
                f"replica {name} is the fleet's last serving member; "
                "a retire must never empty the fleet")
        inflight = self._load_of(mem)
        mem.retiring = True
        mem.retire_why = why
        self.journal.record(
            "scale_down", replica=mem.name, phase="start",
            tier=getattr(mem, "tier", None), why=why,
            burn=burn, queued=queued, inflight=inflight,
            fleet=len(self.members))
        log.warning("replica %s retiring (%s): draining, %d in-flight "
                    "stream(s) migrate off, then it leaves the fleet",
                    mem.name, why, inflight)
        if mem.state != "draining":
            self._start_drain(mem, timeout_s)
        return {"replica": mem.name, "state": mem.state, "why": why,
                "inflight": inflight}

    def preempt_replica(self, name: str,
                        notice_s: Optional[float] = None) -> dict:
        """Termination notice for a preemptible member — the spot-
        reclamation path (POST /admin/preempt/{replica}, or the fault
        plan's "preempt" site). Migrate-off-then-retire within the
        notice window; past the deadline the stragglers fail over via
        the drain-timeout ladder. Either way: zero dropped streams."""
        mem = self._member(name)
        if mem is None:
            raise KeyError(f"no replica named {name!r} "
                           f"(members: {[m.name for m in self.members]})")
        if not getattr(mem, "preemptible", False):
            raise ValueError(
                f"replica {name} is not preemptible (flag members with "
                "--preemptible)")
        notice = float(notice_s) if notice_s else self.drain_timeout_s
        self.journal.record(
            "preempt_notice", replica=mem.name,
            tier=getattr(mem, "tier", None),
            notice_s=round(notice, 1), inflight=self._load_of(mem))
        tm.FLEET_PREEMPTIONS_TOTAL.inc()
        log.warning("replica %s served a termination notice (%.1fs "
                    "window)", mem.name, notice)
        return self.retire_replica(name, why="preempt", timeout_s=notice)

    def _abort_retire(self, mem, why: str) -> None:
        """A retire died before the member left the roster (crash mid-
        drain): journal the abort; the member stays in rotation and
        heals through the normal re-probe path."""
        mem.retiring = False
        mem.retire_why = None
        self.journal.record(
            "scale_down", replica=mem.name, phase="aborted",
            tier=getattr(mem, "tier", None), why=why,
            fleet=len(self.members))
        if self.autoscaler is not None:
            # note_scale_event owns the metric + the storm/cooldown
            # bookkeeping when a scaler is running.
            self.autoscaler.note_scale_event("down", "aborted")
        else:
            tm.FLEET_SCALE_EVENTS_TOTAL.labels(direction="down",
                                               outcome="aborted").inc()
        log.error("replica %s retire ABORTED (%s); member stays in "
                  "rotation", mem.name, why)

    def _complete_retire(self, mem) -> None:
        """Retire drain emptied: the member leaves the roster and its
        provisioner (or stop()) tears it down. Scale-to-zero lands
        here too — when the autoscaler removes a tier's last member the
        tier is marked parked, so its queued work HOLDS at the router
        (the wake signal) instead of spilling cross-tier."""
        why = getattr(mem, "retire_why", None) or "manual"
        self.members = [m for m in self.members if m is not mem]
        if self.tiers is not None:
            # Deliberate zero only under an autoscaler that can wake
            # the tier back up; a manual retire emptying a tier falls
            # back to the cross-tier spill path.
            self.tiers.note_member_removed(
                mem, to_zero=self.autoscaler is not None)
        try:
            if getattr(mem, "provisioned_by", None) is not None:
                mem.provisioned_by.retire(mem)
            else:
                mem.stop()
        except Exception:  # noqa: BLE001
            log.exception("teardown of retired member %s failed",
                          mem.name)
        mem.retiring = False
        self.journal.record(
            "scale_down", replica=mem.name, phase="done",
            tier=getattr(mem, "tier", None), why=why,
            fleet=len(self.members))
        if self.autoscaler is not None:
            self.autoscaler.note_scale_event("down", "done")
        else:
            tm.FLEET_SCALE_EVENTS_TOTAL.labels(direction="down",
                                               outcome="done").inc()
        log.warning("replica %s retired (%s); fleet -> %d member(s)",
                    mem.name, why, len(self.members))
        self._update_gauges()
    # ----------------------------------------------------------- regrouping
    def retier_replica(self, name: str, tier: str,
                       timeout_s: Optional[float] = None,
                       why: str = "manual") -> dict:
        """Move one member to the other tier: drain, migrate its
        live streams off, hot-restart at the target tier's TP
        width (LocalMember with a factory) or re-label (HttpMember),
        rejoin. Callable from any thread (HTTP admin) and from the
        TierBalancer. The tier label commits only when the restart
        succeeds — any abort leaves the member in its ORIGINAL tier."""
        from ollamamq_tpu_torch.config import TIER_NAMES

        if self.tiers is None:
            raise RuntimeError("fleet is untiered (--tiers not set); "
                               "retier applies to tiered fleets")
        mem = self._member(name)
        if mem is None:
            raise KeyError(f"no replica named {name!r} "
                           f"(members: {[m.name for m in self.members]})")
        if tier not in TIER_NAMES:
            raise ValueError(f"unknown tier {tier!r} "
                             f"(tiers: {TIER_NAMES})")
        if mem.tier == tier:
            raise RuntimeError(f"replica {name} is already in tier "
                               f"{tier!r}")
        if mem.state == "ejected":
            raise RuntimeError(
                f"replica {name} is ejected; it must heal before it can "
                "change tiers")
        if mem.retier_to is not None or any(
                m.retier_to is not None for m in self.members):
            raise RuntimeError("a tier regroup is already in flight; "
                               "one member moves at a time")
        donors = [m for m in self.members
                  if getattr(m, "tier", None) == mem.tier
                  and m.state != "ejected"]
        if len(donors) <= 1:
            raise RuntimeError(
                f"replica {name} is tier {mem.tier!r}'s last serving "
                "member; a regroup must never empty a tier")
        self.journal.record(
            "tier_regroup", replica=mem.name, phase="start",
            from_tier=mem.tier, to_tier=tier, why=why,
            mix=(round(self.tiers.mix_ema, 4)
                 if self.tiers.mix_ema is not None else None),
            tp_from=getattr(mem, "tp", None),
            tp_to=self.tiers.widths.get(tier))
        log.warning("replica %s regrouping %s -> %s (%s): draining, "
                    "live streams migrate off, restart at the target "
                    "width", mem.name, mem.tier, tier, why)
        mem.retier_to = tier
        if mem.state != "draining":
            self._start_drain(mem, timeout_s)
        return {"replica": mem.name, "state": mem.state,
                "from_tier": mem.tier, "to_tier": tier}

    def _abort_retier(self, mem, why: str) -> None:
        """A regroup died before its restart committed: journal the
        abort; the member keeps its ORIGINAL tier (and rejoins it when
        it heals)."""
        target = mem.retier_to
        mem.retier_to = None
        self.journal.record(
            "tier_regroup", replica=mem.name, phase="aborted",
            from_tier=mem.tier, to_tier=target, why=why)
        self.tiers.note_regroup("aborted")
        log.error("replica %s regroup %s -> %s ABORTED (%s); member "
                  "keeps tier %s", mem.name, mem.tier, target, why,
                  mem.tier)

    def _complete_retier(self, mem) -> None:
        """Drain emptied under a pending retier: restart the member at
        the target tier's width and commit the label. The "replica"
        fault site is drawn here too — chaos can crash the member
        mid-retier, which aborts the regroup (original tier) and rides
        the normal eject/heal path; its streams already migrated off
        during the drain, so nothing can drop."""
        target = mem.retier_to
        if self.fault_plan is not None:
            try:
                fired = self.fault_plan.draw("replica")
            except Exception:  # noqa: BLE001
                log.exception("fault-plan draw failed")
                fired = []
            for kind, rule in fired:
                if kind == "device_loss" and rule is not None:
                    self._plan_down.add(mem.name)
                if kind in ("exception", "device_loss"):
                    mem.crash()
                    self._eject(mem, "crash_mid_retier",
                                mem.heartbeat_age())
                    return  # _eject aborted the regroup
                if kind == "slow" and rule is not None:
                    mem.force_stale(rule.delay_s)
        try:
            tp = mem.retier(self.tiers.widths.get(target))
        except Exception:  # noqa: BLE001 — old-width engine restarted
            log.exception("retier restart of %s at tier %s width failed",
                          mem.name, target)
            self._abort_retier(mem, "restart_failed")
            if mem.alive():
                mem.state = "healthy"
                self._update_gauges()
            else:
                # The old engine did not start again either: out of
                # rotation until a re-probe's restart brings it back.
                self._eject(mem, "restart_failed", mem.heartbeat_age())
            return
        from_tier = mem.tier
        mem.tier = target
        mem.retier_to = None
        mem.state = "healthy"
        self.journal.record(
            "tier_regroup", replica=mem.name, phase="done",
            from_tier=from_tier, to_tier=target,
            mix=(round(self.tiers.mix_ema, 4)
                 if self.tiers.mix_ema is not None else None),
            tp_to=tp)
        self.journal.record("replica_join", replica=mem.name,
                            why="retier")
        self.tiers.note_regroup("done")
        log.warning("replica %s regrouped -> tier %s (tp %s); back in "
                    "rotation", mem.name, target, tp)
        self._update_gauges()

    def _drain_progress(self) -> None:
        now = time.monotonic()
        # Copy: _complete_retire removes the member from the roster
        # mid-iteration.
        for mem in list(self.members):
            if mem.state != "draining":
                continue
            active = [f for f in self.flights
                      if f.member is mem and not f.done]
            # Migrate the live streams OFF the draining member instead
            # of running them out: the drain finishes as fast as the
            # transfers, and stragglers stop being a timeout problem.
            # "intact" outcomes (mid-prefill work, no target capacity)
            # keep serving on the draining member and retry next sweep;
            # an ABORTED handoff released the source state, so that
            # stream must evacuate (recompute replay) right now.
            for flight in active:
                if flight.evac_since is None and not flight.migrate_tried:
                    out = self._try_migrate(
                        flight, mem,
                        why=("retier" if mem.retier_to is not None
                             else "drain"))
                    if out == "aborted":
                        self._begin_evac(flight)
                    # Only a hard outcome consumes the attempt; capacity
                    # may free up before the drain deadline.
                    if out != "intact":
                        flight.migrate_tried = True
            active = [f for f in self.flights
                      if f.member is mem and not f.done]
            if not active:
                if getattr(mem, "retiring", False):
                    # Retire drain emptied: the member leaves the
                    # fleet for good (scale-down / preemption).
                    self._complete_retire(mem)
                    continue
                if mem.retier_to is not None:
                    # Regroup drain emptied: restart at the target
                    # tier's width and commit (or abort) the move.
                    self._complete_retier(mem)
                    continue
                try:
                    mem.hot_restart()
                except Exception:  # noqa: BLE001
                    log.exception("hot-restart of %s failed", mem.name)
                    if not mem.alive():
                        self._eject(mem, "restart_failed",
                                    mem.heartbeat_age())
                        continue
                mem.state = "healthy"
                self.journal.record("replica_join", replica=mem.name,
                                    why="drain_complete")
                log.warning("replica %s drained: hot-restarted and back "
                            "in rotation", mem.name)
                self._update_gauges()
            elif now > mem.drain_deadline:
                # Drain timeout: the stragglers fail over rather than
                # holding the restart hostage — still zero dropped
                # streams.
                for flight in active:
                    if flight.evac_since is None:
                        self._begin_evac(flight)

    # ------------------------------------------------- fleet observability
    def router_overhead_p99_ms(self) -> Optional[float]:
        """Windowed p99 of the placement-decision overhead (ms) over the
        last 512 placements; None before any placement. The health
        monitor's overhead-storm alert and the bench fleet-chaos gate
        both bound THIS number against --router-overhead-budget-ms."""
        window = sorted(self._place_window)
        if not window:
            return None
        return window[min(len(window) - 1, int(0.99 * len(window)))]

    def router_overhead_stats(self) -> dict:
        """Per-site overhead readout off the cumulative histogram plus
        the windowed placement p99 (stats/TUI/bench surface)."""
        sites = {}
        for labelvalues, child in tm.ROUTER_OVERHEAD_MS.series():
            if child.count == 0:
                continue
            sites[labelvalues[0]] = {
                "count": child.count,
                "mean_ms": round(child.sum / child.count, 4),
                "p50_ms": round(child.quantile(0.5), 4),
                "p99_ms": round(child.quantile(0.99), 4),
            }
        p99 = self.router_overhead_p99_ms()
        return {
            "sites": sites,
            "place_p99_ms": round(p99, 4) if p99 is not None else None,
            "budget_ms": getattr(self.ecfg, "router_overhead_budget_ms",
                                 None),
        }

    def member_metric_federation(self) -> List[tuple]:
        """(replica, registry snapshot) pairs for /metrics federation:
        every HTTP member's scraped series re-exports with a `replica`
        label next to the router's own. Ejected members drop out of the
        exposition (their last snapshot is stale by definition);
        LocalMembers share this process's registry and are already in
        the local exposition."""
        if not getattr(self.ecfg, "federate_metrics", True):
            return []
        out = []
        for mem in self.members:
            if mem.state == "ejected":
                continue
            snap = mem.metric_snapshot()
            if snap:
                out.append((mem.name, snap))
        return out

    def member_bundles(self) -> Dict[str, dict]:
        """Per-member diagnostics for /debug/bundle, error-contained per
        member: one dead replica must not cost the operator the rest of
        the fleet's bundle."""
        out: Dict[str, dict] = {}
        for mem in self.members:
            try:
                out[mem.name] = mem.bundle()
            except Exception as e:  # noqa: BLE001
                out[mem.name] = {"error": f"{type(e).__name__}: {e}",
                                 "state": mem.state}
        return out

    def fleet_trace_spans(self, rid: int) -> List[dict]:
        """Every process's spans for the stream the client knows as
        `rid`: the router's root trace (found by rid — stable across
        failovers) plus each member's spans for the same fleet context.
        GET /debug/trace/{rid} stitches these into one timeline whose
        phase sum equals the client-observed e2e."""
        root = self.tracer.find(rid)
        if root is None:
            return []
        spans = self.tracer.export_spans([root])
        ctx = root.ctx
        for mem in self.members:
            try:
                spans.extend(mem.trace_spans(ctx))
            except Exception:  # noqa: BLE001 — a dead member's spans
                pass  # are simply absent; the root timeline stands
        return spans

    # ----------------------------------------------------------------- stats
    def fleet_counts(self) -> dict:
        counts = {"healthy": 0, "ejected": 0, "draining": 0}
        for mem in self.members:
            counts[mem.state] = counts.get(mem.state, 0) + 1
        return counts

    def fleet_status(self) -> dict:
        rows = []
        for mem in self.members:
            age = mem.heartbeat_age()
            row = {
                "name": mem.name,
                "kind": mem.kind_label,
                "state": mem.state,
                "heartbeat_age_s": (round(age, 3)
                                    if age != float("inf") else None),
                "inflight": self._load_of(mem),
                "ejects": mem.eject_count,
                "alerts": [n for n, _ in mem.active_alerts()],
            }
            if mem.tier is not None:
                row["tier"] = mem.tier
            if getattr(mem, "preemptible", False):
                row["preemptible"] = True
            if getattr(mem, "retiring", False):
                row["retiring"] = True
            rows.append(row)
        return {
            "placement": self.placement,
            "drain_timeout_s": self.drain_timeout_s,
            "migrate": self.migrate,
            "migrate_timeout_s": self.migrate_timeout_s,
            "replicas": rows,
            "counts": self.fleet_counts(),
            "failovers": self.failover_count,
            "migrations": self.migration_count,
            "migrate_aborts": self.migrate_abort_count,
            "queued": self.core.total_queued(),
            "tiers": (self.tiers.status() if self.tiers is not None
                      else None),
            "autoscaler": (self.autoscaler.status()
                           if self.autoscaler is not None else None),
            "router_overhead": self.router_overhead_stats(),
        }

    def scheduler_stats(self) -> dict:
        """Fleet scheduling readout (TUI sched chip / stats): local
        members schedule in-process with the forwarded --scheduler
        (their member config carries it); subprocess/HTTP members
        receive the same flag through their own SCHEDULER env (the
        docker-compose fleet services). Reports the first local
        member's live policy + predictor accuracy, or the configured
        policy name for a pure HTTP-member router."""
        for mem in self.local_members:
            eng = mem.engine
            if getattr(eng, "policy", None) is not None:
                return eng.scheduler_stats()
        return {"policy": getattr(self.ecfg, "scheduler", "fcfs"),
                "pred_accuracy": None, "pred_observed": 0, "decisions": 0}

    def stats(self) -> dict:
        runtime_stats = []
        for mem in self.local_members:
            for rt in mem.engine.runtimes.values():
                row = rt.stats()
                row["replica"] = mem.name
                runtime_stats.append(row)
        chips = self.chip_stats()
        hbm_used = sum(c["hbm_used"] for c in chips) or sum(
            r["param_bytes"] + r["kv_bytes"] for r in runtime_stats)
        hbm_total = sum(c["hbm_total"] for c in chips) or None
        return {
            "runtimes": runtime_stats,
            "chips": chips,
            "mesh": None,
            "hbm_used_bytes": hbm_used,
            "hbm_total_bytes": hbm_total,
            "uptime_s": round(time.time() - self.started_at, 1),
            "health": self.health.status() if self.health else None,
            "queue": self.core.snapshot(),
            "shed": dict(self.shed_counts),
            "preemptions": self.preemption_count(),
            "retries": self.retry_count(),
            "scheduler": self.scheduler_stats(),
            "fleet": self.fleet_status(),
        }
