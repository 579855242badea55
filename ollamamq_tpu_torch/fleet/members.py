"""Fleet members: the engine replicas a FleetRouter places streams on.

The JAX package's fleet/members.py. Two shapes, one protocol:

  LocalMember  wraps an in-process engine (TorchEngine / FakeEngine):
               the replica runs its own scheduler loop, KV pool and
               health monitor inside this process. Replay is exact: a
               failed-over stream carries its generated token ids,
               incremental detokenizer and penalty context (the
               preemption replay lifted to fleet level), so greedy
               resumed streams are byte-identical.
  HttpMember   wraps a subprocess or remote engine speaking the HTTP
               API. Health rides the member's /health JSON polled on a
               heartbeat; streams ride /api/generate NDJSON consumed by a
               reader thread; replay is in token space when every frame
               carried its ids (Ollama's `context`), else text-level
               (prompt plus the emitted text, the budget shrunk by the
               emitted count). KV migration rides /admin/migrate/*.

The router is the ONLY consumer of an attempt's TokenStream: member-side
terminal items (including the CANCELLED ack of an eviction) are routing
signals, not client output; the router decides what the client sees.
The tier and retire fields are read by the fleet's policy layers
(fleet/tiering.py, fleet/autoscaler.py), the epoch and fenced fields by
router HA (fleet/ha.py): every member-facing call carries the router's
epoch, and a member that fenced it fails its streams terminally.
"""

from __future__ import annotations

import copy
import json
import logging
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

from ollamamq_tpu_torch.engine.request import FinishReason, Request, StreamItem
from ollamamq_tpu_torch.telemetry.tracing import TRACEPARENT_HEADER

log = logging.getLogger("ollamamq.fleet")

# Alerts that mean a replica cannot be trusted with new placements (the
# /health JSON "degraded" status alone must NOT eject: an SLO burning is
# pressure, not death — app.py /health makes the same distinction).
FATAL_ALERTS = frozenset({"device_offline", "engine_stall"})
# Fatal too for a member wider than one rank (fleet/wide.py): one of its
# ranks stopped beating, and its runtimes cannot reload without it.
WORLD_FATAL_ALERTS = frozenset({"worker_stale"})

_REASONS = {r.value: r for r in FinishReason}


class Attempt:
    """One member-side serving attempt of a client stream. `req` is the
    member-side Request whose TokenStream the router drains; the client
    never sees this object."""

    __slots__ = ("req", "member", "acked", "closed", "transport_dead",
                 "base_n", "n_items", "text_mode", "prior_text",
                 "text_parts", "thread", "resp", "embedding_val",
                 "member_rid", "token_ids", "prior_ids", "context_ids")

    def __init__(self, req: Request, member) -> None:
        self.req = req
        self.member = member
        self.acked = False           # member confirmed our eviction
        self.closed = False          # router asked this attempt to stop
        self.transport_dead = False  # HTTP stream died mid-flight
        self.base_n = 0              # tokens emitted by PRIOR attempts
        self.n_items = 0             # token items this attempt emitted
        self.text_mode = False       # replay state is text, not token ids
        self.prior_text = ""         # text emitted by prior attempts
        self.text_parts: list = []
        self.thread: Optional[threading.Thread] = None
        self.resp = None
        self.embedding_val = None
        # HTTP attempts: the member-side request id (read off the NDJSON
        # frames; rotates with member-side requeues) — the handle the
        # /admin/migrate endpoints key on — plus the token ids the
        # frames carried, so resumed HTTP streams replay in TOKEN space
        # (verified token-identical) instead of re-tokenized text.
        self.member_rid: Optional[int] = None
        self.token_ids: list = []
        self.prior_ids: Optional[list] = None  # ids of PRIOR attempts
        self.context_ids: Optional[list] = None  # token-space HTTP replay

    def tokens_done(self) -> int:
        if self.text_mode:
            if self.prior_ids is not None and self.token_ids:
                return len(self.prior_ids) + len(self.token_ids)
            return self.base_n + self.n_items
        return len(self.req.generated_ids)

    def embedding(self):
        return self.embedding_val if self.text_mode else self.req.embedding

    def reader_dead(self) -> bool:
        return self.thread is not None and not self.thread.is_alive()

    def resume_state(self) -> dict:
        """Replay state for the NEXT attempt of this stream: everything a
        healthy replica needs to continue it seamlessly."""
        req = self.req
        if self.text_mode:
            text = self.prior_text + "".join(self.text_parts)
            # Token-space HTTP resume: when every attempt so far carried
            # its token ids on the wire, the next attempt replays exact
            # ids (byte-identical continuation, verified token-identical)
            # instead of re-tokenizing emitted text.
            if self.prior_ids is not None \
                    and (self.n_items == 0 or self.token_ids):
                gen = list(self.prior_ids) + [int(t) for t in
                                              self.token_ids]
                return {"gen_ids": gen, "n_gen": len(gen), "inc": None,
                        "detok": text, "emitted": len(text), "text": text}
            return {"gen_ids": None,
                    "n_gen": self.base_n + self.n_items,
                    "text": text}
        return {"gen_ids": list(req.generated_ids),
                "n_gen": len(req.generated_ids),
                "inc": req._inc_decode,
                "detok": req._detok_text,
                "emitted": req.emitted_len,
                # Full emitted text, for a cross-shape (local -> HTTP)
                # failover that can only replay in text space.
                "text": req._detok_text[:req.emitted_len]}


class _MemberBase:
    """State the router tracks per member regardless of shape."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.state = "healthy"       # healthy | ejected | draining
        self.backoff_s = 0.0         # set by the router at eject time
        self.next_probe_at = 0.0
        self.eject_count = 0
        self.drain_started_at = 0.0
        self.drain_deadline = 0.0
        self.forced_stale_until = 0.0  # fault site "replica", kind "slow"
        # Tiered fleet (fleet/tiering.py): which replica tier this
        # member serves (None = untiered fleet), and — while a regroup's
        # drain is in flight — the tier it is moving to. The tier
        # commits only when the retier restart succeeds; an abort
        # (crash mid-retier, restart failure) leaves the ORIGINAL tier.
        self.tier: Optional[str] = None
        self.retier_to: Optional[str] = None
        # Elastic fleet (fleet/autoscaler.py): `preemptible` marks
        # spot-style capacity that accepts a termination notice
        # (migrate-off-then-retire within the notice window instead of
        # failover); `retiring` is set while a scale-down/preempt drain
        # is in flight — when the drain empties, the router STOPS the
        # member and removes it from the roster instead of restarting
        # it. An eject mid-retire aborts the retire (scale_down
        # aborted); the member heals back through the normal re-probe
        # path and stays in rotation.
        self.preemptible: bool = False
        self.retiring: bool = False
        self.retire_why: Optional[str] = None
        # Scaler-provisioned members carry their provisioner handle so
        # retire can tear down what provision built (a subprocess, a
        # cloud VM) — operator-defined members have None and just stop.
        self.provisioned_by = None
        # Router HA (fleet/ha.py): the fencing epoch every member-facing
        # call carries (X-Router-Epoch). None = HA off, no header, the
        # member-side check passes — non-HA fleets are unchanged.
        self.router_epoch: Optional[int] = None
        # Set when this member 409'd a call carrying OUR epoch: a newer
        # router registered a higher one, i.e. WE are the zombie. A
        # fenced member fails streams terminally instead of feeding the
        # failover loop — without this a revived dead primary retries
        # every rejected placement forever (a 409 storm against the
        # whole fleet).
        self.fenced = False

    def force_stale(self, delay_s: float) -> None:
        self.forced_stale_until = time.monotonic() + float(delay_s)

    def register(self, epoch: int) -> bool:
        """Adopt a (new) router epoch. In-process members need no wire
        fencing — a LocalMember dies with its router, so a zombie
        primary can never reach it; HttpMember overrides this with the
        /admin/ha/register POST."""
        self.router_epoch = int(epoch)
        return True

    # -- fleet observability (overridden per shape) ------------------------
    def trace_spans(self, ctx: str) -> list:
        """This member's exported trace spans for one fleet context —
        the stitching wire behind GET /debug/trace/{rid}."""
        return []

    def metric_snapshot(self):
        """Registry snapshot for metrics federation (None = nothing to
        re-export: LocalMembers share the router process's registry)."""
        return None

    def bundle(self) -> dict:
        """Per-member diagnostics for the router's /debug/bundle."""
        return {}


class LocalMember(_MemberBase):
    """An in-process engine replica. The engine was constructed by the
    caller (cli/tests) and is started/stopped through this wrapper."""

    kind_label = "local"
    router_bounded = False  # the engine's own capacity gate bounds intake

    def __init__(self, name: str, engine, engine_factory=None) -> None:
        super().__init__(name)
        self.engine = engine
        # Tier regrouping: `engine_factory(tp)` builds a replacement
        # engine at a different TP width (same models/fairness — the
        # CLI closes over its construction args). Without one, a retier
        # that declares a width change falls back to a re-label +
        # same-width hot restart.
        self.engine_factory = engine_factory
        # Member-side spans stitch under this member's name, not the
        # generic "engine" origin.
        if getattr(engine, "tracer", None) is not None:
            engine.tracer.origin = name

    @property
    def tp(self) -> Optional[int]:
        return getattr(self.engine.ecfg, "tp", None)

    def slot_cap(self) -> int:
        return int(getattr(self.engine.ecfg, "max_slots", 0))

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.engine.start()

    def stop(self) -> None:
        self.engine.stop()

    def crash(self) -> None:
        """Abrupt loop death (fault injection / observed failure): the
        loop thread exits after its current iteration — deliberately NOT
        a clean stop(), which would join and tidy up the very state a
        real crash leaves behind."""
        self.engine._running = False
        self.engine.notify()

    def restart(self) -> None:
        """Hot restart after a crash or heal: the loop thread (and the
        member's health monitor) come back over the SAME runtimes —
        weights stay resident. The OLD loop thread must be fully dead
        first: it may still be inside a long iteration (a wedged
        dispatch), and starting a second loop would reset _running to
        True; the zombie then keeps looping, and two loops writing the
        same KV pool and slot tables corrupt both. Waits briefly for the
        first liveness tick so the caller's health evaluation sees a
        fresh heartbeat. An engine whose stop released its rank world (a
        failed rebuild whose restore failed too) is built anew at its
        width instead."""
        if getattr(self.engine, "released", False) \
                and self.engine_factory is not None:
            self._adopt(self.engine_factory(self.tp))
        else:
            old = self.engine._thread
            if old is not None and old.is_alive():
                old.join(timeout=5.0)
                if old.is_alive():
                    return  # still wedged: stay ejected, re-probe later
            self.engine._thread = None
            self.engine.start()
        deadline = time.monotonic() + 1.0
        while (time.monotonic() - self.engine.last_tick_at > 0.5
               and time.monotonic() < deadline):
            time.sleep(0.01)

    def hot_restart(self) -> None:
        """Drain-complete restart: clean stop (nothing in flight) then
        start — the rolling-restart primitive. An engine that cannot
        start again once stopped (one leading a rank world, whose stop
        releases its ranks) is rebuilt at its width instead."""
        if not getattr(self.engine, "restartable", True) \
                and self.engine_factory is not None:
            self._rebuild(self.tp)
            return
        self.engine.stop()
        self.engine.start()

    def retier(self, tp: Optional[int] = None) -> Optional[int]:
        """Drain-complete retier restart: rebuild the engine at the
        target tier's TP width (the drain already emptied it — weights
        reload, KV pool reallocates at the new sharding; a member wider
        than one rank starts a rank world of its own and the old one's
        ranks are reaped). No factory or no width change => a plain hot
        restart (re-label only). Returns the width the member now runs
        at. On a failed rebuild the OLD engine restarts (one that led a
        rank world is rebuilt at its width, with a new world) and the
        error propagates — the caller aborts the regroup and the member
        keeps its original tier; if that restart fails too the member
        stays down and the caller ejects it."""
        if tp is None or tp == self.tp or self.engine_factory is None:
            self.hot_restart()
            return self.tp
        self._rebuild(tp)
        return self.tp

    def _rebuild(self, tp: Optional[int]) -> None:
        old, old_tp = self.engine, self.tp
        old.stop()
        try:
            fresh = self.engine_factory(tp)
        except Exception:
            # The member must not stay dead over a bad width.
            try:
                if getattr(old, "restartable", True):
                    old.start()
                else:
                    self._adopt(self.engine_factory(old_tp))
            except Exception:  # noqa: BLE001 — the rebuild's error propagates
                log.exception("member %s: its old engine did not start "
                              "again either; it stays down", self.name)
            raise
        self._adopt(fresh)

    def _adopt(self, engine) -> None:
        self.engine = engine
        if getattr(engine, "tracer", None) is not None:
            engine.tracer.origin = self.name
        engine.start()

    # -- health ------------------------------------------------------------
    def alive(self) -> bool:
        eng = self.engine
        return bool(eng._running and eng._thread is not None
                    and eng._thread.is_alive())

    def heartbeat_age(self) -> float:
        now = time.monotonic()
        if now < self.forced_stale_until:
            return float("inf")
        return now - self.engine.last_tick_at

    def fatal_alerts(self) -> list:
        alerts = getattr(self.engine, "alerts", None)
        if alerts is None:
            return []
        # A member leading a rank world cannot serve with a rank dead.
        fatal = (FATAL_ALERTS if getattr(self.engine, "restartable", True)
                 else FATAL_ALERTS | WORLD_FATAL_ALERTS)
        return [a.name for a in alerts.active() if a.name in fatal]

    def active_alerts(self) -> list:
        alerts = getattr(self.engine, "alerts", None)
        if alerts is None:
            return []
        return [(a.name, a.severity) for a in alerts.active()]

    # -- placement ---------------------------------------------------------
    def can_take(self, model: str, kind: str) -> bool:
        eng = self.engine
        rt = eng.resolve_runtime(model, kind=kind)
        if rt is None:
            return False
        probe = rt.replicas[0] if hasattr(rt, "replicas") else rt
        if kind not in getattr(probe, "SERVES", ("generate",)):
            return False
        return rt.has_capacity(kind)

    def affinity_pages(self, model: str, tokens) -> int:
        fn = getattr(self.engine, "prefix_match_pages", None)
        return fn(model, tokens) if fn is not None else 0

    # -- streams -----------------------------------------------------------
    def _tokenize(self, model: str, text: str):
        rt = self.engine.resolve_runtime(model)
        if rt is None:
            from ollamamq_tpu_torch.engine.tokenizer import ByteTokenizer

            return ByteTokenizer().encode(text, add_bos=True)
        return rt.tokenizer.encode(text, add_bos=True)

    def begin(self, flight, resume: Optional[dict], on_item=None) -> Attempt:
        sampling = flight.sampling
        if resume and resume.get("gen_ids") is not None:
            # Token-space replay: prompt + every already-emitted token,
            # generation state carried over — the engine's own
            # preemption-replay convention (generated_ids pre-filled, so
            # LENGTH accounting and the fake engine's resume-awareness
            # both hold; the incremental detokenizer never re-sees the
            # replayed ids).
            gen = list(resume["gen_ids"])
            req = Request(0, flight.user, flight.model,
                          list(flight.prompt_tokens) + gen, sampling,
                          kind=flight.kind, raw_prompt=flight.raw_prompt)
            req.generated_ids = list(gen)
            req._replay_gen = len(gen)
            req._inc_decode = resume.get("inc")
            req._detok_text = resume.get("detok", "")
            req.emitted_len = resume.get("emitted", 0)
        elif resume:
            # Text-space replay (stream previously served over HTTP):
            # fold the emitted text into the prompt and shrink the budget.
            n_gen = int(resume.get("n_gen", 0))
            tokens = self._tokenize(
                flight.model, flight.raw_prompt + resume.get("text", ""))
            sampling = copy.copy(sampling)  # copy.copy skips __post_init__
            sampling.max_tokens = max(1, sampling.max_tokens - n_gen)
            req = Request(0, flight.user, flight.model, tokens, sampling,
                          kind=flight.kind, raw_prompt=flight.raw_prompt)
        else:
            req = Request(0, flight.user, flight.model,
                          list(flight.prompt_tokens), sampling,
                          kind=flight.kind, raw_prompt=flight.raw_prompt)
        # The client's deadline is absolute; the attempt must not get a
        # fresh budget just because it re-enqueued later.
        req.deadline = flight.req.deadline
        if on_item is not None:
            req.stream.on_item = on_item
        att = Attempt(req, self)
        if resume and resume.get("gen_ids") is None:
            att.text_mode = True
            att.base_n = int(resume.get("n_gen", 0))
            att.prior_text = resume.get("text", "")
        # trace_meter=False: the router's root trace already meters this
        # stream in the SHARED process registry — the member-side copy
        # exists only so its prefill/decode spans stitch under the
        # client rid.
        self.engine.inject_request(req, ip=flight.ip, family=flight.family,
                                   trace_ctx=flight.ctx, trace_meter=False)
        return att

    def cancel(self, att: Attempt) -> None:
        att.closed = True
        att.req.cancelled.set()
        try:
            self.engine.cancel(att.req.req_id)
        except Exception:  # noqa: BLE001 — a dead member must not block evac
            log.exception("cancel on member %s failed", self.name)

    # -- KV page migration (in-process handoff) ----------------------------
    def export_stream(self, att: Attempt,
                      deadline: Optional[float] = None):
        """Phase 1: detach the attempt's decode slot into a blob. Works
        even on a member whose loop just died (a crashed engine's state
        is frozen, not gone — exactly when migration beats recompute).
        None = not exportable; the router falls back to recompute."""
        return self.engine.export_stream(att.req.req_id, deadline)

    def resolve_export(self, att: Attempt, commit: bool,
                       why: str = "") -> None:
        """Phase 2: release the parked source state (commit after the
        target acked the import, abort otherwise)."""
        self.engine.resolve_export(att.req.req_id, commit=commit, why=why)

    def import_stream(self, blob: dict, flight, on_item=None) -> Attempt:
        """Target side: land the shipped state straight into a decode
        slot (raises MigrationError when it cannot — the ack the source
        commit waits on is this returning)."""
        req = self.engine.import_stream(
            blob, ip=flight.ip, family=flight.family,
            deadline=flight.req.deadline,
            trace_ctx=flight.ctx, trace_meter=False)
        if on_item is not None:
            req.stream.on_item = on_item
        return Attempt(req, self)

    def export_prefix(self, model: str, tokens):
        fn = getattr(self.engine, "export_prefix", None)
        return fn(model, tokens) if fn is not None else None

    def import_prefix(self, model: str, blob: dict) -> int:
        fn = getattr(self.engine, "import_prefix", None)
        return fn(model, blob) if fn is not None else 0

    # -- fleet observability ----------------------------------------------
    def trace_spans(self, ctx: str) -> list:
        tracer = getattr(self.engine, "tracer", None)
        if tracer is None:
            return []
        return tracer.export_spans(tracer.find_ctx(ctx))

    def bundle(self) -> dict:
        """Compact per-member diagnostics for the router's bundle: an
        in-process member needs no HTTP round-trip — read its surfaces
        directly (error containment lives at the router's section
        builder)."""
        eng = self.engine
        out: dict = {"kind": "local", "tier": self.tier}
        out["stats"] = eng.stats()
        alerts = getattr(eng, "alerts", None)
        out["alerts"] = alerts.to_dict() if alerts is not None else None
        journal = getattr(eng, "journal", None)
        if journal is not None:
            out["journal"] = {**journal.snapshot(),
                              "events": journal.tail(n=100)}
        return out


class HttpMember(_MemberBase):
    """A remote engine replica speaking the existing HTTP API. Health is
    the member's /health JSON polled on a heartbeat cadence; staleness =
    no successful poll recently."""

    kind_label = "http"
    router_bounded = True  # no capacity introspection over HTTP

    def __init__(self, name: str, url: str, timeout_s: float = 300.0,
                 poll_period_s: float = 1.0) -> None:
        super().__init__(name)
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s
        self.poll_period_s = poll_period_s
        self._forced_down = False
        self._last_ok = time.monotonic()
        self._status: dict = {}
        # Metrics federation: the member's registry snapshot, scraped on
        # the SAME health heartbeat (one extra GET per poll) so the
        # router's /metrics re-exports every member series with a
        # replica label. None until the first successful scrape.
        self._metric_snapshot: Optional[dict] = None
        self._stop = threading.Event()
        self._poller: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._poller is None:
            self._stop.clear()
            self._poller = threading.Thread(
                target=self._poll_loop, name=f"fleet-poll-{self.name}",
                daemon=True)
            self._poller.start()

    def stop(self) -> None:
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=2)
            self._poller = None

    def crash(self) -> None:
        # Fault injection can't kill a remote process; it marks the
        # member down so the router's eject/failover path still runs.
        self._forced_down = True

    def restart(self) -> None:
        self._forced_down = False

    def hot_restart(self) -> None:
        # The remote process restarts itself (rolling deploy); drain's
        # job here was only to quiesce placements first.
        self._forced_down = False

    @property
    def tp(self) -> Optional[int]:
        return None  # no TP introspection over HTTP

    def slot_cap(self) -> int:
        return 0  # the router's own bound applies (router_bounded)

    def retier(self, tp: Optional[int] = None) -> Optional[int]:
        # Re-label only: the remote service owns its own TP width (a
        # rolling redeploy at the new width is the operator's move).
        self.hot_restart()
        return None

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_period_s):
            try:
                with urllib.request.urlopen(self.url + "/health",
                                            timeout=2.0) as resp:
                    self._status = json.loads(resp.read())
                self._last_ok = time.monotonic()
            except Exception:  # noqa: BLE001 — staleness IS the signal
                continue
            self._repair_epoch()
            # Federation scrape rides the SAME heartbeat: a member whose
            # /health answers but whose snapshot endpoint fails (old
            # member build, transient error) keeps its LAST snapshot —
            # health and federation degrade independently.
            try:
                with urllib.request.urlopen(
                        self.url + "/metrics/snapshot",
                        timeout=2.0) as resp:
                    self._metric_snapshot = json.loads(resp.read())
            except Exception:  # noqa: BLE001
                pass

    # -- router HA ---------------------------------------------------------
    def _repair_epoch(self) -> None:
        """Heartbeat fence repair: a member that RESTARTED after a
        takeover reports an epoch below ours on /health (a fresh
        process holds 0 unless it persisted the fence) — until it
        re-adopts, a zombie ex-primary's retried calls would pass its
        fence again. Re-register it under our epoch within one poll."""
        if self.router_epoch is None or self.fenced:
            return
        try:
            seen = int(self._status.get("epoch") or 0)
        except (TypeError, ValueError):
            return
        if seen < self.router_epoch:
            self.register(self.router_epoch)

    def _epoch_headers(self, headers: dict) -> dict:
        if self.router_epoch is not None:
            headers["X-Router-Epoch"] = str(self.router_epoch)
        return headers

    def register(self, epoch: int) -> bool:
        """Re-register this member under a (new) router epoch: the
        member adopts the highest epoch it has seen and fences every
        later call carrying a lower one. Returns False when the member
        rejected US as stale (a newer router already registered) or is
        unreachable — the caller decides whether that is fatal."""
        self.router_epoch = int(epoch)
        try:
            self._post_json("/admin/ha/register",
                            {"epoch": int(epoch)}, timeout=5.0).close()
            self.fenced = False
            return True
        except urllib.error.HTTPError as e:
            if e.code == 409:
                self.fenced = True  # a newer epoch holds this member
            return False
        except Exception:  # noqa: BLE001 — down members re-register on
            return False    # the next placement's begin()

    # -- health ------------------------------------------------------------
    def alive(self) -> bool:
        return not self._forced_down

    def heartbeat_age(self) -> float:
        now = time.monotonic()
        if now < self.forced_stale_until or self._forced_down:
            return float("inf")
        return now - self._last_ok

    def fatal_alerts(self) -> list:
        return [a.get("name") for a in self._status.get("alerts", ())
                if a.get("name") in FATAL_ALERTS]

    def active_alerts(self) -> list:
        return [(a.get("name"), a.get("severity"))
                for a in self._status.get("alerts", ())]

    # -- placement ---------------------------------------------------------
    def can_take(self, model: str, kind: str) -> bool:
        return True  # the router bounds in-flight per HTTP member

    def affinity_pages(self, model: str, tokens) -> int:
        return 0  # no cross-process radix probe; falls back to least-loaded

    # -- fleet observability ----------------------------------------------
    def metric_snapshot(self) -> Optional[dict]:
        return self._metric_snapshot

    def trace_spans(self, ctx: str) -> list:
        """Fetch this member process's spans for one fleet context
        (GET /debug/trace?ctx=...). The member's generic 'engine' origin
        is relabeled with the member NAME so the stitched timeline says
        which replica served each span."""
        try:
            with urllib.request.urlopen(
                    f"{self.url}/debug/trace?ctx={ctx}",
                    timeout=5.0) as resp:
                spans = json.loads(resp.read()).get("spans") or []
        except Exception:  # noqa: BLE001 — a dead member has no spans
            return []
        for span in spans:
            if span.get("origin") in (None, "engine"):
                span["origin"] = self.name
        return spans

    def bundle(self) -> dict:
        """The member's own /debug/bundle, fetched whole (it is already
        redacted and section-error-contained member-side)."""
        with urllib.request.urlopen(self.url + "/debug/bundle",
                                    timeout=10.0) as resp:
            out = json.loads(resp.read())
        out["kind"] = "http"
        out["tier"] = self.tier
        return out

    # -- streams -----------------------------------------------------------
    def begin(self, flight, resume: Optional[dict], on_item=None) -> Attempt:
        n_prior = int(resume.get("n_gen", 0)) if resume else 0
        prior_text = resume.get("text", "") if resume else ""
        gen_ids = resume.get("gen_ids") if resume else None
        if gen_ids is not None:
            # Token-space resume: the already-emitted ids ride the wire
            # as Ollama's `context` field — the member re-prefills
            # prompt + exact ids and continues, so greedy resumed HTTP
            # streams are token-identical, not re-tokenized best-effort.
            raw_prompt = flight.raw_prompt
        else:
            raw_prompt = flight.raw_prompt + prior_text
        req = Request(0, flight.user, flight.model, [], flight.sampling,
                      kind=flight.kind, raw_prompt=raw_prompt)
        if on_item is not None:
            req.stream.on_item = on_item
        att = Attempt(req, self)
        att.text_mode = True
        att.base_n = n_prior
        att.prior_text = prior_text
        if gen_ids is not None:
            att.context_ids = [int(t) for t in gen_ids]
            att.prior_ids = list(att.context_ids)
        elif resume is None:
            att.prior_ids = []  # fresh stream: the frames' ids are all
        att.thread = threading.Thread(
            target=self._reader, args=(att, flight, n_prior),
            name=f"fleet-{self.name}-r{flight.rid0}", daemon=True)
        att.thread.start()
        return att

    def _options(self, sampling, remaining: int) -> dict:
        opts = {
            "num_predict": remaining,
            "temperature": sampling.temperature,
            "top_k": sampling.top_k,
            "top_p": sampling.top_p,
            "repeat_penalty": sampling.repeat_penalty,
            "presence_penalty": sampling.presence_penalty,
            "frequency_penalty": sampling.frequency_penalty,
        }
        if sampling.stop:
            opts["stop"] = list(sampling.stop)
        if sampling.seed:
            opts["seed"] = sampling.seed
        return opts

    def _reader(self, att: Attempt, flight, n_prior: int) -> None:
        """(reader thread) Drive one streamed member request, pushing
        items into the attempt stream. A transport failure pushes
        NOTHING terminal: a dead connection is the failover trigger, not
        a client-visible error — the router notices transport_dead and
        re-dispatches the stream. When `att.resp` is already open (a
        migration import whose status line WAS the ack) this only
        consumes the body."""
        stream = att.req.stream
        try:
            if att.resp is None and flight.kind == "embed":
                body = {"model": flight.model, "input": flight.raw_prompt}
                httpreq = urllib.request.Request(
                    self.url + "/api/embed",
                    data=json.dumps(body).encode(),
                    headers=self._epoch_headers(
                        {"Content-Type": "application/json",
                         "X-User-ID": flight.user}), method="POST")
                with urllib.request.urlopen(httpreq,
                                            timeout=self.timeout_s) as resp:
                    out = json.loads(resp.read())
                vecs = out.get("embeddings") or []
                att.embedding_val = vecs[0] if vecs else []
                stream.push(StreamItem("done", finish_reason=FinishReason.STOP))
                return
            if att.resp is None:
                remaining = max(1, flight.sampling.max_tokens - n_prior)
                body = {"model": flight.model, "prompt": att.req.raw_prompt,
                        "stream": True,
                        "options": self._options(flight.sampling, remaining)}
                if att.context_ids is not None:
                    body["context"] = att.context_ids
                headers = {"Content-Type": "application/json",
                           "X-User-ID": flight.user}
                if flight.ctx:
                    # Fleet trace propagation: the member adopts the
                    # router's context so its spans stitch under the
                    # client rid at GET /debug/trace/{rid}.
                    headers[TRACEPARENT_HEADER] = flight.ctx
                if flight.req.deadline is not None:
                    left_ms = (flight.req.deadline - time.monotonic()) * 1e3
                    headers["X-Deadline-Ms"] = str(max(1.0, left_ms))
                httpreq = urllib.request.Request(
                    self.url + "/api/generate",
                    data=json.dumps(body).encode(),
                    headers=self._epoch_headers(headers), method="POST")
                att.resp = urllib.request.urlopen(httpreq,
                                                  timeout=self.timeout_s)
            hdr = att.resp.headers.get("X-Request-ID")
            if hdr is not None and att.member_rid is None:
                # The member-side id before any frame: a stream whose
                # tokens decode to no text writes no frame until its end,
                # and a drain must still be able to export it.
                att.member_rid = int(hdr)
            for raw in att.resp:
                if att.closed:
                    return
                try:
                    obj = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                if obj.get("req_id") is not None:
                    # The member-side id: the migration-export handle
                    # (tracked live — member-side requeues rotate it).
                    att.member_rid = int(obj["req_id"])
                if obj.get("error"):
                    reason = _REASONS.get(obj.get("done_reason", ""),
                                          FinishReason.ERROR)
                    stream.push(StreamItem("error", finish_reason=reason,
                                           error=str(obj["error"])))
                    return
                ids = [int(t) for t in obj.get("token_ids") or ()]
                att.token_ids.extend(ids)
                txt = obj.get("response", "")
                if txt:
                    att.n_items += 1
                    att.text_parts.append(txt)
                # One token item per id, the frame's text on the last: a
                # frame carries the ids of the text-less tokens before
                # it (and the done frame the rest), and the router's WAL
                # and stream registry must hold every id for a recovery
                # to replay in token space. A frame without ids is one
                # text item (-1), as the JAX package reads every frame.
                for t in ids[:-1]:
                    stream.push(StreamItem("token", text="", token_id=t))
                if ids or txt:
                    stream.push(StreamItem(
                        "token", text=txt,
                        token_id=ids[-1] if ids else -1))
                if obj.get("done"):
                    reason = _REASONS.get(obj.get("done_reason", "stop"),
                                          FinishReason.STOP)
                    stream.push(StreamItem("done", finish_reason=reason))
                    return
            # Stream ended without a done line: the member died mid-write.
            att.transport_dead = True
        except Exception as e:  # noqa: BLE001
            if (isinstance(e, urllib.error.HTTPError) and e.code == 409
                    and self.router_epoch is not None and not att.closed):
                # Stale-epoch fence: the member rejected OUR epoch — a
                # newer router owns the fleet. Terminal, not a failover
                # trigger: re-dispatching would 409 on every member
                # until the heat death of the fleet, and the stream is
                # already being served (or recovered) by the successor.
                self.fenced = True
                log.error(
                    "member %s fenced router epoch %s for req %s: a "
                    "newer router has taken over; failing the stream "
                    "instead of retrying", self.name, self.router_epoch,
                    flight.rid0)
                stream.push(StreamItem(
                    "error", finish_reason=FinishReason.ERROR))
                return
            if not att.closed:
                log.warning("member %s stream for req %s died: %s",
                            self.name, flight.rid0, e)
                att.transport_dead = True
        finally:
            resp = att.resp
            if resp is not None:
                try:
                    resp.close()
                except Exception:  # noqa: BLE001
                    pass

    def cancel(self, att: Attempt) -> None:
        att.closed = True
        resp = att.resp
        if resp is not None:
            try:
                resp.close()  # member sees the disconnect and cancels
            except Exception:  # noqa: BLE001
                pass

    # -- KV page migration (/admin/migrate wire) ---------------------------
    def _post_json(self, path: str, body: dict, timeout: float):
        httpreq = urllib.request.Request(
            self.url + path, data=json.dumps(body).encode(),
            headers=self._epoch_headers(
                {"Content-Type": "application/json"}), method="POST")
        return urllib.request.urlopen(httpreq, timeout=timeout)

    def export_stream(self, att: Attempt,
                      deadline: Optional[float] = None):
        """Phase 1 over the wire: ask the member service to snapshot +
        park the stream's decode slot, keyed by the member-side request
        id the NDJSON frames carried. None = not exportable (unknown id,
        member unreachable, nothing installed) — recompute fallback."""
        if att.member_rid is None:
            return None
        from ollamamq_tpu_torch.engine import kv_cache as kvc

        left = (deadline - time.monotonic() if deadline is not None
                else 10.0)
        if left <= 0.05:
            return None
        try:
            with self._post_json(
                    "/admin/migrate/export",
                    {"req_id": att.member_rid, "timeout_s": left},
                    timeout=left) as resp:
                return kvc.unpack_migration_blob(resp.read())
        except Exception:  # noqa: BLE001 — export failure means fallback
            return None

    def resolve_export(self, att: Attempt, commit: bool,
                       why: str = "") -> None:
        if att.member_rid is None:
            return
        path = "/admin/migrate/" + ("commit" if commit else "abort")
        try:
            self._post_json(path, {"req_id": att.member_rid, "why": why},
                            timeout=5.0).close()
        except Exception:  # noqa: BLE001 — a dead source resolves itself
            pass

    def import_stream(self, blob: dict, flight, on_item=None) -> Attempt:
        """Target side over the wire: POST the packed blob; a 2xx status
        line IS the import ack (the member installs the slot before it
        starts streaming), then the continuation rides the same NDJSON
        reader as a normal stream. Raises on any failure so the router
        aborts the handoff and falls back to recompute."""
        from ollamamq_tpu_torch.engine import kv_cache as kvc

        state = blob.get("request") or {}
        gen = [int(t) for t in state.get("generated_ids", ())]
        req = Request(0, flight.user, flight.model, [], flight.sampling,
                      kind=flight.kind, raw_prompt=flight.raw_prompt)
        if on_item is not None:
            req.stream.on_item = on_item
        att = Attempt(req, self)
        att.text_mode = True
        att.base_n = len(gen)
        att.prior_ids = gen
        att.prior_text = state.get("detok_text",
                                   "")[:int(state.get("emitted_len", 0))]
        headers = {"Content-Type": "application/octet-stream",
                   "X-User-ID": flight.user}
        if flight.ctx:
            headers[TRACEPARENT_HEADER] = flight.ctx
        if flight.req.deadline is not None:
            left_ms = (flight.req.deadline - time.monotonic()) * 1e3
            headers["X-Deadline-Ms"] = str(max(1.0, left_ms))
        httpreq = urllib.request.Request(
            self.url + "/admin/migrate/import",
            data=kvc.pack_migration_blob(blob),
            headers=self._epoch_headers(headers), method="POST")
        att.resp = urllib.request.urlopen(httpreq, timeout=self.timeout_s)
        att.thread = threading.Thread(
            target=self._reader, args=(att, flight, att.base_n),
            name=f"fleet-{self.name}-m{flight.rid0}", daemon=True)
        att.thread.start()
        return att
