"""Deterministic fake engine for tests and API development.

The JAX package's FakeEngine (engine/fake.py) on TorchEngine: the same
admission, fair-share, shedding, journaling and durability paths as the
real engine, with a runtime that runs no model. Tokens are deterministic
(`word0 word1 ...`, one per step, ids 1, 2, ...), latency is
configurable and cancellation works mid-stream, so the HTTP surface, the
journal's record/replay harness (tools/journal) and crash recovery are
testable without a device. The decision stream it journals is the JAX
FakeEngine's, record for record, so a trace recorded by either
package's tool replays under the other's.

It holds no tensors and runs on the CPU whatever the host has;
TorchEngine itself still defaults to CUDA. Its KV migration ships the
word cursor in place of pages, so the fleet's drain and failover run the
whole two-phase handoff on fake members.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Dict, List, Optional

from ollamamq_tpu_torch.config import EngineConfig, get_model_config
from ollamamq_tpu_torch.engine.engine import (JournaledRuntime, TorchEngine,
                                              drop_expired,
                                              request_migration_state)
from ollamamq_tpu_torch.engine.request import FinishReason, Request, StreamItem
from ollamamq_tpu_torch.engine.tokenizer import ByteTokenizer
from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.telemetry import stepprof

log = logging.getLogger("ollamamq.torch.fake")


class FakeRuntime(JournaledRuntime):
    """Generates `word0 word1 ...` tokens, one per step, per active
    request; at most 16 tokens a request."""

    slo = None  # attached by FakeEngine.load_model, like ModelRuntime's
    fault_plan = None
    # Scheduling policy: the seam the replay/simulate harness drives.
    # None orders fcfs.
    policy = None

    def __init__(self, name: str, engine_cfg: EngineConfig,
                 token_latency_s: float = 0.0, is_encoder: bool = False):
        # Encoder fakes are embedding-only, like EncoderRuntime; generative
        # fakes embed in step() too, so they serve both kinds.
        self.SERVES = ("embed",) if is_encoder else ("generate", "embed")
        self.name = name
        self.ecfg = engine_cfg
        self.token_latency_s = token_latency_s
        self.is_encoder = is_encoder
        self.tokenizer = ByteTokenizer()
        self.pending_prefill: collections.deque = collections.deque()
        self.active: List[Request] = []
        self._failed = False
        self.prefix_cache = None
        self.tokens_generated = 0
        self.preempt_count = 0  # fakes hold no pages to run out of
        self.retry_count = 0
        # The ModelRuntime's metric surface, so the exposition looks the
        # same under the fake engine.
        self._tm_ttft = tm.TTFT_MS.labels(model=name)
        self._tm_tpot = tm.TPOT_MS.labels(model=name)
        self._tm_tokens = tm.TOKENS_GENERATED_TOTAL.labels(model=name)
        self._tm_occupancy = tm.BATCH_OCCUPANCY.labels(model=name)
        self._tm_mfu = tm.MFU.labels(model=name)
        self._tm_occupancy.set(0.0)
        self._tm_mfu.set(0.0)

    def has_capacity(self, kind=None) -> bool:
        return len(self.active) + len(self.pending_prefill) < self.ecfg.max_slots

    def has_work(self) -> bool:
        return bool(self.pending_prefill) or bool(self.active)

    def active_count(self) -> int:
        return len(self.active)

    def held_requests(self) -> List[Request]:
        return list(self.active) + list(self.pending_prefill)

    def submit(self, req: Request) -> bool:
        self.pending_prefill.append(req)
        return True

    def _finish_served(self, req: Request, core, reason: FinishReason) -> None:
        """Served-to-completion finish: journal the outcome beside the
        policy's prediction and feed the output-length predictor."""
        core.mark_done(req.user, tokens=len(req.generated_ids))
        req.stats.completion_tokens = len(req.generated_ids)
        pol = self.policy
        extra = ({"predicted_tokens": pol.predict(req)}
                 if pol is not None else {})
        self._jrec("finish", req, reason=reason.value,
                   tokens=len(req.generated_ids), **extra)
        if pol is not None:
            pol.observe_finish(req, model=self.name)
        req.finish(reason)

    def _cancel_active(self, req: Request, core) -> None:
        self.active.remove(req)
        core.mark_dropped(req.user)
        self._jrec("finish", req, reason="cancelled",
                   tokens=len(req.generated_ids))
        req.finish(FinishReason.CANCELLED)

    def check_cancellations(self, core) -> None:
        for req in list(self.active):
            if req.cancelled.is_set():
                self._cancel_active(req, core)

    def step(self, core) -> None:
        # Fault seam: a firing "step" rule fails the whole step, driving
        # the engine's retry-then-poison containment.
        if self.fault_plan is not None:
            self.fault_plan.check("step")
        # Step profiler, fake shape: admission is host_prep, the latency
        # sleep the dispatch, the emit loop detok.
        _sp = stepprof.PROFILER.start("fake")
        _gen0 = self.tokens_generated
        # Slot-bounded admission in policy order; cancelled and expired
        # heads always drain, and embeds hold no slot.
        if self.policy is not None:
            self.policy.reorder_pending(self.pending_prefill)
        admitted: List[Request] = []
        while self.pending_prefill:
            head = self.pending_prefill[0]
            if head._retry_at > time.monotonic():
                break  # backing off after a contained fault
            if (len(self.active) >= self.ecfg.max_slots
                    and not (self.is_encoder or head.kind == "embed")
                    and not head.cancelled.is_set()
                    and not head.expired()):
                break  # batch full: the policy order decides who is next
            req = self.pending_prefill.popleft()
            if req.cancelled.is_set():
                core.mark_dropped(req.user)
                self._jrec("finish", req, reason="cancelled", tokens=0)
                req.finish(FinishReason.CANCELLED)
                continue
            if req.expired():
                drop_expired(req, core, self.name, journal=self.journal)
                continue
            if self.is_encoder or req.kind == "embed":
                req.trace_event("embed_batch", tokens=len(req.prompt_tokens))
                req.embedding = self._fake_embedding(req)
                req.stats.first_token_at = time.monotonic()
                core.mark_done(req.user, tokens=len(req.prompt_tokens))
                self._jrec("finish", req, reason="stop",
                           tokens=len(req.prompt_tokens))
                req.finish(FinishReason.STOP)
                continue
            req.trace_event("prefill", tokens=len(req.prompt_tokens))
            # Resume-aware: a retried or recovered request continues its
            # word stream where it stopped.
            done = len(req.generated_ids)
            req._fake_remaining = max(1, min(req.sampling.max_tokens, 16) - done)
            req._fake_idx = done
            self._jrec("install", req, slot=-1, n_prompt=len(req.prompt_tokens))
            self.active.append(req)
            admitted.append(req)
        real = sum(len(r.prompt_tokens) for r in admitted)
        if admitted:
            # No padding (tokens are words): real == padded.
            self._jrec("batch", slots=[-1] * len(admitted),
                       reqs=[r.req_id for r in admitted],
                       batch_size=len(admitted), tokens=real,
                       occupancy=round(len(self.active)
                                       / max(1, self.ecfg.max_slots), 4),
                       pending=len(self.pending_prefill),
                       mode="fake", padded_tokens=real)
        self._tm_occupancy.set(len(self.active) / max(1, self.ecfg.max_slots))
        had_work = bool(admitted or self.active)
        n_decode = len(self.active)
        _sp.mark("host_prep")
        if self.token_latency_s:
            time.sleep(self.token_latency_s)
        _sp.mark("dispatch")
        for req in list(self.active):
            if req.cancelled.is_set():
                self._cancel_active(req, core)
                continue
            # With spec on, a step emits 1 + k words and journals the
            # speculate / spec_verify pair; fake drafts always verify.
            emit_n = 1
            if (self.ecfg.spec and self.ecfg.spec_k > 0
                    and req._fake_remaining > 1):
                k = min(self.ecfg.spec_k, req._fake_remaining - 1)
                self._jrec("speculate", req, slot=-1, k=k, source="fake")
                self._jrec("spec_verify", req, slot=-1, proposed=k,
                           accepted=k, rolled_back=0)
                tm.SPEC_TOKENS_TOTAL.labels(model=self.name,
                                            outcome="proposed").inc(k)
                tm.SPEC_TOKENS_TOTAL.labels(model=self.name,
                                            outcome="accepted").inc(k)
                tm.SPEC_ACCEPT_RATE.labels(model=self.name).set(1.0)
                emit_n = 1 + k
            for _ in range(emit_n):
                if self._emit_word(req, core):
                    break
        if had_work:
            emitted = self.tokens_generated - _gen0
            _sp.mark("detok")
            _sp.finish(T_pad=0, k_cap=0, n_prefill=len(admitted),
                       n_decode=n_decode, tokens=real + emitted,
                       padded_tokens=real + emitted, compiled=False)

    def _emit_word(self, req: Request, core) -> bool:
        """Emit the next word of `req`; True when the request finished."""
        word = f"word{req._fake_idx} "
        req._fake_idx += 1
        req._fake_remaining -= 1
        req.generated_ids.append(req._fake_idx)
        self.tokens_generated += 1
        self._tm_tokens.inc()
        if not req.stats.first_token_at:
            req.stats.first_token_at = time.monotonic()
            self._tm_ttft.observe(req.stats.ttft_ms)
            self._tm_tpot.observe(self.token_latency_s * 1e3)
            if self.slo is not None:
                self.slo.record("ttft", req.stats.ttft_ms)
            req.trace_event("first_token", ttft_ms=round(req.stats.ttft_ms, 3))
        elif self.slo is not None:
            self.slo.record("tpot", self.token_latency_s * 1e3)
        chunk = req.emit_text(word)
        if chunk is None:
            self.active.remove(req)
            self._finish_served(req, core, FinishReason.STOP)
            return True
        if chunk:
            req.stream.push(StreamItem("token", text=chunk,
                                       token_id=req._fake_idx))
        if req._fake_remaining <= 0:
            self.active.remove(req)
            tail = req.flush_text()
            if tail:
                req.stream.push(StreamItem("token", text=tail))
            self._finish_served(req, core, FinishReason.LENGTH)
            return True
        return False

    # -- KV page migration (fake shape: no pages, the word cursor) ---------
    def export_request(self, rid: int):
        """ModelRuntime's export contract over fake state: the word
        cursor IS the KV."""
        for req in self.active:
            if req.req_id == rid:
                break
        else:
            return None
        blob = {
            "version": 1, "kind": "fake", "model": self.name,
            "fake_idx": int(req._fake_idx),
            "fake_remaining": int(req._fake_remaining),
            "request": request_migration_state(req),
            "_inc_decode": req._inc_decode,
        }
        self.active.remove(req)
        return {"req": req}, blob

    def release_export(self, handle: dict) -> None:
        pass  # a fake holds no pages

    def import_request(self, blob: dict, req: Request) -> bool:
        if blob.get("kind") != "fake" \
                or len(self.active) >= self.ecfg.max_slots:
            return False
        req._fake_idx = int(blob["fake_idx"])
        req._fake_remaining = int(blob["fake_remaining"])
        self._jrec("install", req, slot=-1,
                   n_prompt=len(req.prompt_tokens))
        self.active.append(req)
        return True

    def _fake_embedding(self, req: Request) -> list:
        # A deterministic unit vector derived from the prompt ids.
        dim = 64
        v = [0.0] * dim
        for i, t in enumerate(req.prompt_tokens):
            v[i % dim] += float((t % 13) + 1)
        norm = sum(x * x for x in v) ** 0.5 or 1.0
        return [x / norm for x in v]

    def stats(self) -> dict:
        return {
            "model": self.name, "device": "cpu",
            "active_slots": len(self.active),
            "max_slots": self.ecfg.max_slots,
            "pending_prefill": len(self.pending_prefill),
            "pages_used": 0, "pages_total": 0,
            "step_latency_ms": round(self.token_latency_s * 1e3, 3),
            "prefill_latency_ms": 0.0,
            "tokens_generated": self.tokens_generated,
            "preemptions": 0, "retries": 0, "stalled_slots": 0,
            "mfu": 0.0,
            "param_bytes": 0, "kv_bytes": 0,
            "prefix_cache": None,  # fake tokens carry no KV to share
            "weights_dtype": "bfloat16", "kv_dtype": "bfloat16",
            "spec": None,  # fake drafts never roll back
            "failed": self._failed,
        }


class FakeEngine(TorchEngine):
    """TorchEngine with FakeRuntimes: the same scheduler and admission
    path, no model."""

    def __init__(self, engine_cfg: Optional[EngineConfig] = None,
                 models: Optional[Dict[str, Optional[str]]] = None,
                 blocklist_path: Optional[str] = None,
                 token_latency_s: float = 0.0, **kw):
        self.token_latency_s = token_latency_s
        engine_cfg = engine_cfg or EngineConfig(model="test-tiny")
        super().__init__(engine_cfg, device="cpu", models=models,
                         blocklist_path=blocklist_path, **kw)

    def load_model(self, name: str, checkpoint_path: Optional[str] = None,
                   params: Optional[dict] = None) -> None:
        cfg = get_model_config(name)
        if cfg is None:
            raise KeyError(f"unknown model architecture: {name}")
        if name in self.runtimes:
            return
        rt = FakeRuntime(name, self.ecfg, token_latency_s=self.token_latency_s,
                         is_encoder=bool(cfg.is_encoder))
        rt.slo = self.slo
        rt.fault_plan = self.fault_plan
        rt.journal = self.journal
        rt.policy = self.policy

        def install() -> None:
            self.runtimes.setdefault(name, rt)

        self.call_on_loop(install)
        self.notify()

    def _loop_once(self) -> None:
        self.last_tick_at = time.monotonic()
        self.journal.tick += 1
        self._drain_engine_calls()
        self._admit()
        did_work = False
        for rt in list(self.runtimes.values()):
            rt.check_cancellations(self.core)
            if rt.has_work():
                try:
                    rt.step(self.core)
                except Exception:  # noqa: BLE001 — the loop keeps serving
                    # The real engine's containment: retry or poison the
                    # implicated requests; the fake runtime stays up.
                    log.exception("fake runtime %s step failed", rt.name)
                    self._fail_runtime(rt, "engine step failed")
                did_work = True
        if not did_work:
            with self._cond:
                self._cond.wait(timeout=0.02)
