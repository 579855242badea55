"""Continuous-batching engine on PyTorch (one device).

The JAX package's serving loop, carried over for the single-device
ragged path:

  - admission: the engine loop pops requests from the native fair-share
    core (cpp/mqcore.cpp) whenever the model runtime has a free slot and
    KV pages. With the prefix cache on, a prompt sharing full pages with
    a finished one pins them in the radix tree (engine/prefix_cache.py)
    and prefills only its uncached tail;
  - ragged ticks: every admitted prompt rides the span path. A tick with
    a prefill span or a speculative verify span in flight packs those
    spans plus every live decode row into ONE flattened token stream
    (forward_ragged, the ragged paged-attention kernel), then the penalty
    ring, sampling and, for verify spans, greedy acceptance;
  - decode ticks: with no span in flight, all live slots advance k_steps
    tokens in one dispatch (forward_decode, the paged decode kernel, in a
    Python loop of k_steps), collected after every runtime has
    dispatched.

The page lifecycle is the reference's: a decode slot that cannot grow
preempts a victim for recompute (its stream resumes byte-identically
after a replay prefill) or holds a stalled reservation; rejected drafts
roll their pages back; a failed dispatch retries its requests once and
then poisons them; a runtime whose step fails is rebuilt off the engine
thread while its requests wait at the front of their users' queues.

Where the JAX jits donated the KV pools and the recent-token ring, this
engine updates them IN PLACE. Device work is issued without host
synchronisation until a tick's tokens are read back. Preemption and
rollback free pages on the host only: the device reuses them in stream
order.

With weights_dtype="int8" the runtime quantizes its weights when it
builds them (int8 QuantTensors, f32 per-channel scales); with
kv_dtype="int8" its pools are QuantKV (int8 payload, f32 per-slot
per-head scales) and both forwards go through the int8-pool kernels.

Scheduling and observability are the reference's too: a policy
(engine/scheduler.py: fcfs, srpt or edf) orders the admission window
the fair-share core releases (request or token fairness), the pending
prompts, the prefill packing and the preemption victim; bounded
admission sheds past --max-queued / --max-queued-per-user with a
Retry-After; the per-model Prometheus series, the step profiler, the
HBM timeline, request traces, SLO alerts and the health watchdog are
fed at the reference's sites.

Several models share one engine, as in the reference: generative
runtimes (ModelRuntime) and embedding encoders (EncoderRuntime), each
from seeded weights or an HF safetensors directory, loaded and evicted at
run time (/api/pull, /api/delete) with the runtime table changed only on
the loop thread. Embeddings are stateless batched forwards
(serve_embed_batch) with their own capacity pool: a generative runtime
serves them beside its decode slots (step_embed), so an embed request is
admitted while decode is saturated.

Every scheduler-visible decision (enqueue, shed, admit, place, batch,
chunk, install, speculation, preemption, stalls, retries, poisons,
deadline drops, finishes, page alloc/free/evict, rebuilds) lands in the
engine's decision journal (telemetry/journal.py) with the reference's
fields, through the runtimes' `_jrec` seam; nothing is recorded per
decoded token. With a WAL directory (durability/) every generation
request is fsynced before enqueue_request returns and a restart replays
the unfinished ones token-exact.

KV page migration is the fleet's seam (fleet/router.py): a decode slot
exports as a blob of its pages and cursor, parks until the target's
import is acknowledged, and continues on the target with no token
recomputed.

Under pipeline parallelism (a mesh with pipe > 1, parallel/pipeline.py)
a runtime leaves the ragged path, as the reference's does: prompts
prefill in batches padded to a length bucket (step_prefill), a prompt
past the largest bucket streams through one chunk per tick
(step_chunk), decode runs the pipelined forward, speculation is off and
the runtime serves generate only. The loop bounds the bucketed
prefills per tick (prefill_batches_per_tick) so a burst of arrivals
cannot starve the decode streams.

Data parallelism (EngineConfig.dp, a mesh with a data axis) serves a
model as dp replicas (ReplicaSet): each holds its own weights, KV pool,
slots and generator on its own slice of the mesh (replica_submesh),
in this process on its own device or, over the rank world, on its own
ranks. A request goes to the least-loaded replica, ties rotating after
the last pick, and the loop dispatches every replica's decode before
it collects any, so replicas on different devices run at once.

Not carried over yet (a later slice): sequence parallelism.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ollamamq_tpu_torch.config import (EngineConfig, ModelConfig, get_model_config,
                                       smart_match, validate_quant_config)
from ollamamq_tpu_torch.core.mqcore import BlockedError, Fairness, Family, MQCore
from ollamamq_tpu_torch.engine import kv_cache as kvc
from ollamamq_tpu_torch.engine.health import HealthMonitor, device_memory
from ollamamq_tpu_torch.engine.prefix_cache import PrefixCache
from ollamamq_tpu_torch.engine.request import FinishReason, Request, StreamItem
from ollamamq_tpu_torch.engine.scheduler import make_policy
from ollamamq_tpu_torch.engine.tokenizer import load_tokenizer
from ollamamq_tpu_torch.models import llama, weights
from ollamamq_tpu_torch.ops.quant import nbytes
from ollamamq_tpu_torch.parallel import pipeline
from ollamamq_tpu_torch.parallel.mesh import (make_mesh, replica_submesh,
                                              validate_tp_for_model)
from ollamamq_tpu_torch.ops.sampling import (SamplingParams, accept_prefix,
                                             maybe_apply_penalties, row_uniforms,
                                             sample_tokens_rowwise, sampling_flags)
from ollamamq_tpu_torch.telemetry import mfu as mfu_model
from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.telemetry import stepprof
from ollamamq_tpu_torch.telemetry.journal import Journal
from ollamamq_tpu_torch.telemetry.slo import AlertManager, SLOEngine
from ollamamq_tpu_torch.telemetry.tracing import DECODE_EVENT_EVERY, Tracer

log = logging.getLogger("ollamamq.torch.engine")

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller asks for the CPU.
    Raises when CUDA is asked for (or defaulted to) and none is found;
    nothing falls back to the CPU on its own."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def sweep_blocked(core: MQCore, held, last_version: int) -> int:
    """Cancel held requests of blocked users; returns the blocklist
    version swept against (no FFI work unless it changed)."""
    ver = core.block_version()
    if ver == last_version:
        return ver
    for req in held:
        if core.is_user_or_ip_blocked(req.user):
            req.cancelled.set()
    return ver


def drop_expired(req: Request, core: MQCore, model: str,
                 journal=None) -> None:
    """Finish an expired request with the explicit deadline reason and
    count the shed; the journal record carries how long past its
    deadline the drop happened."""
    core.mark_dropped(req.user, started=req.started)
    tm.DEADLINE_DROPS_TOTAL.labels(model=model or "?").inc()
    tm.SHED_TOTAL.labels(reason="deadline").inc()
    if journal is not None:
        journal.record("deadline_drop", req=req, model=model or None,
                       slack_ms=round(_slack_ms(req), 3))
    req.finish(FinishReason.DEADLINE,
               error="deadline expired before completion")


def _slack_ms(req: Request) -> float:
    """How long past its deadline a request is (ms)."""
    if req.deadline is None:
        return 0.0
    return (time.monotonic() - req.deadline) * 1e3


def chip_stats(device: torch.device) -> List[dict]:
    """One row for the engine's device: id, name, HBM in use / total.
    memory_stats=False marks the CPU, which reports no HBM: /metrics omits
    the series and the TUI renders "n/a" instead of a 0-byte reading."""
    row = {"device": str(device), "id": device.index or 0, "process": 0,
           "hbm_used": 0, "hbm_total": 0, "memory_stats": False}
    mem = device_memory(device)
    if mem is not None:
        row.update(device=torch.cuda.get_device_name(device),
                   hbm_used=mem["allocated_bytes"], hbm_total=mem["total_bytes"],
                   memory_stats=True)
    return [row]


def serve_embed_batch(rt, core: MQCore, pending, max_len: int, dispatch,
                      max_batch: int = 8) -> bool:
    """Pop up to `max_batch` ready embed requests, pad them to a
    power-of-two length bucket (>= 32) and a batch of 1 or `max_batch`,
    run ONE stateless forward `dispatch(B, bucket, tokens, lens)` -> [B, D]
    and finish each request with its vector. The one batching scheme of
    both embedding paths (EncoderRuntime.step, ModelRuntime.step_embed).
    Cancelled, expired and too-long requests finish one by one, never
    failing the batch. On a dispatch failure every request of the batch
    is retried (where the runtime offers _retry_embed) or errored before
    the exception propagates: a popped request is in no queue a runtime
    failure can see. Returns True if a forward ran."""
    _sp = stepprof.PROFILER.start("embed")
    journal = rt.journal

    def jfinish(req: Request, reason: str) -> None:
        if journal is not None:
            journal.record("finish", req=req, model=rt.name, reason=reason,
                           tokens=len(req.prompt_tokens))

    batch: List[Request] = []
    while pending and len(batch) < max_batch:
        if pending[0]._retry_at > time.monotonic():
            break  # the head is backing off after a contained fault
        req = pending.popleft()
        if req.cancelled.is_set():
            core.mark_dropped(req.user)
            jfinish(req, "cancelled")
            req.finish(FinishReason.CANCELLED)
            continue
        if req.expired():
            drop_expired(req, core, rt.name, journal=journal)
            continue
        n = len(req.prompt_tokens)
        if n > max_len:
            core.mark_dropped(req.user)
            jfinish(req, "error")
            req.finish(FinishReason.ERROR,
                       error=f"input length {n} exceeds maximum {max_len}")
            continue
        batch.append(req)
    if not batch:
        return False
    for r in batch:
        r.trace_event("embed_batch", tokens=len(r.prompt_tokens))
    longest = max(len(r.prompt_tokens) for r in batch)
    bucket = 32
    while bucket < longest:
        bucket *= 2
    # Two batch sizes per length bucket: a lone request does not pay
    # max_batch rows of compute.
    B = 1 if len(batch) == 1 else max_batch
    tokens = np.zeros((B, bucket), np.int32)
    lens = np.zeros((B,), np.int32)
    for i, r in enumerate(batch):
        tokens[i, :len(r.prompt_tokens)] = r.prompt_tokens
        lens[i] = len(r.prompt_tokens)
    _sp.mark("host_prep")
    t0 = time.monotonic()
    try:
        out_dev = dispatch(B, bucket, tokens, lens)
        _sp.mark("dispatch")
        out = out_dev.float().cpu().numpy()
        _sp.mark("collect")
    except Exception as e:
        retry = getattr(rt, "_retry_embed", None)
        msg = f"embed failed: {e}"
        desync = isinstance(e, WorkerDesyncError)
        for r in batch:
            if not desync and retry is not None and retry(r, msg):
                continue
            core.mark_dropped(r.user)
            jfinish(r, "error")
            r.finish(FinishReason.ERROR, error=rt._poison_msg(r, msg))
        raise
    rt.step_latency_ms = (time.monotonic() - t0) * 1e3
    for i, r in enumerate(batch):
        r.embedding = out[i].tolist()
        r.stats.first_token_at = time.monotonic()
        # Processed tokens count toward the TUI's tok/s.
        rt.tokens_generated += int(lens[i])
        core.mark_done(r.user, tokens=int(lens[i]))
        jfinish(r, "stop")
        r.finish(FinishReason.STOP)
    _sp.mark("detok")
    _sp.finish(T_pad=int(bucket), k_cap=0, n_prefill=len(batch), n_decode=0,
               tokens=int(lens.sum()), padded_tokens=int(B) * int(bucket),
               compiled=False)
    return True


class QueueFullError(Exception):
    """Bounded admission refused an enqueue: the queue (global or this
    user's) is at its --max-queued / --max-queued-per-user cap. Carries
    the Retry-After estimate (seconds) from the observed completion rate,
    so the HTTP layer answers 503/429 instead of queueing without bound."""

    def __init__(self, scope: str, retry_after_s: float, limit: int):
        self.scope = scope  # "queue_full" | "user_queue_full"
        self.retry_after_s = retry_after_s
        self.limit = limit
        super().__init__(
            f"{scope.replace('_', ' ')}: admission cap {limit} reached; "
            f"retry after ~{retry_after_s:.0f}s")


class TokenIdError(ValueError):
    """A token id from the client (Ollama's `context`) or a WAL lies
    outside the model's vocabulary. On the card such an id indexes the
    embedding table past its end: a device-side assert that poisons the
    CUDA context for every user, so it is refused at the door."""


def check_token_ids(cfg, model: str, **named_ids) -> None:
    """Raise TokenIdError unless every id of each named list lies in
    [0, vocab_size) of `cfg` (None: nothing to check against)."""
    if cfg is None:
        return
    for what, ids in named_ids.items():
        ids = [int(t) for t in ids] if ids is not None else []
        if ids and not (0 <= min(ids) and max(ids) < cfg.vocab_size):
            raise TokenIdError(
                f"'{what}' holds a token id outside [0, "
                f"{cfg.vocab_size}) of model '{model}'")


class WorkerDesyncError(RuntimeError):
    """A tensor-parallel status sync reported a worker rank's replay
    failure: device state diverged across ranks. Unlike a local batch
    failure this is never absorbed by a fail-only-this-batch handler:
    the runtime is failed, its requests end with an error, and it is
    reloaded on every rank (engine/spmd.py raises it)."""


class PeerDeadError(WorkerDesyncError):
    """A peer rank's heartbeat went stale mid-sync: the rank is presumed
    dead (process kill, host loss), so the barrier would only time out;
    the in-flight work fails loudly now instead."""


class MigrationError(RuntimeError):
    """A KV migration import could not land (no slot, no pages, a shape
    mismatch, a malformed blob). The caller falls back to recompute
    replay: a failed transfer degrades, it never drops."""


def _decoder_pending(decode) -> List[int]:
    """The ids whose bytes an incremental decoder holds back (none for a
    request without one)."""
    pending = getattr(decode, "pending_ids", None)
    return [int(t) for t in pending()] if pending is not None else []


def request_migration_state(req: Request) -> dict:
    """Everything of a Request that the TARGET of a KV migration needs
    to continue the stream seamlessly: the token history, the
    detokenizer's text and emitted watermark (stop-string holdback
    included), the degradation budgets and the sampling params verbatim.
    The JAX package's wire keys."""
    s = req.sampling
    return {
        "user": req.user, "model": req.model, "kind": req.kind,
        "raw_prompt": req.raw_prompt,
        "prompt_tokens": [int(t) for t in req.prompt_tokens],
        "generated_ids": [int(t) for t in req.generated_ids],
        "replay_gen": int(req._replay_gen),
        "emitted_len": int(req.emitted_len),
        "detok_text": req._detok_text,
        "preemptions": int(req.preemptions),
        "retries": int(req.retries),
        "sampling": {
            "temperature": s.temperature, "top_k": s.top_k,
            "top_p": s.top_p, "repeat_penalty": s.repeat_penalty,
            "presence_penalty": s.presence_penalty,
            "frequency_penalty": s.frequency_penalty,
            "seed": s.seed, "max_tokens": s.max_tokens,
            "stop": list(s.stop), "deadline_ms": s.deadline_ms,
        },
    }


def request_from_migration_state(rid: int, state: dict) -> Request:
    """Rebuild a migrated Request. Sampling fields are set raw: the seed
    was folded on the source, and __post_init__ would fold it again and
    fork the sampled stream."""
    sp = SamplingParams()
    for key, val in (state.get("sampling") or {}).items():
        setattr(sp, key, val)
    sp.stop = tuple(sp.stop or ())
    req = Request(rid, state["user"], state.get("model", ""),
                  [int(t) for t in state.get("prompt_tokens", ())], sp,
                  kind=state.get("kind", "generate"),
                  raw_prompt=state.get("raw_prompt", ""))
    req.generated_ids = [int(t) for t in state.get("generated_ids", ())]
    req._replay_gen = int(state.get("replay_gen", 0))
    req.emitted_len = int(state.get("emitted_len", 0))
    req._detok_text = state.get("detok_text", "")
    req.preemptions = int(state.get("preemptions", 0))
    req.retries = int(state.get("retries", 0))
    return req


def poison_text(req: Request, msg: str) -> str:
    """Error text once the retry budget is spent: the client sees that
    retries happened and stopped on purpose."""
    if req.retries:
        return (f"{msg} (request poisoned after {req.retries} "
                f"retr{'y' if req.retries == 1 else 'ies'})")
    return msg


class JournaledRuntime:
    """The decision-journal seam both runtime kinds share: the owning
    engine attaches its Journal (None records nothing)."""

    journal = None

    def _jrec(self, kind: str, req=None, **fields) -> None:
        """Journal one decision under this runtime's model name."""
        j = self.journal
        if j is not None:
            j.record(kind, req=req, model=self.name,
                     dp_replica=getattr(self, "replica", 0), **fields)

    def _poison_msg(self, req: Request, msg: str) -> str:
        """Journal the poisoning and return its error text."""
        self._jrec("poison", req, retries=req.retries, error=msg[:120])
        return poison_text(req, msg)


class ModelRuntime(JournaledRuntime):
    """Per-model serving state: weights, KV pool, slot table, steps."""

    # Generative runtimes embed too (causal forward, mean pool), as the
    # reference's Ollama backends answer /api/embed on llama models.
    SERVES = ("generate", "embed")

    # Preemption hook, attached by the owning engine when cfg.preempt is
    # on: callable(req) -> bool that returns a victim to the FRONT of its
    # user's queue (False = the hook finished it instead). None =>
    # decode-time exhaustion errors explicitly (kv_exhausted).
    on_preempt = None
    # Deterministic fault injection (testing/faults.py), attached by the
    # engine from cfg.fault_plan.
    fault_plan = None
    # Scheduling policy (engine/scheduler.py) and SLO engine, attached by
    # the owning engine; None orders fcfs and records no SLO.
    policy = None
    slo = None

    # Speculative decoding: the n-gram proposer's lengths and window, and
    # the proposed-token sample after which a user's accept rate counts.
    SPEC_NGRAMS = (3, 2)
    SPEC_LOOKUP_WINDOW = 1024
    SPEC_THROTTLE_SAMPLE = 64
    # A batch of nothing but stalled reservations is broken after this
    # long: the youngest fails with kv_exhausted.
    STALL_BREAK_S = 5.0

    KV_EXHAUSTED_MSG = ("KV page pool exhausted mid-decode and preemption "
                        "is disabled; retry, shorten the prompt, or raise "
                        "--num-pages")

    # This runtime's place in its model's ReplicaSet (0 alone).
    replica = 0

    def __init__(self, name: str, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, device=None, dtype=None,
                 params: Optional[dict] = None,
                 checkpoint_path: Optional[str] = None, mesh=None):
        # An unsupported quantization fails here, before any device work.
        pp = mesh.pp if mesh is not None else 1
        err = validate_quant_config(engine_cfg.weights_dtype, engine_cfg.kv_dtype,
                                    pp=pp,
                                    sp=mesh.shape["seq"] if mesh is not None else 1,
                                    model_names=(name,))
        if err is not None:
            raise ValueError(err)
        # Pipeline parallelism: this rank holds one stage's layers and
        # their KV pages; the forwards run the GPipe schedule
        # (parallel/pipeline.py).
        self._pp = pp
        self.pipe = mesh.pipe if mesh is not None else None
        if pp > 1:
            if model_cfg.num_layers % pp:
                raise ValueError(f"pp={pp} must divide num_layers="
                                 f"{model_cfg.num_layers} ({name})")
            if mesh.shape["seq"] > 1:
                raise ValueError(
                    "pp and sp cannot combine on one runtime: pipeline "
                    "stages and sequence shards contend for the same "
                    "activation layout (use pp x tp, or sp x tp)")
            if model_cfg.num_experts:
                raise ValueError(
                    "pp with an MoE model is not supported: the pipeline "
                    "stage body runs the dense FFN (use ep x tp for MoE)")
            # A stage holds only its layers: an embedding forward would
            # need every stage's. Serve generate only; embeds get the
            # kind gate's clean error.
            self.SERVES = ("generate",)
            log.info("%s: pp=%d runtime serves generate only (embed needs "
                     "every stage's layers)", name, pp)
            want = engine_cfg.pp_microbatches
            micro = pipeline.n_microbatches(engine_cfg.max_slots, pp, want)
            if want and micro != want:
                log.warning("%s: --pp-microbatches %d rounded down to %d, the "
                            "largest divisor of the %d decode slots not above "
                            "it", name, want, micro, engine_cfg.max_slots)
        # Expert parallelism: an MoE model keeps this rank's experts of
        # every layer; a dense one is replicated over the expert axis.
        self.ep, self._ep = _expert_axis(mesh, model_cfg, name)
        stage = self.pipe.stage if self.pipe is not None else 0
        self.name = name
        self.cfg = model_cfg
        # Pristine config: a replicated-group mesh rewrites num_kv_heads
        # below, and a rebuild must start from the unmutated one.
        self._orig_cfg = model_cfg
        self.ecfg = engine_cfg
        self.weights_dtype = engine_cfg.weights_dtype
        self.kv_dtype = engine_cfg.kv_dtype
        self.mesh, self.tp, tp_size = _tensor_axis(mesh, model_cfg)
        self.device = resolve_device(self._home_device(mesh, device))
        # Sequence parallelism: a prompt past the largest prefill bucket
        # prefills in one forward cut over the seq axis (ring attention,
        # models/llama.py forward_prefill_sp); weights and the KV pool
        # are replicated over the axis, so every other op runs alike on
        # every shard. `seq` is this rank's ring (None on rank 0's host
        # state of another replica).
        self._sp = mesh is not None and mesh.shape["seq"] > 1
        self.seq = mesh.seq if mesh is not None else None
        self.dtype = dtype if dtype is not None else DTYPES[engine_cfg.dtype]
        self.tokenizer = load_tokenizer(checkpoint_path)
        if tp_size > model_cfg.num_kv_heads:
            # Replicated-group KV (e.g. qwen2.5's 4 KV heads on tp=8):
            # every rank owns one duplicated head.
            self.cfg = model_cfg = dataclasses.replace(
                model_cfg, num_kv_heads=tp_size)
            log.info("replicated KV heads x%d for tp=%d (%s)",
                     tp_size // self._orig_cfg.num_kv_heads, tp_size, name)
        self._device_state(params, checkpoint_path, tp_size, pp, stage)
        S, MP = engine_cfg.max_slots, engine_cfg.max_pages_per_seq
        self.alloc = kvc.PageAllocator(engine_cfg.num_pages,
                                       engine_cfg.page_size, MP)
        self.prefix_cache = (
            PrefixCache(engine_cfg.page_size, self.alloc, model=name,
                        min_pages=engine_cfg.prefix_cache_min_pages)
            if engine_cfg.prefix_cache else None)
        # Slots mid-prefill: reserved (not schedulable) but not decoding.
        self.reserved_slots: set = set()
        # Slots holding a page reservation: their request spent its
        # preemption budget (or nobody was preemptible) when the pool ran
        # dry, so it keeps slot and pages but sits out dispatches until
        # growth succeeds.
        self._stalled_slots: set = set()
        self._stall_since: Optional[float] = None
        self.slot_req: List[Optional[Request]] = [None] * S
        self.slot_pages: List[List[int]] = [[] for _ in range(S)]
        # Pinned prefix-cache nodes per slot: shared tree pages lead
        # slot_pages, private pages follow.
        self.slot_pins: List[list] = [[] for _ in range(S)]
        self.page_table = np.full((S, MP), kvc.TRASH_PAGE, np.int32)
        self.seq_lens = np.zeros((S,), np.int32)
        self.last_tokens = np.zeros((S,), np.int32)
        self.temp = np.zeros((S,), np.float32)
        self.top_k = np.zeros((S,), np.int32)
        self.top_p = np.ones((S,), np.float32)
        self.rep_pen = np.ones((S,), np.float32)
        self.pres_pen = np.zeros((S,), np.float32)
        self.freq_pen = np.zeros((S,), np.float32)
        self.seeds = np.zeros((S,), np.int32)  # >0 = per-request seed
        self.pending_prefill: collections.deque = collections.deque()
        # Embed requests: stateless batch forwards beside the decode slots.
        self.pending_embed: collections.deque = collections.deque()
        # Admitted prompts whose spans are still being prefilled.
        self.chunking: collections.deque = collections.deque()
        # Requests inside a dispatch right now (cancel() must find them).
        self.inflight_prefill: List[Request] = []
        self._block_ver = -1  # first tick sweeps the loaded blocklist
        # Engine-stream generator for unseeded sampled rows.
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(engine_cfg.seed)
        # Set after a failed step; the engine rebuilds the runtime.
        self._failed = False
        # The decode step timer between dispatch and collect.
        self._sp_decode = None
        g = max(1, engine_cfg.token_granule)
        # A full decode batch plus one granule of prefill always fits.
        self._ragged_budget = -(-max(engine_cfg.max_batch_tokens, S + g) // g) * g
        # Allowed stream totals: a power-of-two ladder over the granule,
        # capped by the budget; the composer trims the last span down to
        # a rung rather than padding up to one.
        ladder, v = [], g
        while v < self._ragged_budget:
            ladder.append(v)
            v *= 2
        ladder.append(self._ragged_budget)
        self._ragged_ladder = ladder
        # The ragged span path is single-stage: a pp > 1 runtime serves
        # the bucketed prefill, the chunks and the pipelined decode.
        self.ragged = pp == 1
        if not self.ragged:
            log.warning("%s: pp=%d serves the bucketed prefill path (the "
                        "ragged forward is single-stage)", name, pp)
        # Speculative decoding: n-gram drafts verified on the span path;
        # user -> [proposed, accepted] feeds the per-user throttle.
        self.spec = (bool(engine_cfg.spec) and self.ragged
                     and engine_cfg.spec_k > 0)
        if engine_cfg.spec and not self.ragged:
            log.warning("%s: --spec needs the ragged attention path; "
                        "speculation disabled on this runtime", name)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rollbacks = 0
        self._spec_user: Dict[str, list] = {}
        self._spec_throttled: set = set()
        # Counters (host side).
        self.tokens_generated = 0
        self.ragged_dispatches = 0
        self.prefill_dispatches = 0
        self.sp_prefill_dispatches = 0
        self.chunk_dispatches = 0
        self.decode_dispatches = 0
        self.decode_steps = 0
        self.preempt_count = 0
        self.retry_count = 0
        self.step_latency_ms = 0.0
        self.prefill_latency_ms = 0.0
        self.ttft_window: collections.deque = collections.deque(maxlen=512)
        self.step_window: collections.deque = collections.deque(maxlen=512)
        # The reference's per-model series, resolved once.
        self._tm_spec_prop = tm.SPEC_TOKENS_TOTAL.labels(model=name, outcome="proposed")
        self._tm_spec_acc = tm.SPEC_TOKENS_TOTAL.labels(model=name, outcome="accepted")
        self._tm_spec_rej = tm.SPEC_TOKENS_TOTAL.labels(model=name, outcome="rejected")
        self._tm_spec_rate = tm.SPEC_ACCEPT_RATE.labels(model=name)
        self._tm_ttft = tm.TTFT_MS.labels(model=name)
        self._tm_tpot = tm.TPOT_MS.labels(model=name)
        self._tm_step = tm.STEP_LATENCY_MS.labels(model=name)
        self._tm_prefill = tm.PREFILL_LATENCY_MS.labels(model=name)
        self._tm_occupancy = tm.BATCH_OCCUPANCY.labels(model=name)
        self._tm_padding = tm.BATCH_PADDING_WASTE.labels(model=name)
        self._tm_pages = tm.KV_PAGES_USED.labels(model=name)
        self._tm_page_util = tm.KV_PAGE_UTILIZATION.labels(model=name)
        self._tm_mfu = tm.MFU.labels(model=name)
        self._tm_tokens = tm.TOKENS_GENERATED_TOTAL.labels(model=name)
        self._tm_prompt_tokens = tm.PROMPT_TOKENS_TOTAL.labels(model=name)
        self._tm_preempt = tm.PREEMPTIONS_TOTAL.labels(model=name)
        self._tm_retries = tm.RETRIES_TOTAL.labels(model=name)
        # MFU: analytic FLOPs per token over the card's bf16 dense peak,
        # looked up by its name; the CPU and cards missing from the table
        # publish 0, never a made-up peak.
        kind = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "")
        self.peak_flops = mfu_model.peak_flops_per_chip(kind)
        if self.device.type == "cuda" and self.peak_flops is None:
            log.warning("%s: no bf16 peak known for %r; MFU publishes 0 "
                        "(set OLLAMAMQ_PEAK_FLOPS)", name, kind)
        self.mfu = 0.0
        # MFU divides by the distinct devices under the mesh: two ranks
        # sharing one card are one card's peak.
        self.n_chips = mesh.n_devices if mesh is not None else 1
        tm.FLOPS_PER_TOKEN.labels(model=name).set(mfu_model.flops_per_token(model_cfg))
        self._tm_occupancy.set(0.0)
        self._tm_mfu.set(0.0)
        tm.HBM_WEIGHT_BYTES.labels(model=name).set(self.param_bytes)
        tm.HBM_KV_BYTES.labels(model=name).set(self.kv_bytes)

    def _home_device(self, mesh, device):
        """The device this runtime's tensors live on: its rank's."""
        return mesh.device if mesh is not None else device

    def _device_state(self, params: Optional[dict], checkpoint_path,
                      tp_size: int, pp: int, stage: int) -> None:
        """This rank's weights, KV pool and repeat-penalty ring on
        self.device, and their bytes (payload plus scales for int8 leaves
        and pools). Params passed in are used as given (already quantized
        or not); a checkpoint or the seed's weights are quantized at build
        time for int8, as the JAX package's load_params does. On a tensor-
        or pipeline-parallel mesh this rank keeps its slice (whole trees
        passed in are cut here)."""
        cfg, ecfg = self._orig_cfg, self.ecfg
        rank = self.tp.rank if self.tp is not None else 0
        expert = self.ep.index if self.ep is not None else 0
        if params is None:
            params = weights.load_params(cfg, checkpoint_path, ecfg.seed,
                                         self.dtype, self.weights_dtype,
                                         self.device, tp=tp_size, rank=rank,
                                         pp=pp, stage=stage, ep=self._ep,
                                         expert_index=expert)
        else:
            params = weights.tp_slice(weights.stage_slice(params, cfg, pp, stage),
                                      cfg, tp_size, rank, self._ep, expert)
        self.params = params
        self.kc, self.vc = kvc.alloc_kv_pool(
            self.cfg, ecfg, self.dtype, self.device, kv_dtype=self.kv_dtype,
            tp=tp_size, layers=self.cfg.num_layers // pp)
        # Repeat-penalty ring of each slot's last-W context token ids
        # (-1 = empty). Row S is a trash row for padding rows' writes.
        self.recent = torch.full((ecfg.max_slots + 1, ecfg.repeat_last_n), -1,
                                 dtype=torch.int32, device=self.device)
        self.param_bytes = sum(nbytes(t) for t in weights.leaves(params))
        self.kv_bytes = nbytes(self.kc) + nbytes(self.vc)

    # -- capacity ----------------------------------------------------------
    def free_slots(self) -> int:
        return sum(r is None and i not in self.reserved_slots
                   for i, r in enumerate(self.slot_req))

    def has_capacity(self, kind: Optional[str] = None) -> bool:
        """Can one more request of `kind` be taken from the scheduler right
        now? Embeds are bounded only by their queue; generates need a
        decode slot and KV pages (unreferenced cached pages count: a full
        cache evicts, never rejects). kind None answers "either"."""
        if self._failed:
            return False
        embed_ok = len(self.pending_embed) < 4 * self.ecfg.max_slots
        if kind == "embed":
            return embed_ok
        evictable = (self.prefix_cache.evictable_pages
                     if self.prefix_cache is not None else 0)
        gen_ok = (len(self.pending_prefill) < 2 * self.ecfg.max_slots
                  and self.free_slots() > 0
                  and self.alloc.free_pages + evictable >= 2)
        return gen_ok if kind == "generate" else (gen_ok or embed_ok)

    def has_work(self) -> bool:
        return (bool(self.pending_prefill) or bool(self.pending_embed)
                or bool(self.chunking)
                or any(r is not None for r in self.slot_req))

    def active_count(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def held_requests(self) -> List[Request]:
        return ([r for r in self.slot_req if r is not None]
                + list(self.pending_prefill) + list(self.pending_embed)
                + list(self.chunking))

    def submit(self, req: Request) -> bool:
        if req.kind == "embed":
            self.pending_embed.append(req)
            return True
        if req._inc_decode is None:
            # Kept across preemption and retry requeues: the replay
            # prompt carries ids the decoder has already seen.
            req._inc_decode = self.tokenizer.make_incremental_decoder()
        self.pending_prefill.append(req)
        return True

    def _fault(self, site: str) -> None:
        """Fault-injection seam at the top of each dispatch: a firing rule
        raises or sleeps BEFORE any device work, so no state is touched."""
        if self.fault_plan is not None:
            self.fault_plan.check(site)

    # -- host -> device ----------------------------------------------------
    def _to_dev(self, arrays, dtype) -> List[torch.Tensor]:
        """Upload host arrays in ONE transfer (packed, then split into
        contiguous views): a tick's metadata is ~20 small arrays."""
        flat = np.concatenate([np.asarray(a, dtype).ravel() for a in arrays])
        dev = torch.from_numpy(flat).to(self.device)
        out, off = [], 0
        for a in arrays:
            n = int(np.asarray(a).size)
            out.append(dev[off:off + n].view(np.asarray(a).shape))
            off += n
        return out

    # -- slot lifecycle ----------------------------------------------------
    def _claim_slot(self, exclude=()) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None and i not in self.reserved_slots and i not in exclude:
                return i
        return None

    def _clear_slot(self, slot: int) -> None:
        """Reset a slot's sampling rows and bookkeeping (the caller
        releases its pages: finish and preempt release differently). A
        parked slot's decode row still runs, at position 0 on the trash
        page: its last token goes to 0 too, so every parked row writes the
        same K/V to the trash slot they share and each rank of a world
        holds the same bytes there (which of several differing rows lands
        in one slot is unspecified)."""
        self.seq_lens[slot] = 0
        self.last_tokens[slot] = 0
        self.temp[slot] = 0.0
        self.top_k[slot] = 0
        self.top_p[slot] = 1.0
        self.rep_pen[slot] = 1.0
        self.pres_pen[slot] = 0.0
        self.freq_pen[slot] = 0.0
        self.seeds[slot] = 0
        self.slot_req[slot] = None
        self._stalled_slots.discard(slot)

    def _finish_slot(self, slot: int, reason: FinishReason, core: MQCore,
                     flush: bool = True, error: str = "") -> None:
        """`flush=False` on the stop-string path: held-back text holds
        the stop sequence the client asked to suppress."""
        req = self.slot_req[slot]
        if req is None:
            return
        pol = self.policy
        extra = ({"predicted_tokens": pol.predict(req)}
                 if pol is not None else {})
        self._jrec("finish", req, reason=reason.value, slot=slot,
                   tokens=len(req.generated_ids), **extra)
        if self.policy is not None and reason in (FinishReason.STOP,
                                                  FinishReason.LENGTH):
            # Served-to-completion outcomes feed the output-length
            # predictor; cancels and errors would teach it client behavior.
            self.policy.observe_finish(req, model=self.name)
        # An installed slot's prompt KV is fully written: its full prompt
        # pages may merge into the prefix cache.
        self._release_slot_pages(slot, req)
        self._clear_slot(slot)
        req.stats.completion_tokens = len(req.generated_ids)
        if reason != FinishReason.CANCELLED and flush:
            chunk = req.flush_text()
            if chunk:
                req.stream.push(StreamItem("token", text=chunk))
        if reason in (FinishReason.STOP, FinishReason.LENGTH):
            core.mark_done(req.user, tokens=len(req.generated_ids))
        else:
            core.mark_dropped(req.user)
        req.finish(reason, error=error)

    def _emit_token(self, slot: int, tok: int, core: MQCore) -> bool:
        """Process one sampled token for a slot. True if the sequence
        continues."""
        req = self.slot_req[slot]
        if req is None:
            return False
        if req.cancelled.is_set() or req.stream.overflowed:
            self._finish_slot(slot, FinishReason.CANCELLED, core)
            return False
        if tok == self.tokenizer.eos_id:
            self._finish_slot(slot, FinishReason.STOP, core)
            return False
        req.generated_ids.append(tok)
        # Counted where the token joins the reply, so the series equals
        # the replies' eval_count (first tokens included, EOS excluded).
        self._tm_tokens.inc()
        if not req.stats.first_token_at:
            req.stats.first_token_at = time.monotonic()
            self.ttft_window.append(req.stats.ttft_ms)
            self._tm_ttft.observe(req.stats.ttft_ms)
            if self.slo is not None:
                self.slo.record("ttft", req.stats.ttft_ms)
            req.trace_event("first_token", ttft_ms=round(req.stats.ttft_ms, 3))
        elif len(req.generated_ids) % DECODE_EVENT_EVERY == 0:
            req.trace_event("decode", tokens=len(req.generated_ids))
        text = req._inc_decode(tok)
        chunk = req.emit_text(text) if text else ""
        if chunk is None:  # stop string fired: suppress held-back text
            self._finish_slot(slot, FinishReason.STOP, core, flush=False)
            return False
        # Every sampled token is pushed, text or not, so the id stream is
        # complete.
        req.stream.push(StreamItem("token", text=chunk, token_id=tok))
        # A consumer backlog above the high-water mark opens a "stream"
        # span on the trace; falling back under half of it closes it.
        depth = req.stream.depth()
        if not req._stream_stalled and depth >= req.stream.high_water:
            req._stream_stalled = True
            req.trace_event("stream_stall", depth=depth)
        elif req._stream_stalled and depth < req.stream.high_water // 2:
            req._stream_stalled = False
            req.trace_event("stream_resume", depth=depth)
        if len(req.generated_ids) >= req.sampling.max_tokens:
            self._finish_slot(slot, FinishReason.LENGTH, core)
            return False
        max_ctx = min(self.ecfg.max_context, self.cfg.max_seq_len)
        if int(self.seq_lens[slot]) + 1 >= max_ctx:
            self._finish_slot(slot, FinishReason.LENGTH, core)
            return False
        return True

    def _install_slot(self, slot: int, req: Request, n: int, tok: int,
                      core: MQCore) -> None:
        """Activate a prefilled request in its decode slot and emit the
        first sampled token."""
        self._jrec("install", req, slot=slot, n_prompt=n)
        self.slot_req[slot] = req
        self._tm_prompt_tokens.inc(n)
        self.seq_lens[slot] = n
        s = req.sampling
        self.temp[slot] = s.temperature
        self.top_k[slot] = s.top_k
        self.top_p[slot] = s.top_p
        self.rep_pen[slot] = s.repeat_penalty
        self.pres_pen[slot] = s.presence_penalty
        self.freq_pen[slot] = s.frequency_penalty
        self.seeds[slot] = s.seed
        self.tokens_generated += 1
        if self._emit_token(slot, tok, core):
            # Token written at position n by the next step.
            self.last_tokens[slot] = tok

    # -- pages and the prefix cache ----------------------------------------
    def _match_prefix(self, tokens: List[int]):
        """(nodes, pages) of the longest cached prefix, or ([], []) below
        the reuse threshold."""
        nodes, pages = self.prefix_cache.match(tokens)
        if len(nodes) < self.prefix_cache.min_pages:
            return [], []
        return nodes, pages

    def _pc_miss(self) -> None:
        if self.prefix_cache is not None:
            self.prefix_cache.note_miss()

    def _page_state(self) -> dict:
        """The allocator's post-state for page records: the inputs of
        the pages-conserved invariant (free + used + cached == pool)."""
        a = self.alloc
        return {"free": a.free_pages, "used": a.used_pages,
                "cached": a.cached_pages, "pool": a.num_pages - 1}

    def _evict(self, n: int) -> int:
        """Reclaim up to n unreferenced cached pages; journaled."""
        freed = self.prefix_cache.evict(n)
        if freed > 0:
            self._jrec("page_evict", n=freed, **self._page_state())
        return freed

    def _alloc_pages(self, num_tokens: int) -> Optional[List[int]]:
        """alloc() with the prefix cache's eviction backstop: free-list
        exhaustion reclaims unreferenced cached pages (LRU) instead of
        failing admission."""
        if self.fault_plan is not None and self.fault_plan.blocked("alloc"):
            return None  # injected allocation pressure
        pages = self.alloc.alloc(num_tokens)
        if pages is None and self.prefix_cache is not None:
            short = self.alloc.pages_needed(num_tokens) - self.alloc.free_pages
            if short > 0 and self._evict(short) > 0:
                pages = self.alloc.alloc(num_tokens)
        if pages is not None:
            self._jrec("page_alloc", n=len(pages), **self._page_state())
        return pages

    def _alloc_tail(self, held: int, num_tokens: int) -> Optional[List[int]]:
        """Private tail pages for a cache-hit admission already holding
        `held` shared pages; the same eviction backstop."""
        need = self.alloc.pages_needed(num_tokens) - held
        pages = self.alloc.alloc_n(need, held=held)
        if pages is None and self.prefix_cache is not None:
            short = need - self.alloc.free_pages
            if short > 0 and self._evict(short) > 0:
                pages = self.alloc.alloc_n(need, held=held)
        if pages is not None:
            self._jrec("page_alloc", n=len(pages), **self._page_state())
        return pages

    def _extend_pages(self, pages: List[int], new_total_tokens: int) -> bool:
        """Decode-time page growth with the eviction backstop."""
        if self.fault_plan is not None and self.fault_plan.blocked("extend"):
            return False  # injected allocation pressure
        before = len(pages)
        grown = self.alloc.extend(pages, new_total_tokens)
        if not grown and self.prefix_cache is not None:
            need = self.alloc.pages_needed(new_total_tokens) - len(pages)
            if need <= 0 or len(pages) + need > self.alloc.max_pages_per_seq:
                return False  # per-sequence cap: eviction can't help
            if self._evict(need - self.alloc.free_pages) > 0:
                grown = self.alloc.extend(pages, new_total_tokens)
        if grown and len(pages) > before:
            self._jrec("page_alloc", n=len(pages) - before,
                       **self._page_state())
        return grown

    def _release_slot_pages(self, slot: int,
                            req: Optional[Request] = None) -> None:
        """Free a slot's KV pages and reset its page-table row. With the
        prefix cache on, the slot's pins are released and, when `req` is
        given (its prompt KV is fully written), its full prompt pages
        MERGE into the tree instead of returning to the free list."""
        pages = self.slot_pages[slot]
        pc = self.prefix_cache
        if pc is None:
            n_freed = len(pages)
            self.alloc.free(pages)
        else:
            pins = self.slot_pins[slot]
            keep = len(pins)  # shared tree pages lead slot_pages
            if req is not None and req.prompt_tokens:
                full = min(len(req.prompt_tokens) // self.ecfg.page_size,
                           len(pages))
                if full > keep:
                    pc.insert(req.prompt_tokens, pages[:full])
                    keep = full
            n_freed = len(pages) - keep
            self.alloc.free(pages[keep:])
            pc.release(pins)
            self.slot_pages[slot] = []
            self.slot_pins[slot] = []
        if n_freed > 0:
            self._jrec("page_free", n=n_freed, slot=slot, **self._page_state())
        self.page_table[slot, :] = kvc.TRASH_PAGE

    # -- KV page migration (fleet export/import; loop thread only) ---------
    def export_request(self, rid: int):
        """Snapshot and DETACH one installed decode slot for migration.
        (handle, blob), or None when `rid` holds no installed slot (queued
        or mid-prefill work replays cheaply by recompute: only written
        decode state is worth shipping). The detached slot keeps its
        pages, reserved and undispatchable, until release_export resolves
        the two-phase handoff. Runs between a decode collect and the next
        dispatch, so seq_lens and last_tokens agree with the pages."""
        for slot, req in enumerate(self.slot_req):
            if req is not None and req.req_id == rid:
                break
        else:
            return None
        blob = self._migration_snapshot(slot, req)
        self.slot_req[slot] = None
        self.reserved_slots.add(slot)
        self._stalled_slots.discard(slot)
        return {"slot": slot, "req": req}, blob

    def _migration_snapshot(self, slot: int, req: Request) -> dict:
        """The portable state of one decode slot: its page run (the int8
        payload and scale rows of an int8 pool), the decode cursor (the
        written kv_len and the pending last token, the install
        convention), the penalty ring row, the request state and the
        scheduler predictor's view of the user."""
        pages = list(self.slot_pages[slot])
        data = kvc.gather_page_run(self.kc, self.vc, pages,
                                   self.ecfg.page_size)
        blob = {
            "version": 1, "kind": "stream", "model": self.name,
            "kv_dtype": self.kv_dtype, "page_size": self.ecfg.page_size,
            "num_layers": self.cfg.num_layers,
            "num_kv_heads": self.cfg.num_kv_heads,
            "head_dim": self.cfg.head_dim,
            "kv_len": int(self.seq_lens[slot]),
            "last_token": int(self.last_tokens[slot]),
            "n_pages": len(pages),
            "recent": self.recent[slot].cpu().numpy(),
            "request": request_migration_state(req),
            # In process the live incremental detokenizer rides along
            # (exact stream continuity); the wire packer drops it, and
            # the ids whose bytes it holds back cross the wire instead:
            # the importer primes a fresh decoder with them.
            "_inc_decode": req._inc_decode,
            "decoder_pending": _decoder_pending(req._inc_decode),
            **data,
        }
        pol = self.policy
        if pol is not None:
            blob["predictor"] = pol.predictor.export_user(req.user)
        return blob

    def release_export(self, handle: dict) -> None:
        """Resolve a detached export (commit OR abort): the pages go the
        way a finished slot's do, full prompt pages into the prefix
        cache (a recompute fallback then replays mostly from cache), the
        rest to the free list."""
        slot, req = handle["slot"], handle["req"]
        self.reserved_slots.discard(slot)
        self._release_slot_pages(slot, req)
        self._clear_slot(slot)

    def _blob_fits(self, blob: dict, kind: str) -> bool:
        if kind == "stream" and not (
                np.shape(blob.get("recent")) == (self.recent.shape[1],)
                and 0 <= int(blob.get("kv_len", -1))
                <= int(blob.get("n_pages", 0)) * self.ecfg.page_size):
            return False
        return (blob.get("kind") == kind
                and int(blob.get("page_size", -1)) == self.ecfg.page_size
                and blob.get("kv_dtype") == self.kv_dtype
                and int(blob.get("num_layers", -1)) == self.cfg.num_layers
                and int(blob.get("num_kv_heads", -1)) == self.cfg.num_kv_heads
                and int(blob.get("head_dim", -1)) == self.cfg.head_dim)

    def check_migration_ids(self, blob: dict, req: Request) -> None:
        """Raise TokenIdError unless every id a migrated stream brings
        lies in this model's vocabulary: its prompt and generated ids,
        the pending last token, the penalty ring's entries (-1 marks
        an empty one) and the ids its decoder held back. A blob may come from any caller of the import
        route, and on the card an id past the table's end is a
        device-side assert that poisons the context for every member of
        the process."""
        ring = np.asarray(blob.get("recent", ()), np.int64).reshape(-1)
        check_token_ids(self.cfg, self.name, prompt=req.prompt_tokens,
                        generated=req.generated_ids,
                        last_token=[blob.get("last_token", -1)],
                        recent=ring[ring != -1].tolist(),
                        decoder_pending=blob.get("decoder_pending"))

    def import_request(self, blob: dict, req: Request) -> bool:
        """Install a migrated stream into a fresh slot: allocate a run of
        the same length, copy the shipped pages into this pool in place,
        set the slot's penalty ring and page-table row, and resume the
        decode cursor where the source froze it. No token is recomputed:
        the next decode step reads the copied pages. False when the
        blob's shape does not fit this runtime or capacity is gone (the
        caller falls back to recompute); TokenIdError when it carries an
        id outside the vocabulary."""
        if not self._blob_fits(blob, "stream"):
            return False
        self.check_migration_ids(blob, req)
        n = int(blob["n_pages"])
        if n <= 0 or n > self.alloc.max_pages_per_seq:
            return False
        slot = self._claim_slot()
        if slot is None:
            return False
        pages = self._alloc_tail(0, n * self.ecfg.page_size)
        if pages is None:
            return False
        kvc.scatter_page_run(self.kc, self.vc, pages, self.ecfg.page_size,
                             blob)
        self.recent[slot] = torch.as_tensor(
            np.asarray(blob["recent"], np.int32), device=self.device)
        self.slot_pages[slot] = pages
        self.slot_pins[slot] = []
        self.page_table[slot, :] = kvc.make_page_table_row(
            pages, self.ecfg.max_pages_per_seq)
        s = req.sampling
        self.seq_lens[slot] = int(blob["kv_len"])
        self.last_tokens[slot] = int(blob["last_token"])
        self.temp[slot] = s.temperature
        self.top_k[slot] = s.top_k
        self.top_p[slot] = s.top_p
        self.rep_pen[slot] = s.repeat_penalty
        self.pres_pen[slot] = s.presence_penalty
        self.freq_pen[slot] = s.frequency_penalty
        self.seeds[slot] = s.seed
        if req._inc_decode is None:
            # Over the wire: a fresh decoder, primed with the bytes the
            # source's decoder held back (a blob from the JAX package
            # carries none, and its stream continues as it did there).
            req._inc_decode = self.tokenizer.make_incremental_decoder()
            for tok in blob.get("decoder_pending") or ():
                req._inc_decode(int(tok))
        pol = self.policy
        if pol is not None and blob.get("predictor"):
            pol.predictor.import_user(req.user, blob["predictor"])
        # Dispatchable from here on: every row above is set.
        self.slot_req[slot] = req
        self._jrec("install", req, slot=slot,
                   n_prompt=len(req.prompt_tokens))
        return True

    def export_prefix(self, tokens: List[int]):
        """Affinity-miss prefix shipping, source side: the longest cached
        full-page prefix of `tokens` as a blob (its pages pinned only for
        the device-to-host copy). None when nothing is cached."""
        pc = self.prefix_cache
        if pc is None:
            return None
        nodes, pages = pc.match(list(tokens))
        if not pages:
            return None
        pc.pin(nodes)
        try:
            data = kvc.gather_page_run(self.kc, self.vc, pages,
                                       self.ecfg.page_size)
        finally:
            pc.release(nodes)
        ps = self.ecfg.page_size
        return {
            "version": 1, "kind": "prefix", "model": self.name,
            "kv_dtype": self.kv_dtype, "page_size": ps,
            "num_layers": self.cfg.num_layers,
            "num_kv_heads": self.cfg.num_kv_heads,
            "head_dim": self.cfg.head_dim,
            "n_pages": len(pages),
            "prefix_tokens": [int(t) for t in tokens[:len(pages) * ps]],
            **data,
        }

    def import_prefix(self, blob: dict) -> int:
        """Affinity-miss prefix shipping, target side: land shipped prefix
        pages in this pool and merge them into the radix tree, so the
        request admitted next prefills only its tail. Plain alloc_n (no
        eviction backstop): a remote prefix never evicts cache earned
        here. Returns the pages adopted (0: nothing done)."""
        pc = self.prefix_cache
        if pc is None or not self._blob_fits(blob, "prefix"):
            return 0
        n = int(blob["n_pages"])
        pages = self.alloc.alloc_n(n) if n > 0 else None
        if pages is None:
            return 0
        self._jrec("page_alloc", n=n, **self._page_state())
        kvc.scatter_page_run(self.kc, self.vc, pages, self.ecfg.page_size,
                             blob)
        return pc.insert([int(t) for t in blob["prefix_tokens"]], pages)

    # -- speculative decoding ----------------------------------------------
    def _spec_eligible(self, req: Request) -> bool:
        """Only rows whose sampling the greedy verifier reproduces exactly
        speculate: temperature 0 and neutral penalties (a penalized
        argmax depends on the ring at each draft position). Throttled
        users sit out."""
        s = req.sampling
        return (s.temperature == 0.0 and s.repeat_penalty == 1.0
                and s.presence_penalty == 0.0 and s.frequency_penalty == 0.0
                and req.user not in self._spec_throttled)

    def _propose_drafts(self, req: Request, slot: int) -> List[int]:
        """Prompt-lookup drafts: the tokens that followed the most recent
        earlier occurrence of the context's trailing n-gram (n in
        SPEC_NGRAMS, longest first), capped at spec_k, the request's
        remaining budget and the context ceiling. [] when nothing
        matches."""
        k = self.ecfg.spec_k
        remaining = req.sampling.max_tokens - len(req.generated_ids) - 1
        max_ctx = min(self.ecfg.max_context, self.cfg.max_seq_len)
        pos = int(self.seq_lens[slot])
        k = min(k, remaining, max_ctx - pos - 2)
        if k <= 0:
            return []
        # The full history as the decoder saw it: a preempted request
        # folded its streamed ids into prompt_tokens.
        ctx = req.prompt_tokens + req.generated_ids[req._replay_gen:]
        lo = max(0, len(ctx) - self.SPEC_LOOKUP_WINDOW)
        for n in self.SPEC_NGRAMS:
            if len(ctx) - lo < n + 1:
                continue
            key = ctx[-n:]
            for s in range(len(ctx) - n - 1, lo - 1, -1):
                if ctx[s:s + n] == key:
                    drafts = ctx[s + n:s + n + k]
                    if drafts:
                        return list(drafts)
                    break
        return []

    def _note_spec_outcome(self, req: Request, proposed: int,
                           accepted: int) -> None:
        """Totals and the per-user throttle: a user whose drafts keep
        being rejected stops paying for their verify tokens."""
        self.spec_proposed += proposed
        self.spec_accepted += accepted
        self._tm_spec_prop.inc(proposed)
        self._tm_spec_acc.inc(accepted)
        self._tm_spec_rej.inc(proposed - accepted)
        if self.spec_proposed:
            self._tm_spec_rate.set(round(self.spec_accepted / self.spec_proposed, 4))
        row = self._spec_user.setdefault(req.user, [0, 0])
        row[0] += proposed
        row[1] += accepted
        min_rate = self.ecfg.spec_min_accept
        if (min_rate > 0 and row[0] >= self.SPEC_THROTTLE_SAMPLE
                and row[1] / row[0] < min_rate
                and req.user not in self._spec_throttled):
            self._spec_throttled.add(req.user)
            log.info("%s: speculation throttled for user %s (accept rate "
                     "%.2f < %.2f over %d proposed)", self.name, req.user,
                     row[1] / row[0], min_rate, row[0])

    def _rollback_spec(self, slot: int, req: Request, kv_before: int,
                       kv_after: int) -> None:
        """Release the pages of rejected drafts: the slot keeps the pages
        its accepted context needs, never fewer than its shared prefix
        pages. The page-table row is rewritten before the next dispatch,
        so no later step writes through a freed page."""
        self.spec_rollbacks += 1
        keep = len(self.slot_pins[slot])
        freed = self.alloc.rollback_to(self.slot_pages[slot], kv_after, keep=keep)
        if freed:
            self.page_table[slot, :] = kvc.make_page_table_row(
                self.slot_pages[slot], self.ecfg.max_pages_per_seq)
        self._jrec("spec_rollback", req, slot=slot, kv_before=kv_before,
                   kv_after=kv_after, freed=freed, **self._page_state())

    def _drop_expired_slot(self, slot: int, core: MQCore) -> None:
        """An expired request never burns a k-token verify span."""
        tm.DEADLINE_DROPS_TOTAL.labels(model=self.name).inc()
        tm.SHED_TOTAL.labels(reason="deadline").inc()
        self._jrec("deadline_drop", self.slot_req[slot],
                   slack_ms=round(_slack_ms(self.slot_req[slot]), 3))
        self._finish_slot(slot, FinishReason.DEADLINE, core,
                          error="deadline expired before completion")

    # -- preemption with recompute -----------------------------------------
    def _pick_victim(self, core: MQCore) -> Optional[int]:
        """Victim slot for a preemption. Eligibility stays here: never the
        VIP, never a request past its preemption budget; stalled
        reservation-holders under budget qualify (they hold pages too).
        The preference among the eligible is the policy's victim_key (max
        wins); fcfs (or no policy) keys on the user with the most served
        requests, the youngest arrival breaking ties. None = nobody is
        preemptible."""
        try:
            snap = core.snapshot()
        except Exception:  # noqa: BLE001 — an age-only pick beats none
            snap = {}
        vip, users = snap.get("vip"), snap.get("users", {})
        best, best_key = None, None
        for i, r in enumerate(self.slot_req):
            if r is None or r.preemptions >= self.ecfg.preempt_max:
                continue
            if vip is not None and r.user == vip:
                continue
            served = users.get(r.user, {}).get("processed", 0)
            key = (self.policy.victim_key(r, served) if self.policy is not None
                   else (served, r.stats.enqueued_at))
            if best_key is None or key > best_key:
                best, best_key = i, key
        pol = self.policy
        if best is not None and pol is not None and pol.name != "fcfs":
            victim = self.slot_req[best]
            self._jrec("sched", victim, policy=pol.name, point="victim",
                       predicted=pol.predict(victim),
                       score=round(pol.remaining(victim), 3))
        return best

    def _preempt_slot(self, slot: int, core: MQCore) -> None:
        """Evict `slot` for recompute: the replay prompt is prompt +
        generated tokens; the WRITTEN pages merge into the prefix cache,
        the rest are freed, and the request goes to the engine's
        requeue-front hook. Its stream, detokenizer and generated ids
        survive, so the client sees one seamless stream."""
        req = self.slot_req[slot]
        self.preempt_count += 1
        self._tm_preempt.inc()
        req.preemptions += 1
        # KV is written for every replay token but the last sampled one
        # (its write belongs to the step that never ran); the replay
        # prefill recomputes it and samples the NEXT token.
        replay = req.prompt_tokens + req.generated_ids[req._replay_gen:]
        written = len(replay) - 1 if req.generated_ids else len(replay)
        req.trace_event("preempt", slot=slot, tokens=written,
                        n=req.preemptions)
        if self.journal is not None:
            # Decision inputs: pool pressure, the victim's fair-share
            # standing and the VIP it must never be.
            try:
                snap = core.snapshot()
            except Exception:  # noqa: BLE001 — the record goes out anyway
                snap = {}
            served = snap.get("users", {}).get(req.user, {}).get("processed")
            self._jrec("preempt", req, slot=slot, why="kv_pressure",
                       n=req.preemptions, free_pages=self.alloc.free_pages,
                       victim_served=served, vip=snap.get("vip"))
        # Cut to the written tokens for the tree insert only.
        req.prompt_tokens = replay[:written]
        self._release_slot_pages(slot, req if written else None)
        req.prompt_tokens = replay
        req._replay_gen = len(req.generated_ids)
        self._clear_slot(slot)
        if self.on_preempt is not None:
            self.on_preempt(req)  # False => the hook finished it

    def _page_exhausted(self, slot: int, need_tokens: int,
                        core: MQCore) -> None:
        """Decode-time growth failed for `slot`: preempt victims until it
        grows, hold a stalled reservation, or (preemption off) error
        explicitly as kv_exhausted. The per-sequence cap is an honest
        LENGTH."""
        pages = self.slot_pages[slot]
        if (self.alloc.pages_needed(need_tokens) > self.alloc.max_pages_per_seq
                or len(pages) >= self.alloc.max_pages_per_seq):
            self._finish_slot(slot, FinishReason.LENGTH, core)
            return
        if self.on_preempt is None or not self.ecfg.preempt:
            tm.SHED_TOTAL.labels(reason="kv_exhausted").inc()
            self._finish_slot(slot, FinishReason.KV_EXHAUSTED, core,
                              error=self.KV_EXHAUSTED_MSG)
            return
        # At most one victim per occupied slot: a persistent extend
        # failure cannot spin here.
        for _ in range(len(self.slot_req)):
            victim = self._pick_victim(core)
            if victim is None:
                break
            self._preempt_slot(victim, core)
            if self.slot_req[slot] is None:
                return  # this slot was the victim
            if self._extend_pages(pages, need_tokens):
                self._stalled_slots.discard(slot)
                return
        self.slot_req[slot].trace_event("kv_stall", pages=len(pages))
        self._jrec("kv_stall", self.slot_req[slot], slot=slot,
                   free_pages=self.alloc.free_pages, need=need_tokens)
        self._stalled_slots.add(slot)

    def _break_stall_deadlock(self, core: MQCore) -> None:
        """Every active slot has been a stalled reservation for
        STALL_BREAK_S: nothing can finish to free pages. Fail the
        youngest with the explicit exhaustion error."""
        youngest = max(self._stalled_slots,
                       key=lambda i: self.slot_req[i].stats.enqueued_at)
        tm.SHED_TOTAL.labels(reason="kv_exhausted").inc()
        log.warning("breaking KV-reservation deadlock: failing slot %d "
                    "(req %d)", youngest, self.slot_req[youngest].req_id)
        self._finish_slot(youngest, FinishReason.KV_EXHAUSTED, core,
                          error=self.KV_EXHAUSTED_MSG)

    def _retry_stalled(self, need_extra: int) -> None:
        """Reservation-holders first: pages may have freed since they
        stalled, and growth puts them back into the batch."""
        for i in sorted(self._stalled_slots):
            if self.slot_req[i] is None:
                self._stalled_slots.discard(i)
            elif self._extend_pages(self.slot_pages[i],
                                    int(self.seq_lens[i]) + need_extra):
                self._stalled_slots.discard(i)

    # -- fault-retry containment -------------------------------------------
    def _retry_requeue(self, req: Request, msg: str,
                       queue: Optional[collections.deque] = None) -> bool:
        """Queue a fault-implicated request for ONE more attempt (front of
        its pending queue, exponential backoff). False once its budget is
        spent or it is cancelled: the caller errors it."""
        if req.retries >= self.ecfg.step_retries or req.cancelled.is_set():
            return False
        req.retries += 1
        self.retry_count += 1
        self._tm_retries.inc()
        req._retry_at = time.monotonic() + (
            self.ecfg.retry_backoff_s * (2 ** (req.retries - 1)))
        req.trace_event("retry", error=msg[:200], n=req.retries)
        self._jrec("retry", req, n=req.retries, error=msg[:120])
        (self.pending_prefill if queue is None else queue).appendleft(req)
        return True

    def _retry_embed(self, req: Request, msg: str) -> bool:
        return self._retry_requeue(req, msg, self.pending_embed)

    # -- admission ---------------------------------------------------------
    def _admit_ragged(self, core: MQCore) -> bool:
        """Claim a reserved slot + the prompt's page allocation for each
        pending prompt and queue it on `chunking`: every prefill rides the
        span path. A prefix-cache hit pins its shared pages and starts the
        span at the cached page boundary."""
        if self.policy is not None:
            # Decision point (a): slot-admission order out of the released
            # queue (fcfs: FIFO, untouched).
            self.policy.reorder_pending(self.pending_prefill)
        did = False
        largest = self.ecfg.prefill_buckets[-1]
        while self.pending_prefill:
            req = self.pending_prefill[0]
            if req.cancelled.is_set():
                self.pending_prefill.popleft()
                core.mark_dropped(req.user)
                self._jrec("finish", req, reason="cancelled")
                req.finish(FinishReason.CANCELLED)
                continue
            if req._retry_at > time.monotonic():
                break  # the head is backing off after a contained fault
            if req.expired():
                self.pending_prefill.popleft()
                drop_expired(req, core, self.name, journal=self.journal)
                continue
            n = len(req.prompt_tokens)
            max_prompt = min(self.ecfg.max_context - 1, self.cfg.max_seq_len - 1)
            if n > max_prompt or n == 0:
                self.pending_prefill.popleft()
                core.mark_dropped(req.user)
                self._jrec("finish", req, reason="error")
                req.finish(FinishReason.ERROR, error=(
                    f"prompt length {n} exceeds maximum {max_prompt}" if n
                    else "empty prompt"))
                continue
            if self._sp and n > largest:
                # A long prompt on a sequence-parallel mesh takes the
                # one-shot ring-attention prefill (its activations cut
                # over the seq axis; the ragged stream's do not), past
                # the prefix cache.
                slot = self._claim_slot()
                if slot is None:
                    return did
                pages = self._alloc_pages(n + 1)
                if pages is None:
                    return did
                self.pending_prefill.popleft()
                self._pc_miss()
                req.stats.prefill_started_at = time.monotonic()
                self.slot_pages[slot] = pages
                self._prefill_sp(req, slot, n, core)
                return True
            nodes, shared = [], []
            if self.prefix_cache is not None:
                nodes, shared = self._match_prefix(req.prompt_tokens)
            slot = self._claim_slot()
            if slot is None:
                break
            if nodes:
                # Pin BEFORE the tail allocation: its eviction backstop
                # must never reclaim the pages just matched.
                self.prefix_cache.pin(nodes)
                tail = self._alloc_tail(len(shared), n + 1)
                if tail is None:
                    self.prefix_cache.release(nodes)
                    break  # wait for frees
                prefix_len = len(shared) * self.ecfg.page_size
                self.slot_pins[slot] = list(nodes)
                self.slot_pages[slot] = list(shared) + tail
                self.prefix_cache.note_hit(prefix_len)
                req.trace_event("prefix_hit", cached_tokens=prefix_len, tokens=n)
            else:
                pages = self._alloc_pages(n + 1)
                if pages is None:
                    break  # pool exhausted; retry after frees
                self._pc_miss()
                self.slot_pages[slot] = pages
                prefix_len = 0
            self.pending_prefill.popleft()
            req.stats.prefill_started_at = time.monotonic()
            req._chunk_pos = req._chunk_base = prefix_len
            # The row stays OFF the shared page table until install: decode
            # steps write through self.page_table, and a reserved slot must
            # keep pointing at the trash page meanwhile.
            req._pt_row = kvc.make_page_table_row(self.slot_pages[slot],
                                                  self.ecfg.max_pages_per_seq)
            req._prefill_slot = slot
            self.reserved_slots.add(slot)
            self.chunking.append(req)
            did = True
        return did

    def _drop_chunking(self, req: Request) -> None:
        """Remove a span-path request: release its pages (unpinning any
        shared ones) and its reservation."""
        slot = req._prefill_slot
        self.chunking.remove(req)
        self._release_slot_pages(slot)
        self.reserved_slots.discard(slot)

    # -- ragged tick -------------------------------------------------------
    def step_ragged(self, core: MQCore) -> bool:
        """ONE ragged mixed-batch tick: admit pending prompts, then pack
        every live decode slot (one token each, or with spec a (1 + k)
        token verify span) plus as many prefill-span tokens as the token
        budget allows into a single dispatch. True when a mixed dispatch
        ran (decode slots advanced inside it); False leaves decode to
        step_decode_dispatch."""
        # Step profiler: phases are contiguous marks of one timer; an early
        # return or a failed dispatch abandons it (no partial sample).
        _sp = stepprof.PROFILER.start("ragged")
        self._admit_ragged(core)
        if not self.chunking and not self.spec:
            return False
        if not self.chunking and not any(r is not None for r in self.slot_req):
            return False

        # Decode-row page headroom (reservation-holders first). A draft
        # span claims its pages optimistically and rolls back after the
        # verify; a draft is dropped, never stalled on, when the pool
        # cannot cover it.
        self._retry_stalled(1)
        spec_plan: Dict[int, List[int]] = {}
        n_active = sum(1 for i, r in enumerate(self.slot_req)
                       if r is not None and i not in self._stalled_slots)
        spec_budget = self._ragged_budget - n_active
        for i, r in enumerate(self.slot_req):
            if r is None or i in self._stalled_slots:
                continue
            drafts: List[int] = []
            if self.spec and self._spec_eligible(r):
                if r.expired():
                    self._drop_expired_slot(i, core)
                    continue
                drafts = self._propose_drafts(r, i)[:max(0, spec_budget)]
            need = int(self.seq_lens[i]) + 1 + len(drafts)
            if drafts and not self._extend_pages(self.slot_pages[i], need):
                drafts = []
                need = int(self.seq_lens[i]) + 1
            if not drafts and not self._extend_pages(self.slot_pages[i], need):
                self._page_exhausted(i, need, core)
            if self.slot_req[i] is not None and i not in self._stalled_slots:
                self.page_table[i, :] = kvc.make_page_table_row(
                    self.slot_pages[i], self.ecfg.max_pages_per_seq)
                if drafts:
                    spec_plan[i] = drafts
                    spec_budget -= len(drafts)
                    self._jrec("speculate", r, slot=i, k=len(drafts),
                               source="ngram")
        if not self.chunking and not spec_plan:
            return False  # nothing multi-token this tick: decode runs fused

        # Decode and verify rows first (the ladder trim below only ever
        # shortens prefill tails), then prefill spans in FIFO order until
        # the budget runs out. A verify row carries its drafts in place
        # of the chunk position.
        rows: List[tuple] = []  # (kind, slot, req, chunk_pos | drafts, span)
        for i, r in enumerate(self.slot_req):
            if r is not None and i not in self._stalled_slots:
                d = spec_plan.get(i)
                rows.append(("spec", i, r, d, 1 + len(d)) if d
                            else ("decode", i, r, 0, 1))
        n_decode = len(rows)
        fixed_tokens = sum(span for *_, span in rows)
        budget = self._ragged_budget - fixed_tokens
        now = time.monotonic()
        # Decision point (b): the order the remaining token budget goes to
        # in-flight prefills (fcfs: FIFO).
        chunk_order = (self.policy.pack_order(self.chunking)
                       if self.policy is not None else list(self.chunking))
        for req in chunk_order:
            if budget <= 0:
                break
            if req.cancelled.is_set() or req.stream.overflowed:
                self._drop_chunking(req)
                core.mark_dropped(req.user)
                self._jrec("finish", req, reason="cancelled")
                req.finish(FinishReason.CANCELLED)
                continue
            if req.expired():
                self._drop_chunking(req)
                drop_expired(req, core, self.name, journal=self.journal)
                continue
            if req._retry_at > now:
                continue  # backing off after a contained fault
            span = min(len(req.prompt_tokens) - req._chunk_pos, budget)
            if span <= 0:
                continue
            rows.append(("prefill", req._prefill_slot, req, req._chunk_pos, span))
            budget -= span
        if len(rows) == n_decode and not spec_plan:
            return False  # no span ready this tick: decode runs fused

        # Dispatch total from the ladder: the largest rung the stream can
        # be TRIMMED down to (tail prefill tokens go next tick), else the
        # next rung up. Verify spans are never trimmed: the lower bound
        # covers every fixed token.
        T_raw = sum(span for *_, span in rows)
        lower = fixed_tokens + (1 if len(rows) > n_decode else 0)
        L = next((v for v in reversed(self._ragged_ladder)
                  if lower <= v <= T_raw), None)
        if L is None:
            L = next(v for v in self._ragged_ladder if v >= T_raw)
        if L < T_raw:
            cut, acc = [], 0
            for row in rows:
                take = min(row[4], L - acc)
                if take <= 0:
                    break
                cut.append(row[:4] + (take,))
                acc += take
            rows = cut

        S = self.ecfg.max_slots
        MP = self.ecfg.max_pages_per_seq
        W = self.ecfg.repeat_last_n
        ps = self.ecfg.page_size
        T_pad = L
        tokens = np.zeros(T_pad, np.int32)
        # Padding tokens: position -1 (attend nothing) and the trash slot.
        tok_seq = np.full(T_pad, min(len(rows), S - 1), np.int32)
        tok_pos = np.full(T_pad, -1, np.int32)
        write_slots = np.zeros(T_pad, np.int32)
        q_start = np.full(S, T_pad, np.int32)
        q_len = np.zeros(S, np.int32)
        kv_len = np.zeros(S, np.int32)
        ring_len = np.zeros(S, np.int32)
        is_first = np.zeros(S, np.int32)
        append = np.zeros(S, np.int32)
        is_spec = np.zeros(S, np.int32)
        seed_rows = np.full((S, W), -1, np.int32)
        slot_ids = np.full(S, S, np.int32)  # padding rows -> trash ring row
        pt_rows = np.full((S, MP), kvc.TRASH_PAGE, np.int32)
        temp = np.zeros(S, np.float32)
        top_k = np.zeros(S, np.int32)
        top_p = np.ones(S, np.float32)
        pen = np.ones(S, np.float32)
        pres = np.zeros(S, np.float32)
        freq = np.zeros(S, np.float32)
        seeds = np.zeros(S, np.int32)

        off = 0
        for idx, (kind, slot, req, cpos, span) in enumerate(rows):
            s = req.sampling
            slot_ids[idx] = slot
            q_start[idx] = off
            q_len[idx] = span
            temp[idx] = s.temperature
            top_k[idx] = s.top_k
            top_p[idx] = s.top_p
            pen[idx] = s.repeat_penalty
            pres[idx] = s.presence_penalty
            freq[idx] = s.frequency_penalty
            seeds[idx] = s.seed
            if kind == "prefill":
                row = req._pt_row
                positions = np.arange(cpos, cpos + span, dtype=np.int32)
                tokens[off:off + span] = req.prompt_tokens[cpos:cpos + span]
                ring_len[idx] = span
                first = cpos == req._chunk_base
                is_first[idx] = first
                if first and cpos > 0:
                    # Prefix-cache hit: the ring opens with the cached
                    # prefix's last W tokens, as a full prefill would.
                    prev = req.prompt_tokens[max(0, cpos - W):cpos]
                    seed_rows[idx, W - len(prev):] = prev
                append[idx] = cpos + span >= len(req.prompt_tokens)
                req.trace_event("prefill_chunk", pos=cpos, tokens=span)
                self._jrec("chunk", req, slot=slot, pos=cpos, tokens=span,
                           cached=req._chunk_base)
            else:
                # A decode row is the slot's input token; a verify row adds
                # its drafts (carried in the chunk position's place),
                # written optimistically at pos + 1.. (rejected positions
                # sit past the rolled-back kv_len).
                if kind == "spec":
                    tokens[off + 1:off + span] = cpos
                    is_spec[idx] = 1
                row = self.page_table[slot]
                cpos = int(self.seq_lens[slot])
                positions = np.arange(cpos, cpos + span, dtype=np.int32)
                tokens[off] = self.last_tokens[slot]
                append[idx] = 1  # ring_len 0: input token already rolled
            tok_seq[off:off + span] = idx
            tok_pos[off:off + span] = positions
            write_slots[off:off + span] = row[positions // ps] * ps + positions % ps
            kv_len[idx] = cpos + span
            pt_rows[idx] = row
            off += span

        prefill_rows = [r for r in rows if r[0] == "prefill"]
        spec_rows = [r for r in rows if r[0] == "spec"]
        T_real = sum(span for *_, span in rows)
        # k_cap in {0, spec_k}: verify dispatches read spec_k + 1 logits
        # per row whatever their draft count.
        k_cap = self.ecfg.spec_k if spec_rows else 0
        self.inflight_prefill = [r[2] for r in prefill_rows]
        # The batch-compose record goes out after the dispatch, so it can
        # carry the accepted-draft count (a failed dispatch records it
        # without).
        batch_fields = dict(
            slots=[r[1] for r in rows], reqs=[r[2].req_id for r in rows],
            batch_size=len(rows), tokens=int(T_real),
            occupancy=round(len(rows) / max(1, S), 4),
            pending=len(self.pending_prefill) + len(self.chunking),
            free_pages=self.alloc.free_pages, mode="ragged",
            padded_tokens=int(T_pad), n_decode=n_decode - len(spec_rows),
            n_prefill=len(prefill_rows))
        if spec_rows:
            batch_fields["n_spec"] = len(spec_rows)
            batch_fields["spec_tokens"] = sum(len(r[3]) for r in spec_rows)
        _sp.mark("host_prep")
        t0 = time.monotonic()
        try:
            packed = self._ragged_dispatch(
                T_pad, k_cap, tokens, tok_seq, tok_pos, write_slots, q_start,
                q_len, kv_len, ring_len, is_first, append, is_spec, seed_rows,
                slot_ids, pt_rows, temp, top_k, top_p, pen, pres, freq, seeds)
            _sp.mark("dispatch")
            toks, n_emit = self._ragged_readback(packed, k_cap)
            _sp.mark("collect")
        except Exception as e:  # noqa: BLE001 — contained to these rows
            self._jrec("batch", **batch_fields)
            self._ragged_failed(rows, e, core)
            return True
        finally:
            self.inflight_prefill = []
        dt = time.monotonic() - t0
        if spec_rows:
            batch_fields["spec_accepted"] = int(sum(
                int(n_emit[idx]) - 1 for idx, r in enumerate(rows)
                if r[0] == "spec"))
        self._jrec("batch", **batch_fields)
        self.ragged_dispatches += 1
        self._tm_padding.set(round((T_pad - T_real) / max(1, T_pad), 4))
        if prefill_rows:
            self.prefill_latency_ms = dt * 1e3
            self._tm_prefill.observe(self.prefill_latency_ms)
        if n_decode:
            self.step_latency_ms = dt * 1e3
            self.step_window.append(self.step_latency_ms)
            self._tm_step.observe(self.step_latency_ms)
            self._tm_tpot.observe(self.step_latency_ms)
            if self.slo is not None:
                self.slo.record("tpot", self.step_latency_ms, n=n_decode)

        for idx, (kind, slot, req, cpos, span) in enumerate(rows):
            if kind == "prefill":
                req._chunk_pos = cpos + span
                if req._chunk_pos >= len(req.prompt_tokens):
                    # Final span: publish the page-table row (decode writes
                    # through it from now on), install, emit.
                    self.chunking.remove(req)
                    self.reserved_slots.discard(slot)
                    self.page_table[slot, :] = req._pt_row
                    self._install_slot(slot, req, len(req.prompt_tokens),
                                       int(toks[idx, 0]), core)
                continue
            if self.slot_req[slot] is not req:
                continue  # finished between compose and emit
            kv_before = int(self.seq_lens[slot]) + span
            for j in range(int(n_emit[idx])):  # 1, or accepted + 1
                if self.slot_req[slot] is not req:
                    break  # EOS, stop string or cap mid-emission
                self.seq_lens[slot] += 1
                self.tokens_generated += 1
                if self._emit_token(slot, int(toks[idx, j]), core):
                    self.last_tokens[slot] = toks[idx, j]
            if kind == "spec":
                proposed, accepted = span - 1, int(n_emit[idx]) - 1
                self._note_spec_outcome(req, proposed, accepted)
                self._jrec("spec_verify", req, slot=slot, proposed=proposed,
                           accepted=accepted, rolled_back=proposed - accepted)
                if proposed > accepted and self.slot_req[slot] is req:
                    # Rejected drafts claimed pages past the accepted
                    # context (a finished stream released everything).
                    self._rollback_spec(slot, req, kv_before,
                                        int(self.seq_lens[slot]) + 1)
        self._note_occupancy()
        mean_ctx = float(np.mean(kv_len[:len(rows)])) if rows else 0.0
        # MFU over EVERY real token the dispatch processed (prefill spans
        # do the same per-token matmuls as decode rows).
        self.mfu = mfu_model.mfu(self.cfg, T_real, dt, self.peak_flops,
                                 n_chips=self.n_chips, context_len=mean_ctx)
        self._tm_mfu.set(self.mfu)
        _sp.mark("detok")
        _sp.mode = "spec_verify" if spec_rows else "ragged"
        _sp.finish(T_pad=int(T_pad), k_cap=int(k_cap),
                   n_prefill=len(prefill_rows),
                   n_decode=n_decode - len(spec_rows), tokens=int(T_real),
                   padded_tokens=int(T_pad), compiled=False)
        return True

    def _note_occupancy(self) -> None:
        """Per-step occupancy and KV-page pressure gauges."""
        self._tm_occupancy.set(self.active_count() / max(1, self.ecfg.max_slots))
        self._tm_pages.set(self.alloc.used_pages)
        self._tm_page_util.set(self.alloc.used_pages / max(1, self.alloc.num_pages - 1))

    def _ragged_dispatch(self, T_pad, k_cap, tokens, tok_seq, tok_pos,
                         write_slots, q_start, q_len, kv_len, ring_len,
                         is_first, append, is_spec, seed_rows, slot_ids,
                         pt_rows, temp, top_k, top_p, pen, pres, freq,
                         seeds):
        """Forward the flattened stream, maintain the penalty ring, sample
        one token per row, and verify each spec row's drafts. Returns the
        device tensor _ragged_readback turns into (toks, n_emit); nothing
        is read back here."""
        # Verify dispatches get their own fault site.
        self._fault("spec_verify" if k_cap else "ragged")
        need_pen, need_mask, need_sample = sampling_flags(
            temp, top_k, top_p, pen, pres, freq)
        (tokens_d, tok_seq_d, tok_pos_d, ws_d, qs_d, ql_d, kv_d, rl_d,
         first_d, app_d, spec_d, seed_rows_d, slots_d, pt_d, tk_d) = self._to_dev(
            [tokens, tok_seq, tok_pos, write_slots, q_start, q_len, kv_len,
             ring_len, is_first, append, is_spec, seed_rows, slot_ids,
             pt_rows, top_k], np.int32)
        temp_d, tp_d, pen_d, pres_d, freq_d = self._to_dev(
            [temp, top_p, pen, pres, freq], np.float32)
        # Every row reads the logit of its span's last token; with k_cap a
        # verify row reads one at EVERY span position, so column j holds
        # the argmax that verifies draft j + 1.
        last = (qs_d + ql_d - 1).clamp(0, T_pad - 1)
        spec = spec_d > 0
        if k_cap:
            j = torch.arange(k_cap + 1, device=self.device)[None, :]
            col = torch.minimum(j, ql_d[:, None] - 1)
            out_idx = torch.where(spec[:, None], (qs_d[:, None] + col).clamp(0, T_pad - 1),
                                  last[:, None])
        else:
            out_idx = last
        logits, _, _ = llama.forward_ragged(
            self.params, self.cfg, tokens_d, tok_seq_d, tok_pos_d, ws_d,
            out_idx, self.kc, self.vc, pt_d, qs_d, ql_d, kv_d,
            self.ecfg.page_size, tp=self.tp, ep=self.ep)
        if k_cap:
            greedy_all = logits.argmax(-1).to(torch.int32)  # [S, k_cap + 1]
            # Draft j + 1 sits right after the span's input token.
            draft_idx = (qs_d[:, None] + 1 + torch.arange(k_cap, device=self.device)[None, :])
            accepted = accept_prefix(tokens_d[draft_idx.clamp(0, T_pad - 1).long()],
                                     greedy_all[:, :k_cap], ql_d - 1)
            accepted = torch.where(spec, accepted, torch.zeros_like(accepted))
            logits = logits[:, -1, :]
            # A verify row's ring rolls by the ACCEPTED count, from one
            # past its input token; never by k.
            roll_n = torch.where(spec, accepted, rl_d)
            base = qs_d + spec.to(torch.int32)
        else:
            roll_n, base = rl_d, qs_d
        # Penalty ring: open from seed_rows on a request's first span,
        # slide each ring by roll_n tokens of its own span (0 for decode
        # rows, whose input token rolled in when it was sampled).
        W = self.recent.shape[1]
        slots_l = slots_d.long()
        rows = torch.where(first_d[:, None] > 0, seed_rows_d, self.recent[slots_l])
        j_w = torch.arange(W, device=self.device)
        cidx = roll_n[:, None] + j_w[None, :] - W
        from_stream = tokens_d[(base[:, None] + cidx).clamp(0, T_pad - 1).long()]
        from_row = torch.gather(rows, 1, (roll_n[:, None] + j_w[None, :]).clamp(0, W - 1).long())
        new_rows = torch.where(cidx >= 0, from_stream, from_row)
        pen_logits = maybe_apply_penalties(logits, new_rows, pen_d, pres_d,
                                           freq_d, need_pen)
        # kv_len IS the position being sampled for every row shape.
        u = (row_uniforms(self.gen, seeds, kv_len, logits.shape[1], self.device)
             if need_sample else None)
        tok = sample_tokens_rowwise(pen_logits, u, temp_d, tk_d, tp_d,
                                    need_mask, need_sample)
        if k_cap:
            # A verify row takes the model's own token past its accepted
            # drafts: what plain greedy would sample next (verify rows
            # are greedy and penalty-free).
            bonus = torch.gather(greedy_all, 1, accepted[:, None].long())[:, 0]
            tok = torch.where(spec, bonus, tok)
        # Rows that emit (decode and verify rows, final prefill spans)
        # roll the final token in; mid-prefill spans do not.
        appended = torch.cat([new_rows[:, 1:], tok[:, None]], dim=1)
        self.recent[slots_l] = torch.where(app_d[:, None] > 0, appended, new_rows)
        if not k_cap:
            return tok[:, None]
        # A verify row emits its accepted drafts (their verifying argmaxes)
        # and the bonus token at column `accepted`.
        col0 = torch.where(spec, greedy_all[:, 0], tok)
        n_emit = torch.where(spec, accepted + 1, torch.ones_like(accepted))
        return torch.cat([col0[:, None], greedy_all[:, 1:], n_emit[:, None]], dim=1)

    @staticmethod
    def _ragged_readback(packed: torch.Tensor, k_cap: int):
        """ONE device-to-host read of a ragged dispatch's result (blocks
        until the device is done): (toks [S, k_cap + 1], n_emit [S]); row
        i emits toks[i, :n_emit[i]]."""
        out = packed.cpu().numpy()
        if not k_cap:
            return out, np.ones(len(out), np.int32)
        return out[:, :-1], out[:, -1]

    def _ragged_failed(self, rows, e: Exception, core: MQCore) -> None:
        """Contain a failed mixed dispatch: prefill spans release their
        reservation and retry from scratch; decode and verify rows fold
        their generated tokens into a replay prompt (preemption semantics:
        the stream resumes byte-identically) and retry too. Past the
        retry budget each is poisoned with an explicit error."""
        log.exception("ragged mixed dispatch failed (%d rows)", len(rows),
                      exc_info=e)
        msg = f"ragged dispatch failed: {e}"
        # A worker desync is no local fault: its rows end with an error,
        # and the exception propagates so the runtime is failed and
        # reloaded on every rank.
        desync = isinstance(e, WorkerDesyncError)
        for kind, slot, req, _cpos, _span in rows:
            if kind == "prefill":
                self._drop_chunking(req)
            else:
                if self.slot_req[slot] is not req:
                    continue
                # Journaled as a preempt: the slot changes hands for a
                # replay-recompute, and the invariant checker must see it.
                self._jrec("preempt", req, slot=slot, why="dispatch_fault",
                           n=req.retries + 1, free_pages=self.alloc.free_pages)
                replay = req.prompt_tokens + req.generated_ids[req._replay_gen:]
                written = len(replay) - 1 if req.generated_ids else len(replay)
                req.prompt_tokens = replay[:written]
                self._release_slot_pages(slot, req if written else None)
                req.prompt_tokens = replay
                req._replay_gen = len(req.generated_ids)
                self._clear_slot(slot)
            if desync or not self._retry_requeue(req, msg):
                core.mark_dropped(req.user)
                req.finish(FinishReason.ERROR, error=self._poison_msg(req, msg))
        if desync:
            raise e

    # -- bucketed prefill and chunks (the pp > 1 path) ---------------------
    # Same-bucket prompts prefill together, padded to this many rows
    # when more than one is ready (each bucket then runs at B 1 or 4).
    MAX_PREFILL_BATCH = 4

    def _bucket_for(self, n: int) -> int:
        """Smallest prefill bucket covering n tokens. A piece past the
        largest bucket must have been routed to the chunked path by the
        caller: answering the largest bucket would truncate the
        forward's view of the prompt, so it fails loudly."""
        for b in self.ecfg.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"piece of {n} tokens exceeds the largest prefill bucket "
            f"{self.ecfg.prefill_buckets[-1]}; oversize prompts must take "
            "the chunked prefill path")

    def _sample_rows(self, logits, rows, positions, temp, top_k, top_p, pen,
                     pres, freq, seeds):
        """Penalties over each row's ring `rows` [B, W], then one token
        per row: the sampling of a prefill or a chunk dispatch. Seeded
        rows draw at `positions` (host), the position being sampled."""
        need_pen, need_mask, need_sample = sampling_flags(
            temp, top_k, top_p, pen, pres, freq)
        tk_d, = self._to_dev([top_k], np.int32)
        temp_d, tp_d, pen_d, pres_d, freq_d = self._to_dev(
            [temp, top_p, pen, pres, freq], np.float32)
        pen_logits = maybe_apply_penalties(logits, rows, pen_d, pres_d,
                                           freq_d, need_pen)
        u = (row_uniforms(self.gen, seeds, positions, logits.shape[1],
                          self.device) if need_sample else None)
        return sample_tokens_rowwise(pen_logits, u, temp_d, tk_d, tp_d,
                                     need_mask, need_sample)

    def _dispatch_prefill(self, bucket, B, tokens, lens, slot_ids, pt_rows,
                          temp, top_k, top_p, pen, pres, freq,
                          seeds) -> torch.Tensor:
        """One bucketed prefill of B prompts padded to `bucket` (every
        input of the device work, so a worker rank replays the same
        call): forward, the penalty ring opened from each prompt's last W
        tokens, one sampled token per row. Returns the tokens [B] on the
        device."""
        self._fault("prefill")
        tokens_d, lens_d, slots_d, pt_d = self._to_dev(
            [tokens, lens, slot_ids, pt_rows], np.int32)
        ps = self.ecfg.page_size
        if self._pp > 1:
            logits, _, _ = pipeline.pp_forward_prefill(
                self.params, self.cfg, tokens_d, lens_d, self.kc, self.vc,
                pt_d, ps, self.mesh, n_micro=self.ecfg.pp_microbatches)
        else:
            logits, _, _ = llama.forward_prefill(
                self.params, self.cfg, tokens_d, lens_d, self.kc, self.vc,
                pt_d, ps, tp=self.tp, ep=self.ep)
        W = self.recent.shape[1]
        # Ring rows: the last W prompt tokens of each sequence.
        idx = lens_d[:, None] - W + torch.arange(W, device=self.device)[None, :]
        gathered = torch.gather(tokens_d, 1, idx.clamp(0, bucket - 1).long())
        rows = torch.where(idx >= 0, gathered, -1)
        tok = self._sample_rows(logits, rows, lens, temp, top_k, top_p, pen,
                                pres, freq, seeds)
        self.recent[slots_d.long()] = torch.cat([rows[:, 1:], tok[:, None]], 1)
        return tok

    def _dispatch_chunk(self, chunk, tokens, start, cl, slot_id, is_final,
                        is_first, seed_row, pt_row, temp, top_k, top_p, pen,
                        pres, freq, seeds) -> torch.Tensor:
        """One chunk of one long prompt (B = 1, so the pipeline runs a
        single microbatch): its K/V written, attention over the prefix
        and the chunk, the ring slid by the chunk's tokens (opened from
        `seed_row` on a request's first chunk) and, on the final chunk,
        the sampled token rolled in. The token [1] is meaningful only
        for the final chunk."""
        self._fault("chunk")
        tokens_d, start_d, cl_d, pt_d = self._to_dev(
            [tokens, start, cl, pt_row], np.int32)
        ps = self.ecfg.page_size
        if self._pp > 1:
            logits, _, _ = pipeline.pp_forward_prefill_chunk(
                self.params, self.cfg, tokens_d, start_d, cl_d, self.kc,
                self.vc, pt_d, ps, self.mesh,
                n_micro=self.ecfg.pp_microbatches)
        else:
            logits, _, _ = llama.forward_prefill_chunk(
                self.params, self.cfg, tokens_d, start_d, cl_d, self.kc,
                self.vc, pt_d, ps, tp=self.tp, ep=self.ep)
        slot, n_valid = int(slot_id[0]), int(cl[0])
        W = self.recent.shape[1]
        row = (torch.from_numpy(np.asarray(seed_row[0], np.int32)).to(self.device)
               if int(is_first[0]) else self.recent[slot])
        # Slide the window: the ring ++ this chunk's valid tokens, last W.
        row = torch.cat([row, tokens_d[0, :n_valid]])[n_valid:n_valid + W]
        tok = self._sample_rows(logits, row[None], np.asarray(start) + cl,
                                temp, top_k, top_p, pen, pres, freq, seeds)
        if int(is_final[0]):
            row = torch.cat([row[1:], tok])
        self.recent[slot] = row
        return tok

    def _dispatch_prefill_sp(self, T, tokens, lens, slot_ids, pt_rows, temp,
                             top_k, top_p, pen, pres, freq,
                             seeds) -> torch.Tensor:
        """The sequence-parallel prefill of one long prompt padded to T
        (every input of the device work, so each rank of the ring replays
        the same call): forward_prefill_sp writes every position's K/V
        into the slot's pages on this shard, then the penalty ring opens
        from the prompt's last W tokens and one token is sampled, alike
        on every shard. Returns the token [1] on the device."""
        self._fault("sp_prefill")
        tokens_d, lens_d, slots_d, pt_d = self._to_dev(
            [tokens, lens, slot_ids, pt_rows], np.int32)
        logits, _, _ = llama.forward_prefill_sp(
            self.params, self.cfg, tokens_d, lens_d, self.kc, self.vc, pt_d,
            self.ecfg.page_size, self.seq, tp=self.tp, ep=self.ep)
        W = self.recent.shape[1]
        idx = lens_d[:, None] - W + torch.arange(W, device=self.device)[None, :]
        gathered = torch.gather(tokens_d, 1, idx.clamp(0, T - 1).long())
        rows = torch.where(idx >= 0, gathered, -1)
        tok = self._sample_rows(logits, rows, lens, temp, top_k, top_p, pen,
                                pres, freq, seeds)
        self.recent[slots_d.long()] = torch.cat([rows[:, 1:], tok[:, None]], 1)
        return tok

    def _prefill_sp(self, req: Request, slot: int, n: int, core: MQCore) -> None:
        """Run the sequence-parallel prefill of one long prompt and
        install its slot. The caller claimed the slot and its pages. The
        prompt pads to T, a multiple of the largest bucket rounded up to
        a multiple of sp. A failure is contained to this request: its
        pages go back, it is retried once, and a desync re-raises (the
        runtime must fail and reload)."""
        s = req.sampling
        sp = self.mesh.shape["seq"]
        largest = self.ecfg.prefill_buckets[-1]
        unit = -(-largest // sp) * sp
        T = -(-n // unit) * unit
        self.page_table[slot, :] = kvc.make_page_table_row(
            self.slot_pages[slot], self.ecfg.max_pages_per_seq)
        tokens = np.zeros((1, T), np.int32)
        tokens[0, :n] = req.prompt_tokens
        self.inflight_prefill = [req]
        req.trace_event("prefill", mode="sp", tokens=n)
        t0 = time.monotonic()
        try:
            tok = self._dispatch_prefill_sp(
                T, tokens, np.asarray([n], np.int32),
                np.asarray([slot], np.int32), self.page_table[slot:slot + 1],
                np.asarray([s.temperature], np.float32),
                np.asarray([s.top_k], np.int32),
                np.asarray([s.top_p], np.float32),
                np.asarray([s.repeat_penalty], np.float32),
                np.asarray([s.presence_penalty], np.float32),
                np.asarray([s.frequency_penalty], np.float32),
                np.asarray([s.seed], np.int32))
            tok = int(tok.cpu().numpy()[0])
        except Exception as e:  # noqa: BLE001 — contained to this request
            # The slot was never installed, so a failed runtime would not
            # find its pages: release them here, retry once, and keep the
            # other requests in flight.
            log.exception("sequence-parallel prefill failed for req %d",
                          req.req_id, extra={"req_id": req.req_id})
            self._release_slot_pages(slot)
            desync = isinstance(e, WorkerDesyncError)
            msg = f"sp prefill failed: {e}"
            if desync or not self._retry_requeue(req, msg):
                core.mark_dropped(req.user)
                req.finish(FinishReason.ERROR, error=self._poison_msg(req, msg))
            if desync:
                raise  # diverged ranks: the runtime must fail and reload
            return
        finally:
            self.inflight_prefill = []
        self.sp_prefill_dispatches += 1
        self.prefill_latency_ms = (time.monotonic() - t0) * 1e3
        self._tm_prefill.observe(self.prefill_latency_ms)
        self._install_slot(slot, req, n, tok, core)

    def step_prefill(self, core: MQCore) -> bool:
        """Admit pending prompts into free slots: same-bucket prompts
        prefill TOGETHER in one forward (up to MAX_PREFILL_BATCH), which
        collapses the time to first token of a burst of arrivals. A
        prompt past the largest bucket, or one whose prefix is cached,
        hands off to the chunked path. True if anything ran."""
        if self.policy is not None:
            # Decision point (a): slot-admission order (fcfs: FIFO).
            self.policy.reorder_pending(self.pending_prefill)
        batch: List[tuple] = []  # (req, slot, n)
        bucket = None
        claimed: set = set()
        largest = self.ecfg.prefill_buckets[-1]
        MP = self.ecfg.max_pages_per_seq
        while self.pending_prefill and len(batch) < self.MAX_PREFILL_BATCH:
            req = self.pending_prefill[0]
            if req.cancelled.is_set():
                self.pending_prefill.popleft()
                core.mark_dropped(req.user)
                self._jrec("finish", req, reason="cancelled")
                req.finish(FinishReason.CANCELLED)
                continue
            if req._retry_at > time.monotonic():
                break  # the head is backing off after a contained fault
            if req.expired():
                self.pending_prefill.popleft()
                drop_expired(req, core, self.name, journal=self.journal)
                continue
            n = len(req.prompt_tokens)
            max_prompt = min(self.ecfg.max_context - 1, self.cfg.max_seq_len - 1)
            if n > max_prompt or n == 0:
                self.pending_prefill.popleft()
                core.mark_dropped(req.user)
                self._jrec("finish", req, reason="error")
                req.finish(FinishReason.ERROR, error=(
                    f"prompt length {n} exceeds maximum {max_prompt}" if n
                    else "empty prompt"))
                continue
            # A sequence-parallel runtime keeps its one-shot ring-attention
            # forward for a prompt past the largest bucket: no prefix match.
            sp_long = self._sp and n > largest
            nodes, shared = ([], []) if self.prefix_cache is None or sp_long \
                else self._match_prefix(req.prompt_tokens)
            if nodes or n > largest:
                # The chunked path: the uncached tail of a prefix hit, or a
                # prompt past the largest bucket.
                if batch:
                    break  # run the collected batch first; chunk next tick
                slot = self._claim_slot(claimed)
                if slot is None:
                    return False
                if nodes:
                    # Pin BEFORE the tail allocation: its eviction backstop
                    # must never reclaim the pages just matched.
                    self.prefix_cache.pin(nodes)
                    tail = self._alloc_tail(len(shared), n + 1)
                    if tail is None:
                        self.prefix_cache.release(nodes)
                        return False  # wait for frees
                    prefix_len = len(shared) * self.ecfg.page_size
                    self.slot_pins[slot] = list(nodes)
                    self.slot_pages[slot] = list(shared) + tail
                    self.prefix_cache.note_hit(prefix_len)
                    req.trace_event("prefix_hit", cached_tokens=prefix_len,
                                    tokens=n)
                else:
                    pages = self._alloc_pages(n + 1)
                    if pages is None:
                        return False
                    self._pc_miss()
                    self.slot_pages[slot] = pages
                    prefix_len = 0
                self.pending_prefill.popleft()
                req.stats.prefill_started_at = time.monotonic()
                if sp_long:
                    # ONE forward with the sequence cut over the seq axis
                    # instead of serial chunks.
                    self._prefill_sp(req, slot, n, core)
                    return True
                # The row stays OFF the shared page table until the final
                # chunk installs the slot: decode steps write every slot's
                # position through self.page_table, and a reserved slot
                # must keep pointing at the trash page meanwhile.
                req._pt_row = kvc.make_page_table_row(self.slot_pages[slot], MP)
                # One chunk per tick so the decode streams keep flowing.
                req._chunk_pos = req._chunk_base = prefix_len
                req._prefill_slot = slot
                self.reserved_slots.add(slot)
                self.chunking.append(req)
                return True
            b = self._bucket_for(n)
            if bucket is None:
                bucket = b
            elif b != bucket:
                break  # another bucket: next tick's batch
            slot = self._claim_slot(claimed)
            if slot is None:
                break
            pages = self._alloc_pages(n + 1)
            if pages is None:
                break  # pool exhausted; run what we have, retry after frees
            self.pending_prefill.popleft()
            self._pc_miss()
            req.stats.prefill_started_at = time.monotonic()
            self.slot_pages[slot] = pages
            self.page_table[slot, :] = kvc.make_page_table_row(pages, MP)
            claimed.add(slot)
            batch.append((req, slot, n))
        if not batch:
            return False

        # Several prompts pad to MAX_PREFILL_BATCH rows, one to 1: padding
        # rows carry trash-page tables and zero lengths, their ring rows
        # the trash row max_slots.
        S = self.ecfg.max_slots
        B = 1 if len(batch) == 1 else self.MAX_PREFILL_BATCH
        pt_rows = np.full((B, MP), kvc.TRASH_PAGE, np.int32)
        tokens = np.zeros((B, bucket), np.int32)
        lens = np.zeros(B, np.int32)
        temp = np.zeros(B, np.float32)
        top_k = np.zeros(B, np.int32)
        top_p = np.ones(B, np.float32)
        pen = np.ones(B, np.float32)
        pres = np.zeros(B, np.float32)
        freq = np.zeros(B, np.float32)
        seeds = np.zeros(B, np.int32)
        slot_ids = np.full(B, S, np.int32)
        for i, (req, slot, n) in enumerate(batch):
            s = req.sampling
            tokens[i, :n] = req.prompt_tokens
            lens[i] = n
            temp[i], top_k[i], top_p[i] = s.temperature, s.top_k, s.top_p
            pen[i], pres[i], freq[i] = (s.repeat_penalty, s.presence_penalty,
                                        s.frequency_penalty)
            seeds[i] = s.seed
            slot_ids[i] = slot
            pt_rows[i] = self.page_table[slot]
            req.trace_event("prefill", bucket=bucket, tokens=n)
        self.inflight_prefill = [req for req, *_ in batch]
        real_tokens = int(lens.sum())
        # Batch-compose record: who shares this forward and the padded
        # shape it pays for.
        self._jrec("batch", slots=[slot for _, slot, _ in batch],
                   reqs=[req.req_id for req, *_ in batch], bucket=bucket,
                   batch_size=B, tokens=real_tokens,
                   occupancy=round(self.active_count() / max(1, S), 4),
                   pending=len(self.pending_prefill),
                   free_pages=self.alloc.free_pages, mode="bucketed",
                   padded_tokens=int(bucket * B))
        self._tm_padding.set(round(1.0 - real_tokens / max(1, bucket * B), 4))
        t0 = time.monotonic()
        try:
            toks = self._dispatch_prefill(
                bucket, B, tokens, lens, slot_ids, pt_rows, temp, top_k,
                top_p, pen, pres, freq, seeds).cpu().numpy()
        except Exception as e:  # noqa: BLE001 — contained to this batch
            # Free the batch's pages, then give each request one retried
            # dispatch before poisoning it: one bad input or transient
            # fault must neither kill bystanders nor crash-loop.
            log.exception("batched prefill failed (bucket=%d B=%d)", bucket, B)
            desync = isinstance(e, WorkerDesyncError)
            msg = f"prefill failed: {e}"
            for req, slot, _ in batch:
                self._release_slot_pages(slot)
                if desync or not self._retry_requeue(req, msg):
                    core.mark_dropped(req.user)
                    req.finish(FinishReason.ERROR,
                               error=self._poison_msg(req, msg))
            if desync:
                raise  # diverged ranks: the runtime must fail and reload
            return True
        finally:
            self.inflight_prefill = []
        self.prefill_dispatches += 1
        self.prefill_latency_ms = (time.monotonic() - t0) * 1e3
        self._tm_prefill.observe(self.prefill_latency_ms)
        for i, (req, slot, n) in enumerate(batch):
            self._install_slot(slot, req, n, int(toks[i]), core)
        return True

    def step_chunk(self, core: MQCore) -> bool:
        """Advance ONE chunk of the oldest long-prompt prefill. True if a
        chunk ran (the loop interleaves them with decode steps)."""
        if not self.chunking:
            return False
        req = self.chunking[0]
        slot = req._prefill_slot
        n = len(req.prompt_tokens)
        if req.cancelled.is_set() or req.stream.overflowed:
            self._drop_chunking(req)
            core.mark_dropped(req.user)
            self._jrec("finish", req, reason="cancelled")
            req.finish(FinishReason.CANCELLED)
            return True
        if req.expired():
            # No more chunks for a response nobody will wait for.
            self._drop_chunking(req)
            drop_expired(req, core, self.name, journal=self.journal)
            return True
        s = req.sampling
        start = req._chunk_pos
        # Chunk size: the smallest bucket covering the remainder, so a
        # short cache-hit tail does not pay a largest-bucket forward.
        piece = req.prompt_tokens[start:start + self.ecfg.prefill_buckets[-1]]
        cl = len(piece)
        chunk = self._bucket_for(cl)
        tokens = np.zeros((1, chunk), np.int32)
        tokens[0, :cl] = piece
        is_first = int(start == req._chunk_base)
        W = self.ecfg.repeat_last_n
        seed_row = np.full((1, W), -1, np.int32)
        if is_first and start > 0:
            # Prefix-cache hit: the ring opens with the cached prefix's
            # last W tokens, as a full prefill would set it.
            prev = req.prompt_tokens[max(0, start - W):start]
            seed_row[0, W - len(prev):] = prev
        is_final = int(start + cl >= n)
        req.trace_event("prefill_chunk", pos=start, tokens=cl)
        self._jrec("chunk", req, slot=slot, pos=start, tokens=cl,
                   cached=req._chunk_base)
        self.inflight_prefill = [req]
        t0 = time.monotonic()
        try:
            tok = self._dispatch_chunk(
                chunk, tokens, np.asarray([start], np.int32),
                np.asarray([cl], np.int32), np.asarray([slot], np.int32),
                np.asarray([is_final], np.int32),
                np.asarray([is_first], np.int32), seed_row,
                req._pt_row[None, :],
                np.asarray([s.temperature], np.float32),
                np.asarray([s.top_k], np.int32),
                np.asarray([s.top_p], np.float32),
                np.asarray([s.repeat_penalty], np.float32),
                np.asarray([s.presence_penalty], np.float32),
                np.asarray([s.frequency_penalty], np.float32),
                np.asarray([s.seed], np.int32))
            tok = int(tok.cpu().numpy()[0])
        except Exception as e:  # noqa: BLE001 — contained to this request
            # Release the reserved slot's pages (and pinned prefix), retry
            # once from scratch, else poison.
            log.exception("chunked prefill failed for req %d", req.req_id,
                          extra={"req_id": req.req_id})
            self._drop_chunking(req)
            desync = isinstance(e, WorkerDesyncError)
            msg = f"prefill failed: {e}"
            if desync or not self._retry_requeue(req, msg):
                core.mark_dropped(req.user)
                req.finish(FinishReason.ERROR, error=self._poison_msg(req, msg))
            if desync:
                raise  # diverged ranks: the runtime must fail and reload
            return True
        finally:
            self.inflight_prefill = []
        self.chunk_dispatches += 1
        self.prefill_latency_ms = (time.monotonic() - t0) * 1e3
        self._tm_prefill.observe(self.prefill_latency_ms)
        req._chunk_pos = start + cl
        if req._chunk_pos < n:
            return True  # more chunks next tick
        # Final chunk: publish the page-table row (decode may write through
        # it from now on), install the slot, emit the first token.
        self.chunking.remove(req)
        self.reserved_slots.discard(slot)
        self.page_table[slot, :] = req._pt_row
        self._install_slot(slot, req, n, tok, core)
        return True

    # -- decode tick -------------------------------------------------------
    def step_decode(self, core: MQCore, k_steps: int = 1) -> int:
        """Advance all active slots by up to k_steps tokens; returns the
        number of tokens emitted."""
        handle = self.step_decode_dispatch(core, k_steps)
        if handle is None:
            return 0
        return self.step_decode_collect(handle, core)

    def step_decode_dispatch(self, core: MQCore, k_steps: int = 1):
        """Issue k_steps decode steps for every active slot WITHOUT
        reading their tokens back: the returned handle holds the device
        tensor of sampled tokens [k_steps, S]. None when nothing is
        active (or every occupant is a stalled reservation)."""
        if not any(r is not None for r in self.slot_req):
            return None
        # Step profiler: the timer spans dispatch AND collect (the two
        # halves of one step) and rides self._sp_decode between them.
        _sp = stepprof.PROFILER.start("decode")
        self._retry_stalled(k_steps)
        for i, r in enumerate(self.slot_req):
            if r is None or i in self._stalled_slots:
                continue
            need = int(self.seq_lens[i]) + k_steps
            if not self._extend_pages(self.slot_pages[i], need):
                # Never a silent LENGTH: preempt with recompute, stall on a
                # reservation, or error explicitly (kv_exhausted).
                self._page_exhausted(i, need, core)
            if self.slot_req[i] is not None and i not in self._stalled_slots:
                self.page_table[i, :] = kvc.make_page_table_row(
                    self.slot_pages[i], self.ecfg.max_pages_per_seq)
        active = [i for i, r in enumerate(self.slot_req)
                  if r is not None and i not in self._stalled_slots]
        if not active:
            # Only stalled reservations: nothing can finish to free pages.
            # After a grace window, fail the youngest loudly (an in-flight
            # prefill may still unblock them first).
            if self._stalled_slots and not self.chunking:
                now = time.monotonic()
                if self._stall_since is None:
                    self._stall_since = now
                elif now - self._stall_since > self.STALL_BREAK_S:
                    self._break_stall_deadlock(core)
                    self._stall_since = None
            return None
        self._stall_since = None
        t0 = time.monotonic()
        S = self.ecfg.max_slots
        active_mask = np.zeros(S, np.int32)
        active_mask[active] = 1
        need_pen, need_mask, need_sample = sampling_flags(
            self.temp, self.top_k, self.top_p, self.rep_pen, self.pres_pen,
            self.freq_pen)
        _sp.mark("host_prep")
        out = self._dispatch_decode(
            k_steps, self.last_tokens, self.seq_lens, active_mask,
            self.page_table, self.temp, self.top_k, self.top_p, self.rep_pen,
            self.pres_pen, self.freq_pen, self.seeds.copy())
        self.decode_dispatches += 1
        self.decode_steps += k_steps
        _sp.mark("dispatch")
        self._sp_decode = _sp
        return out, active, k_steps, t0

    def _dispatch_decode(self, k_steps, last_tokens, seq_lens, active_mask,
                         page_table, temp, top_k, top_p, pen, pres, freq,
                         seeds) -> torch.Tensor:
        """Issue k_steps fused decode steps from these host arrays (every
        input of the device work, so a tensor-parallel worker replays the
        same call): the device tensor of sampled tokens [k_steps, S]."""
        self._fault("decode")
        S = self.ecfg.max_slots
        need_pen, need_mask, need_sample = sampling_flags(
            temp, top_k, top_p, pen, pres, freq)
        tokens, positions, act_d, pt_d, tk_d = self._to_dev(
            [last_tokens, seq_lens, active_mask, page_table, top_k], np.int32)
        temp_d, tp_d, pen_d, pres_d, freq_d = self._to_dev(
            [temp, top_p, pen, pres, freq], np.float32)
        steps = []
        for j in range(k_steps):
            if self._pp > 1:
                logits, _, _ = pipeline.pp_forward_decode(
                    self.params, self.cfg, tokens, positions, self.kc,
                    self.vc, pt_d, self.ecfg.page_size, self.mesh,
                    n_micro=self.ecfg.pp_microbatches)
            else:
                logits, _, _ = llama.forward_decode(
                    self.params, self.cfg, tokens, positions, self.kc,
                    self.vc, pt_d, self.ecfg.page_size, active=act_d,
                    tp=self.tp, ep=self.ep)
            ring = self.recent[:S]
            pen_logits = maybe_apply_penalties(logits, ring, pen_d, pres_d,
                                               freq_d, need_pen)
            # Seeded rows draw at the position being SAMPLED (one past
            # the incoming token's).
            u = (row_uniforms(self.gen, seeds, seq_lens + j + 1,
                              logits.shape[1], self.device)
                 if need_sample else None)
            nxt = sample_tokens_rowwise(pen_logits, u, temp_d, tk_d, tp_d,
                                        need_mask, need_sample)
            # Roll the sampled token into ACTIVE slots' rings only.
            rolled = torch.cat([ring[:, 1:], nxt[:, None]], dim=1)
            self.recent[:S] = torch.where(act_d[:, None] > 0, rolled, ring)
            steps.append(nxt)
            tokens, positions = nxt, positions + 1
        return torch.stack(steps)

    def step_decode_collect(self, handle, core: MQCore) -> int:
        """Read a dispatched decode chunk's tokens back (this blocks until
        the device is done) and emit them. Step latency (and TPOT) is the
        chunk's wall from dispatch start to the tokens on the host over
        k_steps: eager dispatch launches every kernel from this thread, so
        the launch time is part of each step."""
        toks_d, active, k_steps, t0 = handle
        _sp, self._sp_decode = self._sp_decode, None
        # Mean context BEFORE the emit loop advances seq_lens: the
        # attention term of the per-token FLOPs model.
        mean_ctx = float(np.mean([self.seq_lens[i] for i in active]))
        toks = toks_d.cpu().numpy()  # [K, S]
        t_done = time.monotonic()
        if _sp is not None:
            _sp.mark("collect")
        self.step_latency_ms = (t_done - t0) * 1e3 / k_steps
        self.step_window.append(self.step_latency_ms)
        self._tm_step.observe(self.step_latency_ms)
        # Every active slot gains one token per step: step latency IS the
        # time per output token of each stream in the batch.
        self._tm_tpot.observe(self.step_latency_ms)
        if self.slo is not None:
            self.slo.record("tpot", self.step_latency_ms,
                            n=max(1, len(active) * k_steps))
        emitted = 0
        for k in range(k_steps):
            for i in active:
                if self.slot_req[i] is None:
                    continue  # finished at an earlier k
                tok = int(toks[k, i])
                self.seq_lens[i] += 1
                self.tokens_generated += 1
                emitted += 1
                if self._emit_token(i, tok, core):
                    self.last_tokens[i] = tok
        self._note_occupancy()
        self.mfu = mfu_model.mfu(self.cfg, emitted, t_done - t0, self.peak_flops,
                                 n_chips=self.n_chips, context_len=mean_ctx)
        self._tm_mfu.set(self.mfu)
        if _sp is not None:
            _sp.mark("detok")
            _sp.finish(T_pad=0, k_cap=int(k_steps), n_prefill=0,
                       n_decode=len(active), tokens=emitted,
                       padded_tokens=int(k_steps) * self.ecfg.max_slots,
                       compiled=False)
        return emitted

    def check_cancellations(self, core: MQCore) -> None:
        """Reap cancelled requests and those of users blocked after
        admission (version-gated: no FFI work unless the blocklist
        changed)."""
        self._block_ver = sweep_blocked(core, self.held_requests(), self._block_ver)
        for i, req in enumerate(self.slot_req):
            if req is not None and req.cancelled.is_set():
                self._finish_slot(i, FinishReason.CANCELLED, core)

    # -- embeddings on a generative model ----------------------------------
    def _dispatch_embed(self, B, bucket, tokens, lens) -> torch.Tensor:
        self._fault("embed")
        toks, n = self._to_dev([tokens, lens], np.int32)
        return llama.forward_embed(self.params, self.cfg, toks, n, tp=self.tp,
                                   ep=self.ep)

    def step_embed(self, core: MQCore) -> bool:
        """Serve pending embed requests: stateless forwards (no KV write),
        so a failure never touches decode state. A failed batch is
        retried or errored by serve_embed_batch and the runtime keeps
        serving (its decode slots are healthy; a dead device fails the
        next decode dispatch, which does rebuild). True if a batch ran."""
        max_len = min(self.ecfg.max_context, self.cfg.max_seq_len)
        try:
            return serve_embed_batch(self, core, self.pending_embed, max_len,
                                     self._dispatch_embed)
        except WorkerDesyncError:
            raise  # diverged ranks: the loop fails and reloads the runtime
        except Exception:  # noqa: BLE001 — contained to the batch
            log.exception("embed forward failed on %s", self.name)
            return True

    def stats(self) -> dict:
        """The JAX runtime's keys (the admin TUI and the JSON metrics read
        them) plus the port's own counters."""
        def pctl(window, q):
            if not window:
                return 0.0
            xs = sorted(window)
            return round(xs[min(len(xs) - 1, int(q * len(xs)))], 3)

        return {"model": self.name, "device": str(self.device),
                "active_slots": self.active_count(),
                "max_slots": self.ecfg.max_slots,
                "pages_used": self.alloc.used_pages,
                "pages_total": self.alloc.num_pages - 1,
                "step_p50_ms": pctl(self.step_window, 0.50),
                "step_p99_ms": pctl(self.step_window, 0.99),
                "ttft_p50_ms": pctl(self.ttft_window, 0.50),
                "ttft_p99_ms": pctl(self.ttft_window, 0.99),
                "preemptions": self.preempt_count,
                "retries": self.retry_count,
                "stalled_slots": len(self._stalled_slots),
                "mfu": round(self.mfu, 4),
                "spec": ({"proposed": self.spec_proposed,
                          "accepted": self.spec_accepted,
                          "accept_rate": round(self.spec_accepted / self.spec_proposed, 4)
                          if self.spec_proposed else 0.0,
                          "rollbacks": self.spec_rollbacks,
                          "throttled_users": len(self._spec_throttled)}
                         if self.spec else None),
                "pending_prefill": len(self.pending_prefill),
                "pending_embed": len(self.pending_embed),
                "chunking": len(self.chunking),
                "tokens_generated": self.tokens_generated,
                "ragged_dispatches": self.ragged_dispatches,
                "prefill_dispatches": self.prefill_dispatches,
                "sp_prefill_dispatches": self.sp_prefill_dispatches,
                "chunk_dispatches": self.chunk_dispatches,
                "decode_dispatches": self.decode_dispatches,
                "decode_steps": self.decode_steps,
                "prefix_cache": (self.prefix_cache.stats()
                                 if self.prefix_cache is not None else None),
                "step_latency_ms": round(self.step_latency_ms, 3),
                "prefill_latency_ms": round(self.prefill_latency_ms, 3),
                "kv_pages_free": self.alloc.free_pages,
                "kv_pages_cached": self.alloc.cached_pages,
                "param_bytes": self.param_bytes, "kv_bytes": self.kv_bytes,
                "weights_dtype": self.weights_dtype, "kv_dtype": self.kv_dtype,
                "failed": self._failed}


class EncoderRuntime(JournaledRuntime):
    """Embedding-model runtime: batched bidirectional encodes of padded
    inputs (serve_embed_batch), no KV pool, no decode slots."""

    SERVES = ("embed",)
    # Deterministic fault injection, attached by the engine.
    fault_plan = None

    def __init__(self, name: str, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, device=None, dtype=None,
                 params: Optional[dict] = None,
                 checkpoint_path: Optional[str] = None, mesh=None):
        err = validate_quant_config(engine_cfg.weights_dtype, engine_cfg.kv_dtype,
                                    model_names=(name,))
        if err is not None:
            raise ValueError(err)
        self.name = name
        self.cfg = model_cfg
        self._orig_cfg = model_cfg
        self.ecfg = engine_cfg
        self.weights_dtype = engine_cfg.weights_dtype
        self.mesh, self.tp, tp_size = _tensor_axis(mesh, model_cfg)
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.dtype = dtype if dtype is not None else DTYPES[engine_cfg.dtype]
        self.tokenizer = load_tokenizer(checkpoint_path)
        # An encoder holds every layer on every pipeline stage (its
        # stateless forward is not pipelined): only the tensor cut.
        rank = self.tp.rank if self.tp is not None else 0
        if params is None:
            params = weights.load_params(model_cfg, checkpoint_path,
                                         engine_cfg.seed, self.dtype,
                                         self.weights_dtype, self.device,
                                         tp=tp_size, rank=rank)
        else:
            params = weights.tp_slice(params, model_cfg, tp_size, rank)
        self.params = params
        self.pending: collections.deque = collections.deque()
        self._block_ver = -1  # first tick sweeps the loaded blocklist
        self._failed = False
        self.tokens_generated = 0
        self.step_latency_ms = 0.0
        self.preempt_count = 0
        self.retry_count = 0
        self.prefix_cache = None
        self.param_bytes = sum(nbytes(t) for t in weights.leaves(params))
        self.kv_bytes = 0
        tm.HBM_WEIGHT_BYTES.labels(model=name).set(self.param_bytes)
        tm.HBM_KV_BYTES.labels(model=name).set(0)

    def has_capacity(self, kind: Optional[str] = None) -> bool:
        return not self._failed and len(self.pending) < 4 * self.ecfg.max_slots

    def has_work(self) -> bool:
        return bool(self.pending)

    def active_count(self) -> int:
        return 0

    def held_requests(self) -> List[Request]:
        return list(self.pending)

    def submit(self, req: Request) -> bool:
        self.pending.append(req)
        return True

    def check_cancellations(self, core: MQCore) -> None:
        """Blocked users' queued embeds are cancelled (serve_embed_batch
        finishes them when popped)."""
        self._block_ver = sweep_blocked(core, self.pending, self._block_ver)

    def _dispatch_encode(self, B, bucket, tokens, lens) -> torch.Tensor:
        if self.fault_plan is not None:
            self.fault_plan.check("encode")
        toks = torch.from_numpy(tokens).to(self.device)
        n = torch.from_numpy(lens).to(self.device)
        return llama.forward_encoder(self.params, self.cfg, toks, n, tp=self.tp)

    def step(self, core: MQCore) -> None:
        """Encode pending requests in padded batches. A dispatch failure
        errors the batch and propagates: the engine kills and rebuilds the
        runtime (an encoder has no decode path to prove the device
        alive)."""
        serve_embed_batch(self, core, self.pending, self.cfg.max_seq_len,
                          self._dispatch_encode)

    def stats(self) -> dict:
        return {"model": self.name, "device": str(self.device),
                "active_slots": 0, "max_slots": 0,
                "pending_prefill": len(self.pending),
                "pages_used": 0, "pages_total": 0,
                "step_latency_ms": round(self.step_latency_ms, 3),
                "prefill_latency_ms": 0.0,
                "tokens_generated": self.tokens_generated,
                "preemptions": 0, "retries": 0, "stalled_slots": 0,
                "mfu": 0.0,  # encoders publish no decode-step MFU
                "param_bytes": self.param_bytes, "kv_bytes": self.kv_bytes,
                "weights_dtype": self.weights_dtype,
                "kv_dtype": "bfloat16",  # encoders hold no KV pool
                "prefix_cache": None, "spec": None,
                "failed": self._failed}


def _tensor_axis(mesh, model_cfg: ModelConfig):
    """(mesh, TensorGroup or None, tp) of a runtime; tp is validated
    against the model's heads."""
    if mesh is None or mesh.tp == 1:
        return mesh, None, 1
    validate_tp_for_model(mesh.tp, model_cfg.num_kv_heads, model_cfg.num_heads)
    return mesh, mesh.tensor, mesh.tp


def _expert_axis(mesh, model_cfg: ModelConfig, name: str):
    """(ExpertGroup or None, ep) of a runtime: an MoE model's expert
    shard on an expert-parallel mesh (ep must divide its experts), (None,
    1) for a dense model, which the axis replicates (multi-model pools
    mix families). The group is None on rank 0's host state of another
    replica, which runs no forward."""
    ep = mesh.ep if mesh is not None else 1
    if ep == 1 or not model_cfg.num_experts:
        return None, 1
    if model_cfg.num_experts % ep:
        raise ValueError(f"ep={ep} must divide num_experts="
                         f"{model_cfg.num_experts} ({name})")
    return mesh.expert, ep


def dp_devices(device, dp: int) -> List[str]:
    """The devices of dp in-process replicas on `device`: the CPU dp
    times, or dp consecutive cards from its index (cuda -> cuda:0 ..
    cuda:dp-1). Raises when a card is missing: no replica falls back to
    another device or to the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [str(dev)] * dp
    first = dev.index or 0
    have = torch.cuda.device_count()
    if first + dp > have:
        missing = ", ".join(f"cuda:{i}" for i in range(have, first + dp))
        raise RuntimeError(
            f"dp={dp} runs one replica per device, cuda:{first}..cuda:"
            f"{first + dp - 1}, but {missing} is missing (this host has "
            f"{have} CUDA device(s)); no replica falls back to another device")
    return [f"cuda:{first + i}" for i in range(dp)]


def build_model_runtimes(name: str, cfg: ModelConfig, engine_cfg: EngineConfig,
                         device, dtype, checkpoint_path: Optional[str] = None,
                         params: Optional[dict] = None, mesh=None,
                         runtime_class=None, encoder_runtime_class=None,
                         remote_runtime_class=None,
                         replica: Optional[int] = None) -> list:
    """The runtimes serving one model: THE construction path of
    TorchEngine.load_model, of a failed runtime's rebuild and of a
    parallel worker's replicas (engine/spmd.py passes its runtime
    classes, so every rank builds the same computation).

    On a mesh with a data axis a generative model gets dp replicas, each
    on its own slice of the axis (replica_submesh): dp weight copies and
    KV pools serving at once, the reference's "N backends, least
    connections" scale-out with backends = replicas. In one process the
    weights are read, or drawn from the seed, once (on the first
    replica's device, so they are the weights a one-replica engine
    draws) and copied to every replica's device; weights passed in are
    copied to each. Over the rank world every rank builds its own
    replica's slice (of weights passed in, too); a replica none of whose
    ranks this process holds is built by `remote_runtime_class` (rank 0:
    host state only) or skipped when that is None (a worker). `replica`
    builds that one replica (a rebuild). An encoder serves on the first
    replica's slice."""
    dp = mesh.dp if mesh is not None else 1
    if cfg.is_encoder:
        sub = replica_submesh(mesh, 0) if dp > 1 else mesh
        if sub is not None and sub.rank is None:
            return []
        return [(encoder_runtime_class or EncoderRuntime)(
            name, cfg, engine_cfg, device, dtype, params=params,
            checkpoint_path=checkpoint_path, mesh=sub)]
    cls = runtime_class or ModelRuntime
    if dp == 1:
        return [cls(name, cfg, engine_cfg, device, dtype, params=params,
                    checkpoint_path=checkpoint_path, mesh=mesh)]
    in_process = mesh.backend is None
    reps, host = [], params
    for r in (range(dp) if replica is None else (replica,)):
        sub = replica_submesh(mesh, r)
        if sub.rank is None:
            if remote_runtime_class is not None:
                rt = remote_runtime_class(name, cfg, engine_cfg, device, dtype,
                                          checkpoint_path=checkpoint_path,
                                          mesh=sub)
                rt.replica = r
                reps.append(rt)
            continue
        if in_process:
            mine = weights.clone_to(host, sub.device) if host is not None else None
        else:
            mine = params  # this rank cuts its slice, as at dp 1
        rt = cls(name, cfg, engine_cfg, sub.device, dtype, params=mine,
                 checkpoint_path=checkpoint_path, mesh=sub)
        rt.replica = r
        if in_process and host is None:
            host = rt.params
        reps.append(rt)
    return reps


def merge_prefix_cache_stats(stats_list) -> Optional[dict]:
    """Sum per-replica prefix-cache stat dicts (None entries: replicas
    without a cache): a ReplicaSet's, and the fleet router's view over
    its members. None when no replica caches."""
    live = [s for s in stats_list if s]
    if not live:
        return None
    keys = ("hits", "misses", "evictions", "tokens_saved", "cached_pages",
            "evictable_pages", "pinned_pages")
    merged = {k: sum(s.get(k, 0) for s in live) for k in keys}
    total = merged["hits"] + merged["misses"]
    merged["hit_ratio"] = round(merged["hits"] / total, 4) if total else 0.0
    return merged


class ReplicaSet:
    """Data parallelism as replica serving: dp independent ModelRuntimes
    for one model, each on its own slice of the mesh's data axis, with
    least-loaded placement and round-robin rotation among ties, the
    analogue of the reference's least-connections backend pick
    (dispatcher.rs:475-487). Each replica holds its own weights, KV pool
    and generator, so replicas step independently (and their decode
    dispatches overlap on different devices). The server, the TUI,
    health and telemetry see one runtime: the aggregate surface below."""

    def __init__(self, replicas: List[ModelRuntime]):
        assert replicas
        self.replicas = list(replicas)
        self.name = self.replicas[0].name
        self.cfg = self.replicas[0].cfg
        self.ecfg = self.replicas[0].ecfg
        self._last_idx = 0  # rotation cursor (dispatcher.rs last_backend_idx)

    # -- placement ---------------------------------------------------------
    @staticmethod
    def _load(rt: ModelRuntime) -> int:
        return (rt.active_count() + len(rt.pending_prefill)
                + len(getattr(rt, "pending_embed", ()))
                + len(rt.chunking))

    def has_capacity(self, kind: Optional[str] = None) -> bool:
        return any(r.has_capacity(kind) for r in self.replicas)

    def submit(self, req: Request) -> bool:
        """Least-loaded replica wins; ties rotate after the previous pick.
        False when NO replica has capacity (the admission gate raced): the
        caller returns the request to the native queue, the reference's
        wait-in-queue semantics (dispatcher.rs:467-473), instead of
        parking it on a full replica where it would jump the fair-share
        order."""
        eligible = [i for i, r in enumerate(self.replicas)
                    if r.has_capacity(req.kind)]
        if not eligible:
            return False
        best = min(self._load(self.replicas[i]) for i in eligible)
        ties = {i for i in eligible if self._load(self.replicas[i]) == best}
        n = len(self.replicas)
        for off in range(1, n + 1):
            i = (self._last_idx + off) % n
            if i in ties:
                self._last_idx = i
                return self.replicas[i].submit(req)
        return False

    def force_submit(self, req: Request) -> None:
        """Place even with zero capacity (the least-loaded live replica):
        for requests the native queue cannot hold back (no model named)."""
        live = ([i for i, r in enumerate(self.replicas) if not r._failed]
                or list(range(len(self.replicas))))
        best = min(live, key=lambda i: self._load(self.replicas[i]))
        self.replicas[best].submit(req)

    # -- the aggregate runtime surface (registry, health, TUI, server) -----
    @property
    def SERVES(self):  # noqa: N802 — the runtimes' class attribute
        return self.replicas[0].SERVES

    @property
    def _failed(self) -> bool:
        """Down only when every replica is (one failed replica leaves the
        others serving while it is rebuilt)."""
        return all(r._failed for r in self.replicas)

    @property
    def tokenizer(self):
        return self.replicas[0].tokenizer

    @property
    def param_bytes(self) -> int:
        return sum(r.param_bytes for r in self.replicas)

    @property
    def kv_bytes(self) -> int:
        return sum(r.kv_bytes for r in self.replicas)

    @property
    def tokens_generated(self) -> int:
        return sum(r.tokens_generated for r in self.replicas)

    def has_work(self) -> bool:
        return any(r.has_work() for r in self.replicas)

    def active_count(self) -> int:
        return sum(r.active_count() for r in self.replicas)

    def check_cancellations(self, core: MQCore) -> None:
        for r in self.replicas:
            r.check_cancellations(core)

    def stats(self) -> dict:
        per = [r.stats() for r in self.replicas]
        agg = dict(per[0])
        for key in ("active_slots", "max_slots", "pending_prefill",
                    "pages_used", "pages_total", "tokens_generated",
                    "preemptions", "retries", "stalled_slots",
                    "param_bytes", "kv_bytes"):
            agg[key] = sum(p[key] for p in per)
        for key in ("step_latency_ms", "step_p50_ms", "step_p99_ms",
                    "prefill_latency_ms", "ttft_p50_ms", "ttft_p99_ms",
                    "mfu"):
            agg[key] = max(p.get(key, 0.0) for p in per)
        # The port's own counters sum too.
        for key in ("pending_embed", "chunking", "ragged_dispatches",
                    "prefill_dispatches", "chunk_dispatches",
                    "decode_dispatches", "decode_steps", "kv_pages_free",
                    "kv_pages_cached"):
            if key in agg:
                agg[key] = sum(p[key] for p in per)
        agg["prefix_cache"] = merge_prefix_cache_stats(
            [p.get("prefix_cache") for p in per])
        agg["replicas"] = len(per)
        if "failed" in agg:
            agg["failed"] = self._failed
            agg["failed_replicas"] = [i for i, p in enumerate(per)
                                      if p["failed"]]
        return agg


class TorchEngine:
    """Engine front: owns the fair-share core, the model runtimes and the
    loop thread, and contains failures: preempted and fault-implicated
    requests go back to the front of their users' queues, and a runtime
    whose step failed is rebuilt off the loop thread.

    `models` maps each model to load at start to an HF safetensors
    directory or None (seeded weights); None serves engine_cfg.model
    alone. `params` are weights for engine_cfg.model, used as given."""

    # HBM/allocator timeline: one sample per period (the engine ticks far
    # faster) of every runtime's page pool and footprint, plus the card's
    # allocator and free memory, for GET /debug/hbm.
    HBM_SAMPLE_PERIOD_S = 1.0
    _hbm_last_sample = 0.0
    # The runtime classes load_model builds (engine/spmd.py mirrors their
    # dispatches on every rank).
    runtime_class = None
    encoder_runtime_class = None
    # The class of a replica whose ranks this process does not hold
    # (engine/spmd.py: rank 0's host-state view of replica r > 0).
    remote_runtime_class = None

    def __init__(self, engine_cfg: EngineConfig, device=None, dtype=None,
                 blocklist_path: Optional[str] = None,
                 params: Optional[dict] = None,
                 fairness: Fairness = Fairness.REQUESTS,
                 models: Optional[Dict[str, Optional[str]]] = None,
                 mesh=None):
        self.ecfg = engine_cfg
        # The scheduling policy is built before any device work, so an
        # unknown --scheduler fails at start-up.
        self.policy = make_policy(engine_cfg)
        # A rank mesh (parallel/mesh.py) puts every runtime on this rank's
        # device and slice of a parallel layout. dp > 1 with no mesh: dp
        # in-process replicas, one per device (dp_devices).
        if mesh is None and engine_cfg.dp > 1:
            mesh = make_mesh(dp=engine_cfg.dp,
                             devices=dp_devices(device, engine_cfg.dp))
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.dtype = dtype
        models = dict(models) if models is not None else {engine_cfg.model: None}
        for name in models:
            if get_model_config(name) is None:
                raise KeyError(f"unknown model architecture: {name}")
        # A plan file fails here, before any device work.
        self.fault_plan = None
        if engine_cfg.fault_plan:
            from ollamamq_tpu_torch.testing.faults import FaultPlan

            self.fault_plan = (FaultPlan.load(engine_cfg.fault_plan)
                               if isinstance(engine_cfg.fault_plan, str)
                               else engine_cfg.fault_plan)
        self.core = MQCore(blocklist_path)
        self.core.set_fairness(fairness)
        # Load-shed accounting by reason (mirrors ollamamq_shed_total).
        self.shed_counts: Dict[str, int] = {}
        self.started_at = time.time()
        # Request-lifecycle traces (GET /debug/trace), the alert table
        # (/health, /metrics, the TUI) and the opt-in SLO objectives.
        self.tracer = Tracer(capacity=engine_cfg.trace_ring)
        self.alerts = AlertManager()
        self.slo = SLOEngine(self.alerts, ttft_ms=engine_cfg.slo_ttft_ms or None,
                             tpot_ms=engine_cfg.slo_tpot_ms or None,
                             target=engine_cfg.slo_target)
        # Flight recorder: every scheduler decision as a typed record in a
        # bounded ring (GET /debug/journal), optionally spilled to a file.
        self.journal = Journal(
            capacity=engine_cfg.journal_ring, path=engine_cfg.journal_file,
            rotate_bytes=int(engine_cfg.journal_rotate_mb * 1e6),
            keep=engine_cfg.journal_keep, sample=engine_cfg.journal_sample,
            meta={"model": engine_cfg.model, "max_slots": engine_cfg.max_slots,
                  "num_pages": engine_cfg.num_pages})
        # Crash durability (--wal-dir): the admission WAL, the recovery
        # pass and the resumable-stream registry. None: no WAL.
        self.durability = None
        if engine_cfg.wal_dir:
            from ollamamq_tpu_torch.durability import DurabilityManager

            self.durability = DurabilityManager(
                engine_cfg, journal=self.journal, alerts=self.alerts,
                fault_plan=self.fault_plan)
        self.health: Optional[HealthMonitor] = None
        # Loop liveness tick for the stall watchdog.
        self.last_tick_at = time.monotonic()
        # Graceful-shutdown gate: after quiesce() every enqueue sheds (503).
        self.accepting = True
        # The runtime table: changed on the loop thread only (load_model,
        # evict_model, a rebuild's swap); other threads read snapshots.
        self.runtimes: Dict[str, object] = {}
        # Where each loaded model's weights came from: its checkpoint
        # (None: the seed) and, for engine_cfg.model, weights passed in. A
        # rebuild reads them again.
        self._model_sources: Dict[str, Optional[str]] = {}
        self._model_params: Dict[str, dict] = {}
        self.pending: Dict[int, Request] = {}
        self._pending_lock = threading.Lock()
        self._cond = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        # Calls that must run on the loop thread, in order with dispatches.
        self._engine_calls: collections.deque = collections.deque()
        self._engine_retries = 0  # retries issued by _retry_or_error
        # In-flight KV migration exports: rid -> (runtime, handle). A
        # detached slot parks here between export_stream and the commit
        # or abort that resolves the two-phase handoff.
        self._migrations: Dict[int, tuple] = {}
        # Failure recovery: failed runtimes are rebuilt on this cadence.
        self._failed_runtimes: List[ModelRuntime] = []
        self._recovering: set = set()  # id(rt) with a rebuild in flight
        self._rebuilt: List[tuple] = []  # (dead, fresh) awaiting the swap
        self._rebuilt_lock = threading.Lock()
        self._last_recover_attempt = 0.0
        self.recover_interval = 5.0
        for name, ckpt in models.items():
            self.load_model(name, ckpt, params=params
                            if name == engine_cfg.model else None)

    def _step_targets(self) -> list:
        """The individually steppable runtimes: replica sets flatten, so
        every replica advances every tick (the loop dispatches every
        runtime's decode before it collects any)."""
        out = []
        for rt in list(self.runtimes.values()):
            out.extend(rt.replicas if isinstance(rt, ReplicaSet) else (rt,))
        return out

    def _attach_hooks(self, rt) -> None:
        rt.fault_plan = self.fault_plan
        rt.journal = self.journal
        if isinstance(rt, ModelRuntime):
            rt.policy = self.policy
            rt.slo = self.slo
            if self.ecfg.preempt:
                rt.on_preempt = self._requeue_preempted

    # -- model management (/api/pull and /api/delete) -------------------------
    def load_model(self, name: str, checkpoint_path: Optional[str] = None,
                   params: Optional[dict] = None) -> None:
        """Load a model onto the engine's device: built on the calling
        thread (seeded weights, or the HF safetensors directory), then put
        into the runtime table on the loop thread. A model already loaded
        stays as it is. Raises KeyError for an unknown architecture and
        whatever the build raised (nothing falls back to another
        device)."""
        cfg = get_model_config(name)
        if cfg is None:
            raise KeyError(f"unknown model architecture: {name}")
        if name in self.runtimes:
            return
        reps = build_model_runtimes(name, cfg, self.ecfg, self.device,
                                    self.dtype, checkpoint_path, params,
                                    self.mesh, self.runtime_class,
                                    self.encoder_runtime_class,
                                    self.remote_runtime_class)
        for d in {r.device for r in reps if r.device.type == "cuda"}:
            torch.cuda.synchronize(d)  # loaded = resident, not queued
        for r in reps:
            self._attach_hooks(r)
        rt = reps[0] if len(reps) == 1 else ReplicaSet(reps)

        def install() -> None:
            if name in self.runtimes:
                return  # a concurrent pull of the same model won
            self.runtimes[name] = rt
            self._model_sources[name] = checkpoint_path
            if params is not None:
                self._model_params[name] = params

        self.call_on_loop(install)
        log.info("loaded model %s (%.1f MB of weights%s)", name,
                 rt.param_bytes / 1e6,
                 f", {len(reps)} data-parallel replicas" if len(reps) > 1 else "")
        self.notify()

    def evict_model(self, name: str) -> bool:
        """Drop a loaded model and its device memory, on the loop thread.
        False when it is not loaded; RuntimeError while it holds work
        (queued requests for it stay queued until it is loaded again)."""

        def evict() -> bool:
            rt = self.runtimes.get(name)
            if rt is None:
                return False
            if rt.has_work():
                raise RuntimeError(f"model {name} has in-flight work")
            del self.runtimes[name]
            self._model_sources.pop(name, None)
            self._model_params.pop(name, None)
            for rep in (rt.replicas if isinstance(rt, ReplicaSet) else (rt,)):
                if rep in self._failed_runtimes:
                    self._failed_runtimes.remove(rep)
                # Drop the device tensors now, whoever still holds the
                # runtime object.
                rep.params = None
                if isinstance(rep, ModelRuntime):
                    rep.kc = rep.vc = rep.recent = None
            return True

        ok = self.call_on_loop(evict)
        if ok:
            log.info("evicted model %s", name)
        return ok

    def loaded_models(self) -> List[str]:
        return list(self.runtimes)

    # -- request flow ------------------------------------------------------
    def enqueue_request(self, user: str, ip: str, model: str,
                        family: Family = Family.UNKNOWN, prompt_tokens=None,
                        sampling=None, kind: str = "generate",
                        raw_prompt: str = "", context_ids=None,
                        trace_ctx=None) -> Request:
        """Enqueue into the native core AND register the Request under one
        lock, so the loop can never pop an id it doesn't know. Raises
        BlockedError for blocked users/IPs and QueueFullError at a
        bounded-admission cap (--max-queued / --max-queued-per-user).

        `context_ids` (Ollama's /api/generate `context`, and the WAL
        recovery's replay): ids generated in an earlier turn. They fold
        into the prompt with generated_ids pre-filled, the preemption
        replay's convention, so decoding continues right after them and
        max_tokens still budgets new tokens only. With a WAL the
        admission is on disk before this returns. `trace_ctx` (a fleet
        router's `traceparent`) makes the trace a span of that context."""
        cfg = self.ecfg
        n_prompt = len(prompt_tokens or [])
        if not self.accepting:
            # Quiesced (graceful shutdown): limit 0 = the door is closed.
            self._shed(user, model, "queue_full", self.core.total_queued(), 0,
                       5.0, n_prompt)
        if cfg.max_queued and self.core.total_queued() >= cfg.max_queued:
            self._shed(user, model, "queue_full", self.core.total_queued(),
                       cfg.max_queued, self.retry_after_s(), n_prompt, sampling)
        if (cfg.max_queued_per_user
                and self.core.queue_len(user) >= cfg.max_queued_per_user):
            self._shed(user, model, "user_queue_full", self.core.queue_len(user),
                       cfg.max_queued_per_user, self.retry_after_s(), n_prompt,
                       sampling)
        self._check_token_ids(model, kind, prompt_tokens, context_ids)
        with self._pending_lock:
            rid = self.core.enqueue(user, ip, model, family, kind=kind)
            req = Request(rid, user, model, prompt_tokens or [], sampling,
                          kind=kind, raw_prompt=raw_prompt)
            if context_ids:
                ctx = [int(t) for t in context_ids]
                sp = copy.copy(req.sampling)  # no __post_init__ seed refold
                sp.max_tokens = sp.max_tokens + len(ctx)
                req.sampling = sp
                req.prompt_tokens = list(req.prompt_tokens) + ctx
                req.generated_ids = list(ctx)
                req._replay_gen = len(ctx)
                req.stats.prompt_tokens = len(req.prompt_tokens)
            req.trace = self.tracer.begin(rid, user, model, kind=kind,
                                          ctx=trace_ctx)
            ticket = None
            if self.durability is not None:
                # The stream tap goes in while the loop cannot see the
                # request yet, with the prompt as the client sent it
                # (recovery re-folds).
                ticket = self.durability.capture(
                    req, prompt_tokens=prompt_tokens or [])
            self.pending[rid] = req
        self.journal.record(
            "enqueue", req=req, n_prompt=len(req.prompt_tokens),
            queued=self.core.total_queued(), kind_req=kind,
            max_tokens=req.sampling.max_tokens,
            deadline_ms=req.sampling.deadline_ms or None)
        if self.durability is not None:
            # Durable admission: the WAL fsync lands BEFORE this returns.
            self.durability.commit(req, ticket)
        self.notify()
        return req

    def _check_token_ids(self, model: str, kind: str, prompt_tokens,
                         context_ids) -> None:
        """Raise TokenIdError unless every id of a generation lies in
        [0, vocab_size) of the model that will serve it (the loaded
        runtime's architecture, else the catalog's; a name neither knows
        has nothing to check against and waits for a pull). Generations
        are where ids arrive from outside this process's tokenizer: the
        client's `context`, and a WAL's prompt and context at recovery.
        Embeds are tokenized here and never WAL'd."""
        if kind != "generate":
            return
        rt = self.resolve_runtime(model, kind)
        check_token_ids(getattr(rt, "cfg", None) or get_model_config(model),
                        model, prompt=prompt_tokens, context=context_ids)

    def _shed(self, user: str, model: str, reason: str, queued: int,
              limit: int, retry_after_s: float, n_prompt: int,
              sampling=None) -> None:
        """Refuse an enqueue at a bounded-admission cap (or the quiesced
        door, limit 0): count it, journal its inputs, raise."""
        self._count_shed(reason)
        fields = dict(queued=queued, limit=limit,
                      retry_after_s=round(retry_after_s, 3), n_prompt=n_prompt)
        if sampling is not None:
            fields["max_tokens"] = sampling.max_tokens
        self.journal.record("shed", user=user, model=model or None,
                            reason=reason, **fields)
        raise QueueFullError(reason, retry_after_s, limit)

    def _count_shed(self, reason: str) -> None:
        tm.SHED_TOTAL.labels(reason=reason).inc()
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1

    def retry_after_s(self) -> float:
        """Retry-After estimate for shed answers: queue depth over the
        OBSERVED completion rate (the tracer's recent finish times),
        clamped to [1, 300]; with fewer than two completions seen, the
        depth clamped to [2, 10]."""
        queued = max(1, self.core.total_queued())
        window = self.tracer.finish_times
        if len(window) >= 2:
            span = window[-1] - window[0]
            if span > 0:
                rate = (len(window) - 1) / span  # completions per second
                return float(min(300.0, max(1.0, queued / rate)))
        return float(min(10.0, max(2.0, float(queued))))

    def quiesce(self) -> None:
        """Stop accepting requests (later enqueues shed with 503) while
        everything in flight drains."""
        self.accepting = False

    def inflight_count(self) -> int:
        """Queued plus admitted-but-unfinished requests: what a graceful
        shutdown waits on."""
        return self.core.total_queued() + len(self._migrations) + sum(
            len(rt.held_requests()) for rt in self._step_targets())

    def _requeue_front(self, req: Request, why: Optional[str] = None) -> bool:
        """Return a request to the FRONT of its user's native queue under a
        fresh id (journaled as a requeue when `why` is given). False when
        its user is blocked: it is finished here."""
        try:
            with self._pending_lock:
                rid = self.core.requeue_front(req.user, "", req.model,
                                              kind=req.kind)
                req.req_id = rid
                self.pending[rid] = req
        except BlockedError:
            self.core.mark_dropped(req.user, started=req.started)
            self.journal.record("finish", req=req, reason="cancelled")
            req.finish(FinishReason.CANCELLED)
            return False
        if why is not None:
            self.journal.record("requeue", req=req, why=why)
        self.notify()
        return True

    def _requeue_preempted(self, req: Request) -> bool:
        """on_preempt hook: a preempted request goes back to the front of
        its user's queue for recompute. False => it was cancelled, expired
        or blocked and is finished here (its pages are already free)."""
        if req.cancelled.is_set():
            self.core.mark_dropped(req.user)
            self.journal.record("finish", req=req, reason="cancelled")
            req.finish(FinishReason.CANCELLED)
            return False
        if req.expired():
            drop_expired(req, self.core, req.model, journal=self.journal)
            return False
        req.trace_event("requeue")
        return self._requeue_front(req, why="preempt")

    def _retry_or_error(self, req: Request, msg: str,
                        replay: bool = False) -> None:
        """Route a request implicated in a runtime failure: one more try
        via the front of its user's queue (the runtime's pending gate
        honours the backoff), or an explicit poisoned error once the
        budget is spent. replay=True folds generated ids into the prompt
        so a mid-decode victim resumes its stream."""
        if req.cancelled.is_set():
            self.core.mark_dropped(req.user, started=req.started)
            self.journal.record("finish", req=req, reason="cancelled")
            req.finish(FinishReason.CANCELLED)
            return
        if req.expired():
            drop_expired(req, self.core, req.model, journal=self.journal)
            return
        if req.retries >= self.ecfg.step_retries:
            self.core.mark_dropped(req.user, started=req.started)
            self.journal.record("poison", req=req, retries=req.retries,
                                error=msg[:120])
            req.finish(FinishReason.ERROR, error=poison_text(req, msg))
            return
        req.retries += 1
        self._engine_retries += 1
        tm.RETRIES_TOTAL.labels(model=req.model or "?").inc()
        req._retry_at = time.monotonic() + (
            self.ecfg.retry_backoff_s * (2 ** (req.retries - 1)))
        if replay and req.generated_ids:
            req.prompt_tokens = (req.prompt_tokens
                                 + req.generated_ids[req._replay_gen:])
            req._replay_gen = len(req.generated_ids)
        req.trace_event("retry", error=msg[:200], n=req.retries)
        self.journal.record("retry", req=req, n=req.retries, error=msg[:120])
        self._requeue_front(req)

    def cancel(self, req_id: int) -> None:
        with self._pending_lock:
            req = self.pending.get(req_id)
        if req is not None:
            req.cancelled.set()
            # Still in the native queue (never admitted): finish it here.
            if self.core.cancel(req_id):
                with self._pending_lock:
                    self.pending.pop(req_id, None)
                req.finish(FinishReason.CANCELLED)
            self.notify()
            return
        for _rt, handle in list(self._migrations.values()):
            if handle["req"].req_id == req_id:
                # Mid-migration: detached from every slot, parked in the
                # two-phase handoff table until resolve_export.
                handle["req"].cancelled.set()
                return
        for rt in self._step_targets():
            for cand in (rt.held_requests()
                         + list(getattr(rt, "inflight_prefill", ()))):
                if cand.req_id == req_id:
                    cand.cancelled.set()
                    self.notify()
                    return

    # -- the fleet's seams ----------------------------------------------------
    def inject_request(self, req: Request, ip: str = "", family=None,
                       trace_ctx=None, trace_meter: bool = True) -> Request:
        """Enqueue AND register a pre-built Request under one lock: the
        fleet router's attempts, which may carry replayed generation state
        (generated_ids, the detokenizer, the penalty context folded into
        the prompt) that enqueue_request cannot build. Bypasses bounded
        admission on purpose: the router owns the fleet-wide caps.
        `trace_ctx` traces the attempt under the router's fleet context;
        `trace_meter` False for an in-process member, whose router trace
        already meters the stream in the shared registry. Raises
        TokenIdError, as enqueue_request does, for an id outside the
        model's vocabulary (the prompt, or replayed generated ids)."""
        self._check_token_ids(req.model, req.kind, req.prompt_tokens,
                              req.generated_ids)
        with self._pending_lock:
            rid = self.core.enqueue(
                req.user, ip, req.model,
                family if family is not None else Family.UNKNOWN,
                kind=req.kind)
            req.req_id = rid
            if trace_ctx is not None and req.trace is None:
                req.trace = self.tracer.begin(
                    rid, req.user, req.model, kind=req.kind,
                    ctx=trace_ctx, metered=trace_meter)
            self.pending[rid] = req
        self.journal.record(
            "enqueue", req=req, n_prompt=len(req.prompt_tokens),
            queued=self.core.total_queued(), kind_req=req.kind,
            max_tokens=req.sampling.max_tokens)
        self.notify()
        return req

    def prefix_match_pages(self, model: str, tokens) -> int:
        """Longest cached-prefix match (in full pages) the runtime of
        `model` holds for this prompt: the router's affinity probe. An
        advisory read from another thread (the radix walk only follows
        dict gets under the GIL): a racing loop mutation can at worst
        give a stale count, a placement-quality issue, never a
        correctness one. 0 when nothing caches."""
        rt = self.resolve_runtime(model)
        best = 0
        for rep in (rt.replicas if isinstance(rt, ReplicaSet) else (rt,)):
            pc = getattr(rep, "prefix_cache", None)
            if pc is None:
                continue
            try:
                _nodes, pages = pc.match(list(tokens))
            except Exception:  # noqa: BLE001 — advisory probe only
                continue
            best = max(best, len(pages))
        return best

    def export_stream(self, rid: int, deadline: Optional[float] = None):
        """Phase 1 of the two-phase handoff: snapshot and detach `rid`'s
        decode slot into a blob, parking the source state until
        resolve_export commits or aborts. Runs on the loop thread, whose
        engine calls drain at the top of a tick: after the previous
        tick's decode collect, never between a dispatch and its collect.
        A late-running export past `deadline` is a no-op, so the caller's
        recompute fallback never races a zombie detach. None: not
        exportable."""
        def _do():
            if deadline is not None and time.monotonic() > deadline:
                return None
            for rt in self._step_targets():
                export = getattr(rt, "export_request", None)
                out = export(rid) if export is not None else None
                if out is None:
                    continue
                handle, blob = out
                self._migrations[rid] = (rt, handle)
                req = handle["req"]
                self.journal.record(
                    "migrate_export", req=req,
                    tokens=len(req.generated_ids),
                    kv_len=blob.get("kv_len"), pages=blob.get("n_pages"))
                return blob
            return None

        timeout = (max(0.05, deadline - time.monotonic())
                   if deadline is not None else 30.0)
        if not self._running:
            # A crashed member: call_on_loop runs the export inline, but
            # the loop thread may still be inside its last iteration,
            # mutating the slot state the snapshot reads. Wait for it to
            # die first; one that outlives the budget means recompute,
            # never a torn snapshot.
            t = self._thread
            if t is not None and t.is_alive():
                t.join(timeout=timeout)
                if t.is_alive():
                    return None
        try:
            return self.call_on_loop(_do, timeout=timeout)
        except TimeoutError:
            return None  # wedged loop: the guarded fn no-ops if it runs

    def resolve_export(self, rid: int, commit: bool = True,
                       why: str = "") -> bool:
        """Phase 2: release the parked source state. Commit and abort free
        alike (full prompt pages merge into the prefix cache); an abort
        journals WHY and the caller recomputes. The parked request
        finishes CANCELLED either way, so its handler and stream
        consumers unblock. False when nothing is parked under `rid`."""
        def _do():
            ent = self._migrations.pop(rid, None)
            if ent is None:
                return False
            rt, handle = ent
            req = handle["req"]
            try:
                rt.release_export(handle)
            except Exception:  # noqa: BLE001 — a release must not wedge
                log.exception("release of migrated slot failed (%s)",
                              getattr(rt, "name", "?"))
            if not commit:
                self.journal.record("migrate_abort", req=req,
                                    why=why or "transfer_failed")
            self.core.mark_dropped(req.user)
            # The finish names the freed slot, so the journal's slot
            # story stays whole: the next install there is a reuse.
            extra = {"slot": handle["slot"]} if "slot" in handle else {}
            self.journal.record("finish", req=req, reason="cancelled",
                                tokens=len(req.generated_ids),
                                model=getattr(rt, "name", None),
                                dp_replica=getattr(rt, "replica", 0), **extra)
            req.finish(FinishReason.CANCELLED)
            self.notify()
            return True

        return self.call_on_loop(_do)

    def import_stream(self, blob: dict, ip: str = "", family=None,
                      deadline: Optional[float] = None, trace_ctx=None,
                      trace_meter: bool = True) -> Request:
        """Target side of a migration: rebuild the Request and install it
        DIRECTLY into a decode slot from the shipped pages: no queue
        wait, no re-prefill. Raises MigrationError when it cannot land
        (the caller recomputes), and TokenIdError when the blob carries
        an id outside the model's vocabulary. Bypasses bounded admission
        like inject_request: the router already admitted."""
        state = blob.get("request") or {}
        if not state.get("user"):
            raise MigrationError("malformed migration blob (no request)")

        def _do():
            rid = self.core.enqueue(
                state["user"], ip, state.get("model"),
                family if family is not None else Family.UNKNOWN)
            # Only the id is wanted: the stream resumes mid-decode and
            # never waits in this member's queue.
            self.core.cancel(rid)
            req = request_from_migration_state(rid, state)
            req._inc_decode = blob.get("_inc_decode")
            req.deadline = deadline
            if trace_ctx is not None:
                req.trace = self.tracer.begin(
                    rid, req.user, req.model, kind=req.kind,
                    ctx=trace_ctx, metered=trace_meter)
            rt = self.resolve_runtime(state.get("model"), kind="generate")
            if rt is None:
                raise MigrationError(
                    f"model not loaded: {state.get('model')}")
            for rep in (rt.replicas if isinstance(rt, ReplicaSet) else (rt,)):
                import_fn = getattr(rep, "import_request", None)
                if import_fn is not None and import_fn(blob, req):
                    break
            else:
                raise MigrationError("no slot/pages for migrated stream")
            self.core.mark_started(req.user)
            req.started = True
            self.journal.record(
                "migrate_import", req=req, tokens=len(req.generated_ids),
                pages=blob.get("n_pages"))
            self.notify()
            return req

        return self.call_on_loop(_do)

    def export_prefix(self, model: str, tokens) -> Optional[dict]:
        """Affinity-miss prefix shipping, source side (the router's
        seam)."""
        def _do():
            for rep in self._replicas_of(model):
                fn = getattr(rep, "export_prefix", None)
                blob = fn(list(tokens)) if fn is not None else None
                if blob is not None:
                    return blob
            return None

        try:
            return self.call_on_loop(_do, timeout=10.0)
        except TimeoutError:
            return None

    def import_prefix(self, model: str, blob: dict) -> int:
        """Affinity-miss prefix shipping, target side: pages adopted."""
        def _do():
            for rep in self._replicas_of(model):
                fn = getattr(rep, "import_prefix", None)
                n = fn(blob) if fn is not None else 0
                if n:
                    return n
            return 0

        try:
            return self.call_on_loop(_do, timeout=10.0)
        except TimeoutError:
            return 0

    def _replicas_of(self, model: str) -> list:
        """The runtimes serving `model`: its replicas, in order."""
        rt = self.resolve_runtime(model)
        if rt is None:
            return []
        return list(rt.replicas) if isinstance(rt, ReplicaSet) else [rt]

    def resolve_runtime(self, model: str, kind: str = "generate"):
        """The runtime serving `model` (smart_match), or None. With no
        model named: a live runtime that serves `kind` (a generate request
        never lands on an encoder), else a failed one mid-rebuild."""
        runtimes = dict(self.runtimes)
        if not model:
            able = [rt for rt in runtimes.values() if kind in rt.SERVES]
            return next((rt for rt in able if not rt._failed),
                        able[0] if able else None)
        key = smart_match(model, runtimes.keys())
        return runtimes[key] if key is not None else None

    def notify(self) -> None:
        with self._cond:
            self._cond.notify()

    def call_on_loop(self, fn, timeout: float = 300.0):
        """Run `fn` on the loop thread, in order with dispatches, and
        return its result (raising what it raised); inline when the loop
        is not running or this IS the loop thread."""
        if not self._running or threading.current_thread() is self._thread:
            return fn()
        ev, box = threading.Event(), {}
        self._engine_calls.append((fn, ev, box))
        self.notify()
        if not ev.wait(timeout):
            raise TimeoutError("engine-loop call timed out")
        if "err" in box:
            raise box["err"]
        return box.get("ret")

    def _drain_engine_calls(self) -> None:
        while self._engine_calls:
            fn, ev, box = self._engine_calls.popleft()
            try:
                box["ret"] = fn()
            except Exception as e:  # noqa: BLE001 — delivered to the caller
                box["err"] = e
            ev.set()

    # -- loop ----------------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, name="engine",
                                        daemon=True)
        self._thread.start()
        if self.health is None:
            self.health = HealthMonitor(self)
            self.health.start()
        if self.durability is not None:
            # Recovery runs with the loop live (re-admissions take the
            # normal enqueue path) and before the HTTP front serves.
            self.durability.start(self)

    def stop(self) -> None:
        self._running = False
        self.notify()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._drain_engine_calls()
        if self.health is not None:
            self.health.stop()
            self.health = None
        if self.durability is not None:
            self.durability.close()  # final WAL flush + fsync
        self.journal.close()  # flush the --journal-file spill

    def _loop(self) -> None:
        while self._running:
            try:
                self._loop_once()
            except Exception:  # the loop thread must keep serving
                log.exception("engine loop iteration failed; continuing")
                time.sleep(0.1)

    @staticmethod
    def _gate_eligible(rt, kind: str) -> bool:
        """Whether the native pop may release a `kind` task for `rt`: it
        can take one now, or it can never serve the kind (then _place
        errors the mismatch instead of parking it forever)."""
        if kind not in rt.SERVES:
            return True
        return rt.has_capacity(kind)

    def _admit(self) -> int:
        """Pop windows of requests in fair-share order while a runtime can
        take one and place each window in policy order (decision point
        (a); fcfs pops a window of 1, the plain pop-and-place flow). Two
        capacity pools, one gate each: an embed task is gated on the embed
        list and a generate task on the generate list, so a full decode
        batch does not park embeds. A failed runtime has no capacity: its
        requests wait in the queue until the rebuild is swapped in."""
        admitted = 0
        pol = self.policy
        # One tick of the anti-starvation aging clock per admission pass.
        pol.on_admit_tick()
        while True:
            gen_ok = [name for name, rt in self.runtimes.items()
                      if self._gate_eligible(rt, "generate")]
            emb_ok = [name for name, rt in self.runtimes.items()
                      if self._gate_eligible(rt, "embed")]
            if not gen_ok and not emb_ok:
                break
            items, stuck = self.core.next_window(
                pol.admission_window, eligible_models=gen_ok, eligible_embed=emb_ok)
            batch = []
            for rid, user, model in items:
                with self._pending_lock:
                    req = self.pending.pop(rid, None)
                if req is None:
                    self.core.mark_dropped(user, started=False)
                    continue
                batch.append((rid, user, model, req))
            ordered = pol.order_admission(batch)
            if len(ordered) > 1 and pol.name != "fcfs":
                first = ordered[0][3]
                self.journal.record(
                    "sched", req=first, policy=pol.name, point="admit",
                    candidates=len(ordered), predicted=pol.predict(first),
                    score=round(pol.score(first), 3))
            for _rid, user, model, req in ordered:
                req.trace_event("admit")
                self.journal.record("admit", req=req,
                                    queued=self.core.total_queued())
                if self._place(req, user, model):
                    admitted += 1
            if stuck or not items:
                break
        return admitted

    def _place(self, req: Request, user: str, model: str) -> bool:
        if req.cancelled.is_set() or self.core.is_user_or_ip_blocked(user):
            self.core.mark_dropped(user, started=req.started)
            self.journal.record("finish", req=req, reason="cancelled")
            req.finish(FinishReason.CANCELLED)
            return False
        if req.expired():
            drop_expired(req, self.core, model, journal=self.journal)
            return False
        rt = self.resolve_runtime(model, kind=req.kind)
        if rt is None and model:
            # Evicted between the native gate and placement: back to the
            # front of the user's queue until the model is loaded again.
            return self._requeue(req, user, model)
        if rt is None:
            self.core.mark_dropped(user, started=req.started)
            self.journal.record("finish", req=req, reason="error")
            req.finish(FinishReason.ERROR, error=f"model not loaded: {model}")
            return False
        if req.kind not in rt.SERVES:
            # A permanent mismatch: error it, never park it.
            self.core.mark_dropped(user, started=req.started)
            self.journal.record("finish", req=req, reason="error")
            req.finish(FinishReason.ERROR, error=(
                f"model {model or rt.name} is an embedding-only model"
                if req.kind == "generate" else
                f"model {model or rt.name} does not support embeddings"))
            return False
        if not rt.submit(req):
            if model:
                # Replica capacity raced away between the native gate and
                # placement: wait in the queue, as after an eviction (the
                # gate holds it until capacity returns).
                return self._requeue(req, user, model)
            # A request naming no model always passes the native gate, so
            # a requeue would spin: the least-loaded live replica takes it.
            rt.force_submit(req)
        req.trace_event("place", runtime=rt.name)
        self.journal.record("place", req=req, runtime=rt.name)
        if not req.started:
            # A preempted or retried requeue was counted already.
            self.core.mark_started(user)
            req.started = True
        return True

    def _requeue(self, req: Request, user: str, model: str) -> bool:
        """Return a popped request that cannot be placed to the FRONT of
        its user's queue (FIFO kept). Always False: nothing was placed."""
        try:
            with self._pending_lock:
                rid = self.core.requeue_front(user, "", model, kind=req.kind)
                req.req_id = rid
                self.pending[rid] = req
            req.trace_event("requeue")
            self.journal.record("requeue", req=req, why="unplaceable")
        except BlockedError:
            self.core.mark_dropped(user, started=False)
            self.journal.record("finish", req=req, reason="cancelled")
            req.finish(FinishReason.CANCELLED)
        return False

    def _kill_runtime(self, rt, exc: Exception) -> None:
        """Contain a failed step: retry or poison every request the runtime
        holds, drop its device buffers (the rebuild must fit beside the
        other runtimes) and queue it for a rebuild."""
        log.error("runtime %s step failed: %s", rt.name, exc, exc_info=exc)
        # Diverged tensor-parallel ranks: no retry can land before the
        # reload, so the requests end loudly now.
        self._fail_runtime(rt, f"engine step failed: {exc}",
                           retry=not isinstance(exc, WorkerDesyncError),
                           queued=isinstance(exc, PeerDeadError))
        rt._failed = True
        rt.params = rt.kc = rt.vc = rt.recent = None
        self._failed_runtimes.append(rt)

    def _fail_runtime(self, rt, msg: str, retry: bool = True,
                      queued: bool = False) -> None:
        """Each implicated request is retried ONCE on a fresh dispatch
        (mid-decode victims replay prompt + generated so their streams
        resume after the rebuild); one that keeps failing is poisoned.
        Every runtime kind: slots (ModelRuntime), the active list
        (FakeRuntime), then the pending queues. retry=False: every
        request in a slot or mid-prefill ends with an error at once, and
        with queued=True (a dead rank: no reload can succeed) every
        queued one too."""
        if not retry:
            return self._error_runtime_requests(rt, msg, queued)
        if isinstance(rt, ModelRuntime):
            for i, req in enumerate(rt.slot_req):
                if req is not None:
                    rt._release_slot_pages(i)
                    rt.seq_lens[i] = 0
                    rt.slot_req[i] = None
                    self._retry_or_error(req, msg, replay=True)
            rt._stalled_slots.clear()
        active = getattr(rt, "active", None)
        while active:
            self._retry_or_error(active.pop(), msg, replay=True)
        for attr in ("pending_prefill", "pending_embed", "chunking", "pending"):
            q = getattr(rt, attr, None)
            while q:
                self._retry_or_error(q.popleft(), msg)
        if isinstance(rt, ModelRuntime):
            for slot in list(rt.reserved_slots):
                rt._release_slot_pages(slot)
            rt.reserved_slots.clear()

    def _error_runtime_requests(self, rt, msg: str, queued: bool) -> None:
        """Requests that reached the failed runtime's device state (slots,
        prefills in flight) end with an error; queued ones too when
        `queued`, else they wait for the reload (the queues survive into
        the rebuilt runtime)."""
        def error(req: Request) -> None:
            self.core.mark_dropped(req.user, started=getattr(req, "started", True))
            self.journal.record("finish", req=req, reason="error")
            req.finish(FinishReason.ERROR, error=msg)

        if isinstance(rt, ModelRuntime):
            for i, req in enumerate(rt.slot_req):
                if req is not None:
                    rt._release_slot_pages(i)
                    rt.seq_lens[i] = 0
                    rt.slot_req[i] = None
                    error(req)
            rt._stalled_slots.clear()
            while rt.chunking:
                req = rt.chunking.popleft()
                if not req.stats.finished_at:
                    error(req)
            for slot in list(rt.reserved_slots):
                rt._release_slot_pages(slot)
            rt.reserved_slots.clear()
        if queued:
            for attr in ("pending_prefill", "pending_embed", "pending"):
                q = getattr(rt, attr, None)
                while q:
                    error(q.popleft())

    def _try_recover(self) -> None:
        """Start a background rebuild of each failed runtime."""
        self._last_recover_attempt = time.monotonic()
        for rt in list(self._failed_runtimes):
            if id(rt) not in self._recovering:
                self._recovering.add(id(rt))
                self._start_rebuild(rt)

    def _start_rebuild(self, rt: ModelRuntime) -> None:
        threading.Thread(target=self._rebuild_runtime, args=(rt,),
                         name=f"recover-{rt.name}", daemon=True).start()

    def _rebuild_runtime(self, rt) -> bool:
        """(background thread) Build a replacement runtime from the model's
        own weights source and post it for the loop thread to swap in."""
        try:
            (fresh,) = build_model_runtimes(
                rt.name, getattr(rt, "_orig_cfg", rt.cfg), self.ecfg,
                self.device, self.dtype, self._model_sources.get(rt.name),
                self._model_params.get(rt.name), self.mesh,
                self.runtime_class, self.encoder_runtime_class,
                self.remote_runtime_class,
                replica=getattr(rt, "replica", 0))
        except Exception:  # noqa: BLE001 — retried on the next interval
            log.exception("rebuild of %s failed; retrying in %.0fs",
                          rt.name, self.recover_interval)
            self._recovering.discard(id(rt))
            return False
        with self._rebuilt_lock:
            self._rebuilt.append((rt, fresh))
        self.notify()
        return True

    def _swap_rebuilt(self) -> None:
        """(loop thread) Install finished rebuilds; requests that reached
        the dead runtime meanwhile restart on the fresh one."""
        with self._rebuilt_lock:
            items, self._rebuilt = self._rebuilt, []
        for rt, fresh in items:
            self._recovering.discard(id(rt))
            cur = self.runtimes.get(rt.name)
            if isinstance(cur, ReplicaSet) and rt in cur.replicas:
                # A rebuilt replica replaces itself inside its set.
                cur.replicas[cur.replicas.index(rt)] = fresh
            elif cur is rt:
                self.runtimes[rt.name] = fresh
            else:
                continue  # evicted meanwhile: the rebuild is dropped
            self._attach_hooks(fresh)
            for r in rt.held_requests():
                fresh.submit(r)
            if rt in self._failed_runtimes:
                self._failed_runtimes.remove(rt)
            self.journal.record("rebuild", model=rt.name)
            log.warning("runtime %s rebuilt; serving resumes", rt.name)
            self.notify()

    def _sample_hbm_timeline(self) -> None:
        now = time.monotonic()
        if now - self._hbm_last_sample < self.HBM_SAMPLE_PERIOD_S:
            return
        self._hbm_last_sample = now
        models = {}
        for name, rt in self.runtimes.items():
            row = {"weight_bytes": int(rt.param_bytes),
                   "kv_bytes": int(rt.kv_bytes),
                   "free": 0, "used": 0, "cached": 0, "pool": 0}
            # Encoders hold no page pool; a replica set's pools sum.
            for rep in (rt.replicas if isinstance(rt, ReplicaSet) else (rt,)):
                if isinstance(rep, ModelRuntime):
                    a = rep.alloc
                    row.update(free=row["free"] + a.free_pages,
                               used=row["used"] + a.used_pages,
                               cached=row["cached"] + a.cached_pages,
                               pool=row["pool"] + a.num_pages - 1)
            models[name] = row
        sample = {"models": models}
        mem = device_memory(self.device)  # None on the CPU: no readings
        if mem is not None:
            sample["device"] = mem
        stepprof.PROFILER.hbm_record(sample)

    def _loop_once(self) -> None:
        self.last_tick_at = time.monotonic()
        self.journal.tick += 1
        self._sample_hbm_timeline()
        self._drain_engine_calls()
        self._swap_rebuilt()
        if (self._failed_runtimes and time.monotonic()
                - self._last_recover_attempt > self.recover_interval):
            self._try_recover()
        self._admit()
        did_work = False
        handles = []
        # Phase 1: ragged ticks and decode DISPATCH for every runtime, each
        # replica of a set on its own; phase 2 collects, so host work and
        # the replicas on other devices overlap the device.
        for rt in self._tick_targets():
            if rt._failed:
                continue
            try:
                rt.check_cancellations(self.core)
                if isinstance(rt, EncoderRuntime):
                    if rt.has_work():
                        rt.step(self.core)
                        did_work = True
                    continue
                ran_ragged = False
                if rt.ragged:
                    ran_ragged = rt.step_ragged(self.core)
                    did_work = did_work or ran_ragged
                else:
                    # The pipeline path (pp > 1): bucketed prefills first
                    # (TTFT), bounded per tick so an arrival storm cannot
                    # starve the decode streams, then one chunk of a long
                    # prompt, interleaved with decode below.
                    budget = self.ecfg.prefill_batches_per_tick
                    while (budget > 0 and rt.pending_prefill
                           and rt.step_prefill(self.core)):
                        budget -= 1
                        did_work = True
                    if rt.step_chunk(self.core):
                        did_work = True
                # Embeds on a generative model: one stateless batch
                # forward, no slot or page contention with decode.
                if rt.pending_embed and rt.step_embed(self.core):
                    did_work = True
                if not ran_ragged and rt.active_count():
                    # k=1 only when an admission could land between steps.
                    waiting = (bool(rt.pending_prefill)
                               or bool(self.core.queued_matching(rt.name)))
                    k = (1 if (waiting and rt.has_capacity("generate"))
                         or rt.chunking else self.ecfg.decode_steps_per_iter)
                    h = rt.step_decode_dispatch(self.core, k_steps=k)
                    if h is not None:
                        handles.append((rt, h))
                        did_work = True
                    # None with slots occupied: every occupant is a stalled
                    # reservation; nap on the condvar instead of spinning.
            except Exception as e:  # noqa: BLE001 — contain to this runtime
                self._kill_runtime(rt, e)
                did_work = True
        self._collect(handles)
        if not did_work:
            self._idle()

    def _tick_targets(self) -> list:
        """The runtimes phase 1 of a tick walks, in order."""
        return self._step_targets()

    def _collect(self, handles) -> None:
        """Phase 2 of a tick: collect the decodes phase 1 dispatched."""
        for rt, h in handles:
            if rt._failed:
                continue
            try:
                rt.step_decode_collect(h, self.core)
            except Exception as e:  # noqa: BLE001 — contain to this runtime
                self._kill_runtime(rt, e)

    def _idle(self) -> None:
        """A tick that ran nothing naps on the condvar (notify wakes it)."""
        with self._cond:
            self._cond.wait(timeout=0.05)

    # -- counters ------------------------------------------------------------
    def prefix_cache_stats(self) -> dict:
        """Per-model prefix-cache stats (replicas summed)."""
        models: Dict[str, list] = {}
        for rt in self._step_targets():
            if rt.prefix_cache is not None:
                models.setdefault(rt.name, []).append(rt.prefix_cache.stats())
        merged = {name: merge_prefix_cache_stats(reps)
                  for name, reps in models.items()}
        return {"enabled": bool(merged), "models": merged}

    def prefix_cache_flush(self) -> int:
        """Evict every unreferenced cached page, on the loop thread (the
        tree and the allocator are loop state)."""
        return self.call_on_loop(lambda: sum(
            rt.prefix_cache.flush() for rt in self._step_targets()
            if rt.prefix_cache is not None))

    def preemption_count(self) -> int:
        return sum(rt.preempt_count for rt in self._step_targets())

    def retry_count(self) -> int:
        return self._engine_retries + sum(rt.retry_count
                                          for rt in self._step_targets())

    def scheduler_stats(self) -> dict:
        """Live policy readout (TUI sched chip, /metrics.json): the active
        policy, the output-length predictor's accuracy over its recent
        window (None until warmed up), observations, reorders applied."""
        p = self.policy
        acc = p.predictor.accuracy()
        return {"policy": p.name,
                "pred_accuracy": round(acc, 4) if acc is not None else None,
                "pred_observed": p.predictor.observed,
                "decisions": p.decisions}

    def chip_stats(self) -> List[dict]:
        """A row per distinct device of this process (in-process replicas
        may span several cards)."""
        devs = ([self.device] if self.mesh is None or self.mesh.backend
                else list(dict.fromkeys(self.mesh.devices)))
        return [row for d in devs for row in chip_stats(d)]

    def worker_metric_snapshots(self) -> List[dict]:
        """Other ranks' registry snapshots for /metrics to merge: none in
        one process (the SPMD engine reads its world's)."""
        return []

    def stats(self) -> dict:
        runtime_stats = [rt.stats() for rt in list(self.runtimes.values())]
        chips = self.chip_stats()
        hbm_total = sum(c["hbm_total"] for c in chips) or None
        return {"queued": self.core.total_queued(),
                "device": str(self.device),
                "mesh": dict(self.mesh.shape) if self.mesh is not None else None,
                "runtimes": runtime_stats,
                "chips": chips,
                "hbm_used_bytes": sum(c["hbm_used"] for c in chips) or sum(
                    r["param_bytes"] + r["kv_bytes"] for r in runtime_stats),
                "hbm_total_bytes": hbm_total,
                "uptime_s": round(time.time() - self.started_at, 1),
                "health": self.health.status() if self.health is not None else None,
                "queue": self.core.snapshot(),
                "shed": dict(self.shed_counts),
                "preemptions": self.preemption_count(),
                "retries": self.retry_count(),
                "scheduler": self.scheduler_stats(),
                "stepprof": stepprof.PROFILER.brief()}
