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

Not carried over yet (later slices): KV migration, the bucketed prefill
path of pp > 1, multi-device layouts (data-parallel replicas, sequence
parallelism), fleet, durability and the decision journal.
"""

from __future__ import annotations

import collections
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
from ollamamq_tpu_torch.ops.sampling import (accept_prefix, maybe_apply_penalties,
                                             row_uniforms, sample_tokens_rowwise,
                                             sampling_flags)
from ollamamq_tpu_torch.telemetry import mfu as mfu_model
from ollamamq_tpu_torch.telemetry import schema as tm
from ollamamq_tpu_torch.telemetry import stepprof
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


def drop_expired(req: Request, core: MQCore, model: str) -> None:
    """Finish an expired request with the explicit deadline reason and
    count the shed."""
    core.mark_dropped(req.user, started=req.started)
    tm.DEADLINE_DROPS_TOTAL.labels(model=model or "?").inc()
    tm.SHED_TOTAL.labels(reason="deadline").inc()
    req.finish(FinishReason.DEADLINE,
               error="deadline expired before completion")


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
    batch: List[Request] = []
    while pending and len(batch) < max_batch:
        if pending[0]._retry_at > time.monotonic():
            break  # the head is backing off after a contained fault
        req = pending.popleft()
        if req.cancelled.is_set():
            core.mark_dropped(req.user)
            req.finish(FinishReason.CANCELLED)
            continue
        if req.expired():
            drop_expired(req, core, rt.name)
            continue
        n = len(req.prompt_tokens)
        if n > max_len:
            core.mark_dropped(req.user)
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
        for r in batch:
            if retry is not None and retry(r, msg):
                continue
            core.mark_dropped(r.user)
            r.finish(FinishReason.ERROR, error=ModelRuntime._poison_msg(r, msg))
        raise
    rt.step_latency_ms = (time.monotonic() - t0) * 1e3
    for i, r in enumerate(batch):
        r.embedding = out[i].tolist()
        r.stats.first_token_at = time.monotonic()
        # Processed tokens count toward the TUI's tok/s.
        rt.tokens_generated += int(lens[i])
        core.mark_done(r.user, tokens=int(lens[i]))
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


class ModelRuntime:
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

    def __init__(self, name: str, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, device=None, dtype=None,
                 params: Optional[dict] = None,
                 checkpoint_path: Optional[str] = None):
        # An unsupported quantization fails here, before any device work.
        err = validate_quant_config(engine_cfg.weights_dtype, engine_cfg.kv_dtype)
        if err is not None:
            raise ValueError(err)
        self.name = name
        self.cfg = model_cfg
        self.ecfg = engine_cfg
        self.weights_dtype = engine_cfg.weights_dtype
        self.kv_dtype = engine_cfg.kv_dtype
        self.device = resolve_device(device)
        self.dtype = dtype if dtype is not None else DTYPES[engine_cfg.dtype]
        self.tokenizer = load_tokenizer(checkpoint_path)
        # Params passed in are used as given (already quantized or not);
        # a checkpoint or the seed's weights are quantized at build time
        # for int8, as the JAX package's load_params does.
        if params is None:
            params = weights.load_params(model_cfg, checkpoint_path,
                                         engine_cfg.seed, self.dtype,
                                         self.weights_dtype, self.device)
        self.params = params
        self.kc, self.vc = kvc.alloc_kv_pool(model_cfg, engine_cfg,
                                             self.dtype, self.device,
                                             kv_dtype=self.kv_dtype)
        S, MP = engine_cfg.max_slots, engine_cfg.max_pages_per_seq
        # Repeat-penalty ring of each slot's last-W context token ids
        # (-1 = empty). Row S is a trash row for padding rows' writes.
        self.recent = torch.full((S + 1, engine_cfg.repeat_last_n), -1,
                                 dtype=torch.int32, device=self.device)
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
        # Speculative decoding: n-gram drafts verified on the span path;
        # user -> [proposed, accepted] feeds the per-user throttle.
        self.spec = bool(engine_cfg.spec) and engine_cfg.spec_k > 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rollbacks = 0
        self._spec_user: Dict[str, list] = {}
        self._spec_throttled: set = set()
        # Counters (host side).
        self.tokens_generated = 0
        self.ragged_dispatches = 0
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
        tm.FLOPS_PER_TOKEN.labels(model=name).set(mfu_model.flops_per_token(model_cfg))
        self._tm_occupancy.set(0.0)
        self._tm_mfu.set(0.0)
        # Device bytes, payload plus scales for int8 leaves and pools.
        self.param_bytes = sum(nbytes(t) for t in weights.leaves(self.params))
        self.kv_bytes = nbytes(self.kc) + nbytes(self.vc)
        tm.HBM_WEIGHT_BYTES.labels(model=name).set(self.param_bytes)
        tm.HBM_KV_BYTES.labels(model=name).set(self.kv_bytes)

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
    def _claim_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None and i not in self.reserved_slots:
                return i
        return None

    def _clear_slot(self, slot: int) -> None:
        """Reset a slot's sampling rows and bookkeeping (the caller
        releases its pages: finish and preempt release differently)."""
        self.seq_lens[slot] = 0
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

    def _alloc_pages(self, num_tokens: int) -> Optional[List[int]]:
        """alloc() with the prefix cache's eviction backstop: free-list
        exhaustion reclaims unreferenced cached pages (LRU) instead of
        failing admission."""
        if self.fault_plan is not None and self.fault_plan.blocked("alloc"):
            return None  # injected allocation pressure
        pages = self.alloc.alloc(num_tokens)
        if pages is None and self.prefix_cache is not None:
            short = self.alloc.pages_needed(num_tokens) - self.alloc.free_pages
            if short > 0 and self.prefix_cache.evict(short) > 0:
                pages = self.alloc.alloc(num_tokens)
        return pages

    def _alloc_tail(self, held: int, num_tokens: int) -> Optional[List[int]]:
        """Private tail pages for a cache-hit admission already holding
        `held` shared pages; the same eviction backstop."""
        need = self.alloc.pages_needed(num_tokens) - held
        pages = self.alloc.alloc_n(need, held=held)
        if pages is None and self.prefix_cache is not None:
            short = need - self.alloc.free_pages
            if short > 0 and self.prefix_cache.evict(short) > 0:
                pages = self.alloc.alloc_n(need, held=held)
        return pages

    def _extend_pages(self, pages: List[int], new_total_tokens: int) -> bool:
        """Decode-time page growth with the eviction backstop."""
        if self.fault_plan is not None and self.fault_plan.blocked("extend"):
            return False  # injected allocation pressure
        if self.alloc.extend(pages, new_total_tokens):
            return True
        if self.prefix_cache is None:
            return False
        need = self.alloc.pages_needed(new_total_tokens) - len(pages)
        if need <= 0 or len(pages) + need > self.alloc.max_pages_per_seq:
            return False  # per-sequence cap: eviction can't help
        if self.prefix_cache.evict(need - self.alloc.free_pages) > 0:
            return self.alloc.extend(pages, new_total_tokens)
        return False

    def _release_slot_pages(self, slot: int,
                            req: Optional[Request] = None) -> None:
        """Free a slot's KV pages and reset its page-table row. With the
        prefix cache on, the slot's pins are released and, when `req` is
        given (its prompt KV is fully written), its full prompt pages
        MERGE into the tree instead of returning to the free list."""
        pages = self.slot_pages[slot]
        pc = self.prefix_cache
        if pc is None:
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
            self.alloc.free(pages[keep:])
            pc.release(pins)
            self.slot_pages[slot] = []
            self.slot_pins[slot] = []
        self.page_table[slot, :] = kvc.TRASH_PAGE

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

    def _rollback_spec(self, slot: int, kv_after: int) -> None:
        """Release the pages of rejected drafts: the slot keeps the pages
        its accepted context needs, never fewer than its shared prefix
        pages. The page-table row is rewritten before the next dispatch,
        so no later step writes through a freed page."""
        self.spec_rollbacks += 1
        keep = len(self.slot_pins[slot])
        if self.alloc.rollback_to(self.slot_pages[slot], kv_after, keep=keep):
            self.page_table[slot, :] = kvc.make_page_table_row(
                self.slot_pages[slot], self.ecfg.max_pages_per_seq)

    def _drop_expired_slot(self, slot: int, core: MQCore) -> None:
        """An expired request never burns a k-token verify span."""
        tm.DEADLINE_DROPS_TOTAL.labels(model=self.name).inc()
        tm.SHED_TOTAL.labels(reason="deadline").inc()
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
        return best

    def _preempt_slot(self, slot: int) -> None:
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
            self._preempt_slot(victim)
            if self.slot_req[slot] is None:
                return  # this slot was the victim
            if self._extend_pages(pages, need_tokens):
                self._stalled_slots.discard(slot)
                return
        self.slot_req[slot].trace_event("kv_stall", pages=len(pages))
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
        (self.pending_prefill if queue is None else queue).appendleft(req)
        return True

    def _retry_embed(self, req: Request, msg: str) -> bool:
        return self._retry_requeue(req, msg, self.pending_embed)

    @staticmethod
    def _poison_msg(req: Request, msg: str) -> str:
        """Error text once the retry budget is spent: the client sees that
        retries happened and stopped on purpose."""
        if req.retries:
            return (f"{msg} (request poisoned after {req.retries} "
                    f"retr{'y' if req.retries == 1 else 'ies'})")
        return msg

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
        while self.pending_prefill:
            req = self.pending_prefill[0]
            if req.cancelled.is_set():
                self.pending_prefill.popleft()
                core.mark_dropped(req.user)
                req.finish(FinishReason.CANCELLED)
                continue
            if req._retry_at > time.monotonic():
                break  # the head is backing off after a contained fault
            if req.expired():
                self.pending_prefill.popleft()
                drop_expired(req, core, self.name)
                continue
            n = len(req.prompt_tokens)
            max_prompt = min(self.ecfg.max_context - 1, self.cfg.max_seq_len - 1)
            if n > max_prompt or n == 0:
                self.pending_prefill.popleft()
                core.mark_dropped(req.user)
                req.finish(FinishReason.ERROR, error=(
                    f"prompt length {n} exceeds maximum {max_prompt}" if n
                    else "empty prompt"))
                continue
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
                req.finish(FinishReason.CANCELLED)
                continue
            if req.expired():
                self._drop_chunking(req)
                drop_expired(req, core, self.name)
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
            self._ragged_failed(rows, e, core)
            return True
        finally:
            self.inflight_prefill = []
        dt = time.monotonic() - t0
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
                if proposed > accepted and self.slot_req[slot] is req:
                    # Rejected drafts claimed pages past the accepted
                    # context (a finished stream released everything).
                    self._rollback_spec(slot, int(self.seq_lens[slot]) + 1)
        self._note_occupancy()
        mean_ctx = float(np.mean(kv_len[:len(rows)])) if rows else 0.0
        # MFU over EVERY real token the dispatch processed (prefill spans
        # do the same per-token matmuls as decode rows).
        self.mfu = mfu_model.mfu(self.cfg, T_real, dt, self.peak_flops,
                                 context_len=mean_ctx)
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
            self.ecfg.page_size)
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
        for kind, slot, req, _cpos, _span in rows:
            if kind == "prefill":
                self._drop_chunking(req)
            else:
                if self.slot_req[slot] is not req:
                    continue
                replay = req.prompt_tokens + req.generated_ids[req._replay_gen:]
                written = len(replay) - 1 if req.generated_ids else len(replay)
                req.prompt_tokens = replay[:written]
                self._release_slot_pages(slot, req if written else None)
                req.prompt_tokens = replay
                req._replay_gen = len(req.generated_ids)
                self._clear_slot(slot)
            if not self._retry_requeue(req, msg):
                core.mark_dropped(req.user)
                req.finish(FinishReason.ERROR, error=self._poison_msg(req, msg))

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
        self._fault("decode")
        tokens, positions, act_d, pt_d, tk_d = self._to_dev(
            [self.last_tokens, self.seq_lens, active_mask, self.page_table,
             self.top_k], np.int32)
        temp_d, tp_d, pen_d, pres_d, freq_d = self._to_dev(
            [self.temp, self.top_p, self.rep_pen, self.pres_pen,
             self.freq_pen], np.float32)
        seeds = self.seeds.copy()
        steps = []
        for j in range(k_steps):
            logits, _, _ = llama.forward_decode(
                self.params, self.cfg, tokens, positions, self.kc, self.vc,
                pt_d, self.ecfg.page_size)
            ring = self.recent[:S]
            pen_logits = maybe_apply_penalties(logits, ring, pen_d, pres_d,
                                               freq_d, need_pen)
            # Seeded rows draw at the position being SAMPLED (one past
            # the incoming token's).
            u = (row_uniforms(self.gen, seeds, self.seq_lens + j + 1,
                              logits.shape[1], self.device)
                 if need_sample else None)
            nxt = sample_tokens_rowwise(pen_logits, u, temp_d, tk_d, tp_d,
                                        need_mask, need_sample)
            # Roll the sampled token into ACTIVE slots' rings only.
            rolled = torch.cat([ring[:, 1:], nxt[:, None]], dim=1)
            self.recent[:S] = torch.where(act_d[:, None] > 0, rolled, ring)
            steps.append(nxt)
            tokens, positions = nxt, positions + 1
        self.decode_dispatches += 1
        self.decode_steps += k_steps
        out = torch.stack(steps)
        _sp.mark("dispatch")
        self._sp_decode = _sp
        return out, active, k_steps, t0

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
                                 context_len=mean_ctx)
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
        return llama.forward_embed(self.params, self.cfg, toks, n)

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


class EncoderRuntime:
    """Embedding-model runtime: batched bidirectional encodes of padded
    inputs (serve_embed_batch), no KV pool, no decode slots."""

    SERVES = ("embed",)
    # Deterministic fault injection, attached by the engine.
    fault_plan = None

    def __init__(self, name: str, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, device=None, dtype=None,
                 params: Optional[dict] = None,
                 checkpoint_path: Optional[str] = None):
        err = validate_quant_config(engine_cfg.weights_dtype, engine_cfg.kv_dtype)
        if err is not None:
            raise ValueError(err)
        self.name = name
        self.cfg = model_cfg
        self.ecfg = engine_cfg
        self.weights_dtype = engine_cfg.weights_dtype
        self.device = resolve_device(device)
        self.dtype = dtype if dtype is not None else DTYPES[engine_cfg.dtype]
        self.tokenizer = load_tokenizer(checkpoint_path)
        if params is None:
            params = weights.load_params(model_cfg, checkpoint_path,
                                         engine_cfg.seed, self.dtype,
                                         self.weights_dtype, self.device)
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
        return llama.forward_encoder(self.params, self.cfg, toks, n)

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


def build_model_runtimes(name: str, cfg: ModelConfig, engine_cfg: EngineConfig,
                         device, dtype, checkpoint_path: Optional[str] = None,
                         params: Optional[dict] = None) -> list:
    """The runtimes serving one model: THE construction path of
    TorchEngine.load_model and of a failed runtime's rebuild. One runtime
    per model here (the reference's data-parallel replicas wait for
    multi-device layouts)."""
    cls = EncoderRuntime if cfg.is_encoder else ModelRuntime
    return [cls(name, cfg, engine_cfg, device, dtype, params=params,
                checkpoint_path=checkpoint_path)]


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

    def __init__(self, engine_cfg: EngineConfig, device=None, dtype=None,
                 blocklist_path: Optional[str] = None,
                 params: Optional[dict] = None,
                 fairness: Fairness = Fairness.REQUESTS,
                 models: Optional[Dict[str, Optional[str]]] = None):
        self.ecfg = engine_cfg
        # The scheduling policy is built before any device work, so an
        # unknown --scheduler fails at start-up.
        self.policy = make_policy(engine_cfg)
        self.device = resolve_device(device)
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

    def _attach_hooks(self, rt) -> None:
        rt.fault_plan = self.fault_plan
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
        (rt,) = build_model_runtimes(name, cfg, self.ecfg, self.device,
                                     self.dtype, checkpoint_path, params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # loaded = resident, not queued
        self._attach_hooks(rt)

        def install() -> None:
            if name in self.runtimes:
                return  # a concurrent pull of the same model won
            self.runtimes[name] = rt
            self._model_sources[name] = checkpoint_path
            if params is not None:
                self._model_params[name] = params

        self.call_on_loop(install)
        log.info("loaded model %s (%.1f MB of weights)", name, rt.param_bytes / 1e6)
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
            if rt in self._failed_runtimes:
                self._failed_runtimes.remove(rt)
            # Drop the device tensors now, whoever still holds the
            # runtime object.
            rt.params = None
            if isinstance(rt, ModelRuntime):
                rt.kc = rt.vc = rt.recent = None
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
                        sampling=None, kind: str = "generate") -> Request:
        """Enqueue into the native core AND register the Request under one
        lock, so the loop can never pop an id it doesn't know. Raises
        BlockedError for blocked users/IPs and QueueFullError at a
        bounded-admission cap (--max-queued / --max-queued-per-user)."""
        cfg = self.ecfg
        if not self.accepting:
            self._count_shed("queue_full")
            raise QueueFullError("queue_full", 5.0, 0)
        if cfg.max_queued and self.core.total_queued() >= cfg.max_queued:
            self._count_shed("queue_full")
            raise QueueFullError("queue_full", self.retry_after_s(), cfg.max_queued)
        if (cfg.max_queued_per_user
                and self.core.queue_len(user) >= cfg.max_queued_per_user):
            self._count_shed("user_queue_full")
            raise QueueFullError("user_queue_full", self.retry_after_s(),
                                 cfg.max_queued_per_user)
        with self._pending_lock:
            rid = self.core.enqueue(user, ip, model, family, kind=kind)
            req = Request(rid, user, model, prompt_tokens or [], sampling,
                          kind=kind)
            req.trace = self.tracer.begin(rid, user, model, kind=kind)
            self.pending[rid] = req
        self.notify()
        return req

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

    def _requeue_front(self, req: Request) -> bool:
        """Return a request to the FRONT of its user's native queue under a
        fresh id. False when its user is blocked: it is finished here."""
        try:
            with self._pending_lock:
                rid = self.core.requeue_front(req.user, "", req.model,
                                              kind=req.kind)
                req.req_id = rid
                self.pending[rid] = req
        except BlockedError:
            self.core.mark_dropped(req.user, started=req.started)
            req.finish(FinishReason.CANCELLED)
            return False
        self.notify()
        return True

    def _requeue_preempted(self, req: Request) -> bool:
        """on_preempt hook: a preempted request goes back to the front of
        its user's queue for recompute. False => it was cancelled, expired
        or blocked and is finished here (its pages are already free)."""
        if req.cancelled.is_set():
            self.core.mark_dropped(req.user)
            req.finish(FinishReason.CANCELLED)
            return False
        if req.expired():
            drop_expired(req, self.core, req.model)
            return False
        req.trace_event("requeue")
        return self._requeue_front(req)

    def _retry_or_error(self, req: Request, msg: str,
                        replay: bool = False) -> None:
        """Route a request implicated in a runtime failure: one more try
        via the front of its user's queue (the runtime's pending gate
        honours the backoff), or an explicit poisoned error once the
        budget is spent. replay=True folds generated ids into the prompt
        so a mid-decode victim resumes its stream."""
        if req.cancelled.is_set():
            self.core.mark_dropped(req.user, started=req.started)
            req.finish(FinishReason.CANCELLED)
            return
        if req.expired():
            drop_expired(req, self.core, req.model)
            return
        if req.retries >= self.ecfg.step_retries:
            self.core.mark_dropped(req.user, started=req.started)
            req.finish(FinishReason.ERROR, error=ModelRuntime._poison_msg(req, msg))
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
        for rt in list(self.runtimes.values()):
            for cand in (rt.held_requests()
                         + list(getattr(rt, "inflight_prefill", ()))):
                if cand.req_id == req_id:
                    cand.cancelled.set()
                    self.notify()
                    return

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
            for _rid, user, model, req in pol.order_admission(batch):
                req.trace_event("admit")
                if self._place(req, user, model):
                    admitted += 1
            if stuck or not items:
                break
        return admitted

    def _place(self, req: Request, user: str, model: str) -> bool:
        if req.cancelled.is_set() or self.core.is_user_or_ip_blocked(user):
            self.core.mark_dropped(user, started=req.started)
            req.finish(FinishReason.CANCELLED)
            return False
        if req.expired():
            drop_expired(req, self.core, model)
            return False
        rt = self.resolve_runtime(model, kind=req.kind)
        if rt is None and model:
            # Evicted between the native gate and placement: back to the
            # front of the user's queue until the model is loaded again.
            return self._requeue(req, user, model)
        if rt is None:
            self.core.mark_dropped(user, started=req.started)
            req.finish(FinishReason.ERROR, error=f"model not loaded: {model}")
            return False
        if req.kind not in rt.SERVES:
            # A permanent mismatch: error it, never park it.
            self.core.mark_dropped(user, started=req.started)
            req.finish(FinishReason.ERROR, error=(
                f"model {model or rt.name} is an embedding-only model"
                if req.kind == "generate" else
                f"model {model or rt.name} does not support embeddings"))
            return False
        rt.submit(req)
        req.trace_event("place", runtime=rt.name)
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
        except BlockedError:
            self.core.mark_dropped(user, started=False)
            req.finish(FinishReason.CANCELLED)
        return False

    def _kill_runtime(self, rt, exc: Exception) -> None:
        """Contain a failed step: retry or poison every request the runtime
        holds, drop its device buffers (the rebuild must fit beside the
        other runtimes) and queue it for a rebuild."""
        log.error("runtime %s step failed: %s", rt.name, exc, exc_info=exc)
        self._fail_runtime(rt, f"engine step failed: {exc}")
        rt._failed = True
        rt.params = rt.kc = rt.vc = rt.recent = None
        self._failed_runtimes.append(rt)

    def _fail_runtime(self, rt, msg: str) -> None:
        """Each implicated request is retried ONCE on a fresh dispatch
        (mid-decode victims replay prompt + generated so their streams
        resume after the rebuild); one that keeps failing is poisoned."""
        if isinstance(rt, EncoderRuntime):
            while rt.pending:
                self._retry_or_error(rt.pending.popleft(), msg)
            return
        for i, req in enumerate(rt.slot_req):
            if req is not None:
                rt._release_slot_pages(i)
                rt.seq_lens[i] = 0
                rt.slot_req[i] = None
                self._retry_or_error(req, msg, replay=True)
        rt._stalled_slots.clear()
        for q in (rt.pending_prefill, rt.pending_embed, rt.chunking):
            while q:
                self._retry_or_error(q.popleft(), msg)
        for slot in list(rt.reserved_slots):
            rt._release_slot_pages(slot)
        rt.reserved_slots.clear()

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
                rt.name, rt.cfg, self.ecfg, self.device, self.dtype,
                self._model_sources.get(rt.name),
                self._model_params.get(rt.name))
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
            if self.runtimes.get(rt.name) is not rt:
                continue  # evicted meanwhile: the rebuild is dropped
            self._attach_hooks(fresh)
            self.runtimes[rt.name] = fresh
            for r in rt.held_requests():
                fresh.submit(r)
            if rt in self._failed_runtimes:
                self._failed_runtimes.remove(rt)
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
            if isinstance(rt, ModelRuntime):  # encoders hold no page pool
                row.update(free=rt.alloc.free_pages, used=rt.alloc.used_pages,
                           cached=rt.alloc.cached_pages,
                           pool=rt.alloc.num_pages - 1)
            models[name] = row
        sample = {"models": models}
        mem = device_memory(self.device)  # None on the CPU: no readings
        if mem is not None:
            sample["device"] = mem
        stepprof.PROFILER.hbm_record(sample)

    def _loop_once(self) -> None:
        self.last_tick_at = time.monotonic()
        self._sample_hbm_timeline()
        self._drain_engine_calls()
        self._swap_rebuilt()
        if (self._failed_runtimes and time.monotonic()
                - self._last_recover_attempt > self.recover_interval):
            self._try_recover()
        self._admit()
        did_work = False
        handles = []
        # Phase 1: ragged ticks and decode DISPATCH for every runtime;
        # phase 2 collects, so host work overlaps the device.
        for rt in self.runtimes.values():
            if rt._failed:
                continue
            try:
                rt.check_cancellations(self.core)
                if isinstance(rt, EncoderRuntime):
                    if rt.has_work():
                        rt.step(self.core)
                        did_work = True
                    continue
                ran_ragged = rt.step_ragged(self.core)
                did_work = did_work or ran_ragged
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
        for rt, h in handles:
            if rt._failed:
                continue
            try:
                rt.step_decode_collect(h, self.core)
            except Exception as e:  # noqa: BLE001 — contain to this runtime
                self._kill_runtime(rt, e)
        if not did_work:
            with self._cond:
                self._cond.wait(timeout=0.05)

    # -- counters ------------------------------------------------------------
    def prefix_cache_stats(self) -> dict:
        models = {name: rt.prefix_cache.stats()
                  for name, rt in dict(self.runtimes).items()
                  if rt.prefix_cache is not None}
        return {"enabled": bool(models), "models": models}

    def prefix_cache_flush(self) -> int:
        """Evict every unreferenced cached page, on the loop thread (the
        tree and the allocator are loop state)."""
        return self.call_on_loop(lambda: sum(
            rt.prefix_cache.flush() for rt in self.runtimes.values()
            if rt.prefix_cache is not None))

    def preemption_count(self) -> int:
        return sum(rt.preempt_count for rt in list(self.runtimes.values()))

    def retry_count(self) -> int:
        return self._engine_retries + sum(rt.retry_count
                                          for rt in list(self.runtimes.values()))

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
        return chip_stats(self.device)

    def stats(self) -> dict:
        runtime_stats = [rt.stats() for rt in list(self.runtimes.values())]
        chips = self.chip_stats()
        hbm_total = sum(c["hbm_total"] for c in chips) or None
        return {"queued": self.core.total_queued(),
                "device": str(self.device),
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
