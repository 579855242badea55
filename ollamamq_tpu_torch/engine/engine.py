"""Continuous-batching engine on PyTorch (one device).

The JAX package's serving loop, carried over for the single-device main
path:

  - admission: the engine loop pops requests from the native fair-share
    core (cpp/mqcore.cpp) whenever the model runtime has a free slot and
    KV pages;
  - ragged ticks: every admitted prompt rides the span path. A tick with
    a prefill span in flight packs those spans plus every live decode
    row into ONE flattened token stream (forward_ragged, the ragged
    paged-attention kernel), then the penalty ring and sampling;
  - decode ticks: with no prefill in flight, all live slots advance
    k_steps tokens in one dispatch (forward_decode, the paged decode
    kernel, in a Python loop of k_steps), collected after every runtime
    has dispatched.

Where the JAX jits donated the KV pools and the recent-token ring, this
engine updates them IN PLACE. Device work is issued without host
synchronisation until a tick's tokens are read back.

With weights_dtype="int8" the runtime quantizes its weights when it
builds them (int8 QuantTensors, f32 per-channel scales); with
kv_dtype="int8" its pools are QuantKV (int8 payload, f32 per-slot
per-head scales) and both forwards go through the int8-pool kernels.

Not carried over yet (later slices): speculative decoding, the prefix
cache, preemption with recompute, retries and runtime rebuilds, KV
migration, embeddings, multi-device layouts, fleet, durability, journal
and telemetry. A failed dispatch errors the runtime's requests.
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
from ollamamq_tpu_torch.core.mqcore import Family, MQCore, StuckQueue
from ollamamq_tpu_torch.engine import kv_cache as kvc
from ollamamq_tpu_torch.engine.request import FinishReason, Request, StreamItem
from ollamamq_tpu_torch.engine.tokenizer import ByteTokenizer
from ollamamq_tpu_torch.models import llama, weights
from ollamamq_tpu_torch.ops.quant import nbytes
from ollamamq_tpu_torch.ops.sampling import (maybe_apply_penalties, row_uniforms,
                                             sample_tokens_rowwise, sampling_flags)

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


def drop_expired(req: Request, core: MQCore) -> None:
    """Finish an expired request with the explicit deadline reason."""
    core.mark_dropped(req.user, started=req.started)
    req.finish(FinishReason.DEADLINE,
               error="deadline expired before completion")


class ModelRuntime:
    """Per-model serving state: weights, KV pool, slot table, steps."""

    def __init__(self, name: str, model_cfg: ModelConfig,
                 engine_cfg: EngineConfig, device=None, dtype=None,
                 params: Optional[dict] = None):
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
        self.tokenizer = ByteTokenizer()
        # Params passed in are used as given (already quantized or not);
        # random weights are quantized at build time for int8, as the JAX
        # package's load_params does.
        if params is None:
            params = weights.init_random(model_cfg, engine_cfg.seed,
                                         self.dtype, self.device)
            if self.weights_dtype == "int8":
                params = weights.quantize_params_int8(params)
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
        # Slots mid-prefill: reserved (not schedulable) but not decoding.
        self.reserved_slots: set = set()
        self.slot_req: List[Optional[Request]] = [None] * S
        self.slot_pages: List[List[int]] = [[] for _ in range(S)]
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
        # Admitted prompts whose spans are still being prefilled.
        self.chunking: collections.deque = collections.deque()
        # Requests inside a dispatch right now (cancel() must find them).
        self.inflight_prefill: List[Request] = []
        self._block_ver = -1  # first tick sweeps the loaded blocklist
        # Engine-stream generator for unseeded sampled rows.
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(engine_cfg.seed)
        self._failed = False
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
        # Counters (host side).
        self.tokens_generated = 0
        self.ragged_dispatches = 0
        self.decode_dispatches = 0
        self.decode_steps = 0
        self.step_latency_ms = 0.0
        self.prefill_latency_ms = 0.0
        # Device bytes, payload plus scales for int8 leaves and pools.
        self.param_bytes = sum(nbytes(t) for t in _leaves(self.params))
        self.kv_bytes = nbytes(self.kc) + nbytes(self.vc)

    # -- capacity ----------------------------------------------------------
    def free_slots(self) -> int:
        return sum(r is None and i not in self.reserved_slots
                   for i, r in enumerate(self.slot_req))

    def has_capacity(self) -> bool:
        """Can one more request be taken from the scheduler right now?"""
        return (not self._failed
                and len(self.pending_prefill) < 2 * self.ecfg.max_slots
                and self.free_slots() > 0
                and self.alloc.free_pages >= 2)

    def has_work(self) -> bool:
        return (bool(self.pending_prefill) or bool(self.chunking)
                or any(r is not None for r in self.slot_req))

    def active_count(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def held_requests(self) -> List[Request]:
        return ([r for r in self.slot_req if r is not None]
                + list(self.pending_prefill) + list(self.chunking))

    def submit(self, req: Request) -> bool:
        if req._inc_decode is None:
            req._inc_decode = self.tokenizer.make_incremental_decoder()
        self.pending_prefill.append(req)
        return True

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

    def _release_slot_pages(self, slot: int) -> None:
        self.alloc.free(self.slot_pages[slot])
        self.page_table[slot, :] = kvc.TRASH_PAGE

    def _clear_slot(self, slot: int) -> None:
        self.seq_lens[slot] = 0
        self.temp[slot] = 0.0
        self.top_k[slot] = 0
        self.top_p[slot] = 1.0
        self.rep_pen[slot] = 1.0
        self.pres_pen[slot] = 0.0
        self.freq_pen[slot] = 0.0
        self.seeds[slot] = 0
        self.slot_req[slot] = None

    def _finish_slot(self, slot: int, reason: FinishReason, core: MQCore,
                     flush: bool = True, error: str = "") -> None:
        """`flush=False` on the stop-string path: held-back text holds
        the stop sequence the client asked to suppress."""
        req = self.slot_req[slot]
        if req is None:
            return
        self._release_slot_pages(slot)
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
        if not req.stats.first_token_at:
            req.stats.first_token_at = time.monotonic()
        text = req._inc_decode(tok)
        chunk = req.emit_text(text) if text else ""
        if chunk is None:  # stop string fired: suppress held-back text
            self._finish_slot(slot, FinishReason.STOP, core, flush=False)
            return False
        # Every sampled token is pushed, text or not, so the id stream is
        # complete.
        req.stream.push(StreamItem("token", text=chunk, token_id=tok))
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

    KV_EXHAUSTED_MSG = ("KV page pool exhausted mid-decode; retry, shorten "
                        "the prompt, or raise --num-pages")

    def _grow_pages(self, slot: int, need_tokens: int, core: MQCore) -> None:
        """Page headroom for a live slot: grow it, or finish it — an
        honest LENGTH at the per-sequence cap, an explicit kv_exhausted
        error when the pool is dry (never a silent truncation)."""
        pages = self.slot_pages[slot]
        if self.alloc.extend(pages, need_tokens):
            self.page_table[slot, :] = kvc.make_page_table_row(
                pages, self.ecfg.max_pages_per_seq)
        elif (self.alloc.pages_needed(need_tokens) > self.alloc.max_pages_per_seq
              or len(pages) >= self.alloc.max_pages_per_seq):
            self._finish_slot(slot, FinishReason.LENGTH, core)
        else:
            self._finish_slot(slot, FinishReason.KV_EXHAUSTED, core,
                              error=self.KV_EXHAUSTED_MSG)

    # -- admission ---------------------------------------------------------
    def _admit_ragged(self, core: MQCore) -> bool:
        """Claim a reserved slot + the prompt's full page allocation for
        each pending prompt and queue it on `chunking`: every prefill
        rides the span path, sized each tick by the token budget."""
        did = False
        while self.pending_prefill:
            req = self.pending_prefill[0]
            if req.cancelled.is_set():
                self.pending_prefill.popleft()
                core.mark_dropped(req.user)
                req.finish(FinishReason.CANCELLED)
                continue
            if req.expired():
                self.pending_prefill.popleft()
                drop_expired(req, core)
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
            slot = self._claim_slot()
            if slot is None:
                break
            pages = self.alloc.alloc(n + 1)
            if pages is None:
                break  # pool exhausted; retry after frees
            self.pending_prefill.popleft()
            self.slot_pages[slot] = pages
            req._chunk_pos = 0
            # The row stays OFF the shared page table until install: decode
            # steps write through self.page_table, and a reserved slot must
            # keep pointing at the trash page meanwhile.
            req._pt_row = kvc.make_page_table_row(pages, self.ecfg.max_pages_per_seq)
            req._prefill_slot = slot
            self.reserved_slots.add(slot)
            self.chunking.append(req)
            did = True
        return did

    def _drop_chunking(self, req: Request) -> None:
        """Remove a span-path request: release its pages and reservation."""
        slot = req._prefill_slot
        self.chunking.remove(req)
        self._release_slot_pages(slot)
        self.reserved_slots.discard(slot)

    # -- ragged tick -------------------------------------------------------
    def step_ragged(self, core: MQCore) -> bool:
        """ONE ragged mixed-batch tick: admit pending prompts, then pack
        every live decode slot (one token each) plus as many prefill-span
        tokens as the token budget allows into a single dispatch. True
        when a mixed dispatch ran (decode slots advanced inside it);
        False leaves decode to step_decode_dispatch."""
        self._admit_ragged(core)
        if not self.chunking:
            return False
        for i, r in enumerate(self.slot_req):
            if r is not None:
                self._grow_pages(i, int(self.seq_lens[i]) + 1, core)
        rows: List[tuple] = [("decode", i, r, 0, 1)
                             for i, r in enumerate(self.slot_req) if r is not None]
        n_decode = len(rows)
        budget = self._ragged_budget - n_decode
        for req in list(self.chunking):
            if budget <= 0:
                break
            if req.cancelled.is_set() or req.stream.overflowed:
                self._drop_chunking(req)
                core.mark_dropped(req.user)
                req.finish(FinishReason.CANCELLED)
                continue
            if req.expired():
                self._drop_chunking(req)
                drop_expired(req, core)
                continue
            span = min(len(req.prompt_tokens) - req._chunk_pos, budget)
            rows.append(("prefill", req._prefill_slot, req, req._chunk_pos, span))
            budget -= span
        if len(rows) == n_decode:
            return False  # no span ready this tick: decode runs fused

        # Dispatch total from the ladder: the largest rung the stream can
        # be TRIMMED down to (tail prefill tokens go next tick), else the
        # next rung up.
        T_raw = sum(span for *_, span in rows)
        lower = n_decode + 1
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
            if kind == "decode":
                pos = int(self.seq_lens[slot])
                row = self.page_table[slot]
                tokens[off] = self.last_tokens[slot]
                tok_seq[off] = idx
                tok_pos[off] = pos
                write_slots[off] = row[pos // ps] * ps + pos % ps
                kv_len[idx] = pos + 1
                append[idx] = 1  # ring_len 0: input token already rolled
                pt_rows[idx] = row
            else:
                row = req._pt_row
                positions = np.arange(cpos, cpos + span, dtype=np.int32)
                tokens[off:off + span] = req.prompt_tokens[cpos:cpos + span]
                tok_seq[off:off + span] = idx
                tok_pos[off:off + span] = positions
                write_slots[off:off + span] = row[positions // ps] * ps + positions % ps
                kv_len[idx] = cpos + span
                ring_len[idx] = span
                is_first[idx] = 1 if cpos == 0 else 0
                append[idx] = 1 if cpos + span >= len(req.prompt_tokens) else 0
                pt_rows[idx] = row
            off += span

        prefill_rows = [r for r in rows if r[0] == "prefill"]
        self.inflight_prefill = [r[2] for r in prefill_rows]
        t0 = time.monotonic()
        try:
            toks = self._ragged_dispatch(
                T_pad, tokens, tok_seq, tok_pos, write_slots, q_start, q_len,
                kv_len, ring_len, is_first, append, seed_rows, slot_ids,
                pt_rows, temp, top_k, top_p, pen, pres, freq, seeds)
        finally:
            self.inflight_prefill = []
        dt = time.monotonic() - t0
        self.ragged_dispatches += 1
        if prefill_rows:
            self.prefill_latency_ms = dt * 1e3
        if n_decode:
            self.step_latency_ms = dt * 1e3

        for idx, (kind, slot, req, cpos, span) in enumerate(rows):
            if kind == "decode":
                if self.slot_req[slot] is not req:
                    continue  # finished between compose and emit
                self.seq_lens[slot] += 1
                self.tokens_generated += 1
                if self._emit_token(slot, int(toks[idx]), core):
                    self.last_tokens[slot] = toks[idx]
            else:
                req._chunk_pos = cpos + span
                if req._chunk_pos >= len(req.prompt_tokens):
                    # Final span: publish the page-table row (decode writes
                    # through it from now on), install, emit.
                    self.chunking.remove(req)
                    self.reserved_slots.discard(slot)
                    self.page_table[slot, :] = req._pt_row
                    self._install_slot(slot, req, len(req.prompt_tokens),
                                       int(toks[idx]), core)
        return True

    def _ragged_dispatch(self, T_pad, tokens, tok_seq, tok_pos, write_slots,
                         q_start, q_len, kv_len, ring_len, is_first, append,
                         seed_rows, slot_ids, pt_rows, temp, top_k, top_p,
                         pen, pres, freq, seeds) -> np.ndarray:
        """Forward the flattened stream, maintain the penalty ring, sample
        one token per row. Returns the sampled tokens [S] on the host."""
        need_pen, need_mask, need_sample = sampling_flags(
            temp, top_k, top_p, pen, pres, freq)
        (tokens_d, tok_seq_d, tok_pos_d, ws_d, qs_d, ql_d, kv_d, rl_d,
         first_d, app_d, seed_rows_d, slots_d, pt_d, tk_d) = self._to_dev(
            [tokens, tok_seq, tok_pos, write_slots, q_start, q_len, kv_len,
             ring_len, is_first, append, seed_rows, slot_ids, pt_rows, top_k],
            np.int32)
        temp_d, tp_d, pen_d, pres_d, freq_d = self._to_dev(
            [temp, top_p, pen, pres, freq], np.float32)
        # Every row reads the logit of its span's last token.
        out_idx = (qs_d + ql_d - 1).clamp(0, T_pad - 1)
        logits, _, _ = llama.forward_ragged(
            self.params, self.cfg, tokens_d, tok_seq_d, tok_pos_d, ws_d,
            out_idx, self.kc, self.vc, pt_d, qs_d, ql_d, kv_d,
            self.ecfg.page_size)
        # Penalty ring: open from seed_rows on a request's first span,
        # slide each ring by ring_len tokens of its own span (0 for decode
        # rows, whose input token rolled in when it was sampled).
        W = self.recent.shape[1]
        slots_l = slots_d.long()
        rows = torch.where(first_d[:, None] > 0, seed_rows_d, self.recent[slots_l])
        j_w = torch.arange(W, device=self.device)
        cidx = rl_d[:, None] + j_w[None, :] - W
        from_stream = tokens_d[(qs_d[:, None] + cidx).clamp(0, T_pad - 1).long()]
        from_row = torch.gather(rows, 1, (rl_d[:, None] + j_w[None, :]).clamp(0, W - 1).long())
        new_rows = torch.where(cidx >= 0, from_stream, from_row)
        pen_logits = maybe_apply_penalties(logits, new_rows, pen_d, pres_d,
                                           freq_d, need_pen)
        # kv_len IS the position being sampled for every row shape.
        u = (row_uniforms(self.gen, seeds, kv_len, logits.shape[1], self.device)
             if need_sample else None)
        tok = sample_tokens_rowwise(pen_logits, u, temp_d, tk_d, tp_d,
                                    need_mask, need_sample)
        # Rows that emit (decode rows, final prefill spans) roll the
        # sampled token in; mid-prefill spans do not.
        appended = torch.cat([new_rows[:, 1:], tok[:, None]], dim=1)
        self.recent[slots_l] = torch.where(app_d[:, None] > 0, appended, new_rows)
        return tok.cpu().numpy()

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
        active."""
        for i, r in enumerate(self.slot_req):
            if r is not None:
                self._grow_pages(i, int(self.seq_lens[i]) + k_steps, core)
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return None
        t0 = time.monotonic()
        S = self.ecfg.max_slots
        active_mask = np.zeros(S, np.int32)
        active_mask[active] = 1
        need_pen, need_mask, need_sample = sampling_flags(
            self.temp, self.top_k, self.top_p, self.rep_pen, self.pres_pen,
            self.freq_pen)
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
        return torch.stack(steps), active, k_steps, t0

    def step_decode_collect(self, handle, core: MQCore) -> int:
        """Read a dispatched decode chunk's tokens back (this blocks until
        the device is done) and emit them."""
        toks_d, active, k_steps, t0 = handle
        toks = toks_d.cpu().numpy()  # [K, S]
        self.step_latency_ms = (time.monotonic() - t0) * 1e3 / k_steps
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
        return emitted

    def check_cancellations(self, core: MQCore) -> None:
        """Reap cancelled requests and those of users blocked after
        admission (version-gated: no FFI work unless the blocklist
        changed)."""
        self._block_ver = sweep_blocked(core, self.held_requests(), self._block_ver)
        for i, req in enumerate(self.slot_req):
            if req is not None and req.cancelled.is_set():
                self._finish_slot(i, FinishReason.CANCELLED, core)

    def fail_all(self, core: MQCore, msg: str) -> None:
        """Error out every request this runtime holds (after a failed
        step) and mark the runtime failed."""
        self._failed = True
        for i, req in enumerate(self.slot_req):
            if req is not None:
                self._finish_slot(i, FinishReason.ERROR, core, error=msg)
        for req in list(self.chunking) + list(self.pending_prefill):
            core.mark_dropped(req.user)
            req.finish(FinishReason.ERROR, error=msg)
        self.chunking.clear()
        self.pending_prefill.clear()

    def stats(self) -> dict:
        return {"model": self.name, "device": str(self.device),
                "active": self.active_count(),
                "pending_prefill": len(self.pending_prefill),
                "chunking": len(self.chunking),
                "tokens_generated": self.tokens_generated,
                "ragged_dispatches": self.ragged_dispatches,
                "decode_dispatches": self.decode_dispatches,
                "decode_steps": self.decode_steps,
                "step_latency_ms": round(self.step_latency_ms, 3),
                "prefill_latency_ms": round(self.prefill_latency_ms, 3),
                "kv_pages_used": self.alloc.used_pages,
                "kv_pages_free": self.alloc.free_pages,
                "param_bytes": self.param_bytes, "kv_bytes": self.kv_bytes,
                "weights_dtype": self.weights_dtype, "kv_dtype": self.kv_dtype,
                "failed": self._failed}


def _leaves(params: dict):
    for k, v in params.items():
        if k == "layers":
            for lp in v:
                yield from lp.values()
        else:
            yield v


class TorchEngine:
    """Engine front: owns the fair-share core, the model runtime and the
    loop thread."""

    def __init__(self, engine_cfg: EngineConfig, device=None, dtype=None,
                 blocklist_path: Optional[str] = None,
                 params: Optional[dict] = None):
        self.ecfg = engine_cfg
        self.device = resolve_device(device)
        cfg = get_model_config(engine_cfg.model)
        if cfg is None:
            raise KeyError(f"unknown model architecture: {engine_cfg.model}")
        self.core = MQCore(blocklist_path)
        self.runtimes: Dict[str, ModelRuntime] = {
            engine_cfg.model: ModelRuntime(engine_cfg.model, cfg, engine_cfg,
                                           self.device, dtype, params)}
        self.pending: Dict[int, Request] = {}
        self._pending_lock = threading.Lock()
        self._cond = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None

    # -- request flow ------------------------------------------------------
    def enqueue_request(self, user: str, ip: str, model: str,
                        family: Family = Family.UNKNOWN, prompt_tokens=None,
                        sampling=None) -> Request:
        """Enqueue into the native core AND register the Request under one
        lock, so the loop can never pop an id it doesn't know. Raises
        BlockedError for blocked users/IPs."""
        with self._pending_lock:
            rid = self.core.enqueue(user, ip, model, family)
            req = Request(rid, user, model, prompt_tokens or [], sampling)
            self.pending[rid] = req
        self.notify()
        return req

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
        for rt in self.runtimes.values():
            for cand in rt.held_requests() + list(rt.inflight_prefill):
                if cand.req_id == req_id:
                    cand.cancelled.set()
                    self.notify()
                    return

    def resolve_runtime(self, model: str) -> Optional[ModelRuntime]:
        if not model:
            return next(iter(self.runtimes.values()), None)
        key = smart_match(model, self.runtimes.keys())
        return self.runtimes[key] if key is not None else None

    def notify(self) -> None:
        with self._cond:
            self._cond.notify()

    # -- loop ----------------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, name="engine",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        self.notify()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def _loop(self) -> None:
        while self._running:
            try:
                self._loop_once()
            except Exception:  # the loop thread must keep serving
                log.exception("engine loop iteration failed; continuing")
                time.sleep(0.1)

    def _admit(self) -> int:
        """Pop requests in fair-share order while a runtime can take one.
        A failed runtime stays eligible so its requests are popped and
        errored instead of parking forever."""
        admitted = 0
        while True:
            eligible = [name for name, rt in self.runtimes.items()
                        if rt._failed or rt.has_capacity()]
            if not eligible:
                break
            try:
                item = self.core.next(eligible)
            except StuckQueue:
                break
            if item is None:
                break
            rid, user, model = item
            with self._pending_lock:
                req = self.pending.pop(rid, None)
            if req is None:
                self.core.mark_dropped(user, started=False)
                continue
            if self._place(req, user, model):
                admitted += 1
        return admitted

    def _place(self, req: Request, user: str, model: str) -> bool:
        if req.cancelled.is_set() or self.core.is_user_or_ip_blocked(user):
            self.core.mark_dropped(user, started=False)
            req.finish(FinishReason.CANCELLED)
            return False
        if req.expired():
            drop_expired(req, self.core)
            return False
        rt = self.resolve_runtime(model)
        if rt is None or rt._failed:
            self.core.mark_dropped(user, started=False)
            req.finish(FinishReason.ERROR, error=(
                f"model not loaded: {model}" if rt is None
                else f"model {rt.name} failed; see the server log"))
            return False
        rt.submit(req)
        self.core.mark_started(user)
        req.started = True
        return True

    def _kill_runtime(self, rt: ModelRuntime, exc: Exception) -> None:
        log.error("runtime %s step failed: %s", rt.name, exc, exc_info=exc)
        rt.fail_all(self.core, f"engine step failed: {exc}")

    def _loop_once(self) -> None:
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
                if rt.step_ragged(self.core):
                    did_work = True
                elif rt.active_count():
                    # k=1 only when an admission could land between steps.
                    waiting = (bool(rt.pending_prefill)
                               or bool(self.core.queued_matching(rt.name)))
                    k = (1 if (waiting and rt.has_capacity()) or rt.chunking
                         else self.ecfg.decode_steps_per_iter)
                    h = rt.step_decode_dispatch(self.core, k_steps=k)
                    if h is not None:
                        handles.append((rt, h))
                        did_work = True
            except Exception as e:  # noqa: BLE001 — contain to this runtime
                self._kill_runtime(rt, e)
                did_work = True
        for rt, h in handles:
            try:
                rt.step_decode_collect(h, self.core)
            except Exception as e:  # noqa: BLE001 — contain to this runtime
                self._kill_runtime(rt, e)
        if not did_work:
            with self._cond:
                self._cond.wait(timeout=0.05)

    def stats(self) -> dict:
        return {"queued": self.core.total_queued(),
                "device": str(self.device),
                "runtimes": [rt.stats() for rt in self.runtimes.values()]}
