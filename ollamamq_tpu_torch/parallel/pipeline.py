"""Pipeline parallelism: the layers and their KV pages split over the
mesh's "pipe" axis, one process per stage.

A model larger than one device's memory serves only if its layers are
spread: stage s of P holds layers [s L/P, (s + 1) L/P) and a KV pool of
L/P layers (parallel/sharding.py), so a rank's weights and pages shrink
by P (the embedding, the final norm and the head stay whole on every
stage, as in the JAX package).

The JAX package runs the stages as one traced SPMD program: every stage
steps through M + P - 1 schedule steps, computing on garbage in its
bubble steps (their K/V go to the trash page) and handing activations on
with one ppermute per step. Here each stage is a process that runs only
its real work, GPipe-style:

  - the batch splits into M microbatches (n_microbatches); stage 0
    embeds microbatch m, runs its layers and sends the hidden states to
    stage 1, which receives m, runs its layers and sends on, in
    microbatch order; every send is asynchronous, so a stage starts
    microbatch m + 1 while its successor works on m;
  - the last stage keeps each microbatch's last-position hidden state
    and sends the whole [B, D] to every other stage; every stage then
    computes the same final norm and head (in float32) on it, so the
    logits are replicated wherever the sampler runs. The JAX package
    folds the stages' logits with a psum over pipe instead (zeros on all
    but the last stage): the same values;
  - tensor parallelism composes inside a stage: the stage's tensor
    group (mesh.tensor) carries the row-parallel sums and the vocabulary
    gathers, and tensor rank t of a stage hands off to tensor rank t of
    the next.

The stage body is the single-stage layer code (models/llama.py:
layer_step through prefill_layers and _layers), so int8 weights and
tensor parallelism come with it. The decode stage attends through the
same dispatch as forward_decode (paged_decode_attention_any): on a CUDA
tensor the hand-written decode kernel, at every process count, with one
microbatch's rows of the page table; a CPU tensor takes the plain
version. Bubble steps are skipped, not computed: nothing lands in the
trash page that the single-stage forward would not write there too.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from ollamamq_tpu_torch.config import ModelConfig
from ollamamq_tpu_torch.models import llama
from ollamamq_tpu_torch.ops.attention import (causal_attention,
                                              flat_slot_indices,
                                              paged_chunk_attention_blockwise,
                                              paged_decode_attention_any)


def n_microbatches(batch: int, pipe: int, requested: Optional[int] = None) -> int:
    """Microbatch count: the largest divisor of `batch` that is <= the
    requested count (default: the stage count, which keeps every stage
    busy in steady state with the fewest hand-offs). A request that does
    not divide the batch is rounded down (the runtime logs it for its
    decode batch)."""
    m = min(requested or pipe, batch)
    while batch % m:
        m -= 1
    return max(m, 1)


def _schedule(mesh, M: int, mb: int, x_shape: Tuple[int, ...], dtype, device,
              embed, run_stage) -> torch.Tensor:
    """Drive M microbatches through this rank's stage.

    embed(m) -> stage 0's input of microbatch m; run_stage(m, x) ->
    (h_out, x_last [mb, D]) runs this stage's layers on it. Returns the
    last stage's x_last of every microbatch, [M * mb, D], on every
    stage."""
    pipe = mesh.pipe
    t0 = time.perf_counter()
    lasts = []
    for m in range(M):
        x = (embed(m) if pipe.first
             else pipe.recv(x_shape, dtype, pipe.stage - 1, device))
        h, x_last = run_stage(m, x)
        if pipe.last:
            lasts.append(x_last)
        else:
            pipe.send(h, pipe.stage + 1)
    D = x_shape[-1]
    if pipe.last:
        hidden = torch.cat(lasts)
        for s in range(pipe.size - 1):
            pipe.send(hidden, s)
    else:
        hidden = pipe.recv((M * mb, D), dtype, pipe.size - 1, device)
    pipe.flush()
    pipe.stats["forwards"] += 1
    pipe.stats["forward_s"] += time.perf_counter() - t0
    return hidden


def _act(params: dict) -> Tuple[torch.dtype, torch.device]:
    norm = params["final_norm"]
    return norm.dtype, norm.device


def pp_forward_prefill(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] right-padded
    seq_lens: torch.Tensor,  # [B]
    k_cache,  # [L/P, S, Hk, hd]: this stage's layers, written in place
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages]
    page_size: int,
    mesh,  # RankMesh with a pipe axis
    n_micro: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pipelined forward_prefill; returns (last-valid-position logits
    [B, V] float32 on every stage, k_cache, v_cache)."""
    B, T = tokens.shape
    M = n_microbatches(B, mesh.pipe.size, n_micro)
    mb = B // M
    tp = mesh.tensor
    dtype, device = _act(params)
    pos_b = torch.arange(T, dtype=torch.int32, device=tokens.device).expand(B, T)
    slots = flat_slot_indices(page_table, pos_b, page_size)

    def embed(m):
        return llama._embed(params, cfg, tokens[m * mb:(m + 1) * mb].reshape(-1), tp)

    def run_stage(m, x):
        rows = slice(m * mb, (m + 1) * mb)
        lens = seq_lens[rows]

        def attend(q, k, v, kcl, vcl):
            return causal_attention(q, k, v, lens)

        valid = (pos_b[rows] < lens[:, None]).reshape(-1)
        h = llama.prefill_layers(cfg, params["layers"], x, pos_b[rows].reshape(-1),
                                 k_cache, v_cache, slots[rows], attend, valid, tp)
        return h, llama.last_valid(h.reshape(mb, T, -1), lens)

    hidden = _schedule(mesh, M, mb, (mb * T, cfg.hidden_size), dtype, device,
                       embed, run_stage)
    return llama._logits(params, cfg, hidden, tp), k_cache, v_cache


def pp_forward_prefill_chunk(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, C] one chunk of the prompt, right-padded
    start: torch.Tensor,  # [B] global position of the chunk's first token
    chunk_lens: torch.Tensor,  # [B] valid tokens in this chunk
    k_cache,  # [L/P, S, Hk, hd]: this stage's layers, written in place
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages]: covers prefix AND chunk
    page_size: int,
    mesh,  # RankMesh with a pipe axis
    n_micro: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pipelined forward_prefill_chunk (prompts past the largest
    bucket); chaining chunks reproduces pp_forward_prefill. Returns
    (last-valid-position logits [B, V] float32, k_cache, v_cache)."""
    B, C = tokens.shape
    M = n_microbatches(B, mesh.pipe.size, n_micro)
    mb = B // M
    tp = mesh.tensor
    dtype, device = _act(params)
    pos_b = start[:, None] + torch.arange(C, dtype=torch.int32,
                                          device=tokens.device)[None, :]
    slots = flat_slot_indices(page_table, pos_b, page_size)
    cols = torch.arange(C, device=tokens.device)[None, :]

    def embed(m):
        return llama._embed(params, cfg, tokens[m * mb:(m + 1) * mb].reshape(-1), tp)

    def run_stage(m, x):
        rows = slice(m * mb, (m + 1) * mb)
        st, cl = start[rows], chunk_lens[rows]
        ptm = page_table[rows].contiguous()

        def attend(q, k, v, kcl, vcl):
            # Blockwise online-softmax walk over the prefix already
            # written plus this chunk.
            return paged_chunk_attention_blockwise(q, kcl, vcl, ptm, st, cl,
                                                   page_size)

        valid = (cols < cl[:, None]).reshape(-1)
        h = llama.prefill_layers(cfg, params["layers"], x, pos_b[rows].reshape(-1),
                                 k_cache, v_cache, slots[rows], attend, valid, tp)
        return h, llama.last_valid(h.reshape(mb, C, -1), cl)

    hidden = _schedule(mesh, M, mb, (mb * C, cfg.hidden_size), dtype, device,
                       embed, run_stage)
    return llama._logits(params, cfg, hidden, tp), k_cache, v_cache


def pp_forward_decode(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B] last generated token per slot
    positions: torch.Tensor,  # [B] int32 position of `tokens`
    k_cache,  # [L/P, S, Hk, hd]: this stage's layers, written in place
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages]
    page_size: int,
    mesh,  # RankMesh with a pipe axis
    n_micro: Optional[int] = None,
    attn_impl: str = "kernel",  # "kernel" (serving) | "plain" (reference)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pipelined forward_decode: one decode step of the whole batch;
    returns (logits [B, V] float32, k_cache, v_cache). Each stage's
    decode attention is one paged_decode_attention_any call per layer
    and microbatch, over its own layer's pool and the microbatch's rows
    of the page table (contiguous, as the kernel's launch plan takes
    them)."""
    B = tokens.shape[0]
    M = n_microbatches(B, mesh.pipe.size, n_micro)
    mb = B // M
    tp = mesh.tensor
    dtype, device = _act(params)
    write_slots = flat_slot_indices(page_table, positions[:, None], page_size)[:, 0]

    def embed(m):
        return llama._embed(params, cfg, tokens[m * mb:(m + 1) * mb], tp)

    def run_stage(m, x):
        rows = slice(m * mb, (m + 1) * mb)
        ptm = page_table[rows].contiguous()
        seq_lens = (positions[rows] + 1).to(torch.int32)

        def attend(layer, q):
            return paged_decode_attention_any(attn_impl, q, k_cache[layer],
                                              v_cache[layer], ptm, seq_lens,
                                              page_size)

        h = llama._layers(params, cfg, x, positions[rows], k_cache, v_cache,
                          write_slots[rows], attend, tp=tp)
        return h, h

    hidden = _schedule(mesh, M, mb, (mb, cfg.hidden_size), dtype, device,
                       embed, run_stage)
    return llama._logits(params, cfg, hidden, tp), k_cache, v_cache
