"""Paged attention: plain PyTorch versions and the kernel dispatchers.

KV cache layout (flat token-slot pool, page-aligned), as in the JAX
package:
    k_cache, v_cache: [num_layers, num_pages * page_size, kv_heads, head_dim]
A page is page_size contiguous slots; page 0 is the trash page that
padding rows point at. Slot of (page_table row, position p) is
row[p // page_size] * page_size + p % page_size. A pool may be a QuantKV
(int8 payload, f32 [S, Hk] scales): the plain versions dequantize at
the gather, in f32, and the dispatchers route it to the int8 kernels.

The plain versions here define what the hand-written CUDA kernels
(ops/cuda/) compute and are what those kernels are held against. They
run on the CPU (tests) and in the card-side comparisons; the serving path
on a card always goes through the kernels.
"""

from __future__ import annotations

import math

import torch

from ollamamq_tpu_torch.ops.quant import QuantKV, kv_gather


def _attend_rows(q, k_cache, v_cache, rows, n_visible, page_size):
    """Each query row n attends positions 0..n_visible[n]-1 of its own
    paged context (page-table row rows[n]); GQA over H // Hk query heads
    per kv head, scale 1/sqrt(hd), float32 softmax. Rows with nothing
    visible produce exact zeros. Masked positions are selected away with
    `where`, so stale pool data (even NaN) never reaches the sums.

    q [N, H, hd]; rows [N, max_pages]; n_visible [N] -> [N, H, hd]."""
    N, H, hd = q.shape
    Hk = k_cache.shape[1]
    G = H // Hk
    L = rows.shape[1] * page_size
    pos = torch.arange(L, device=q.device)
    slots = (rows.long()[:, pos // page_size] * page_size
             + pos % page_size)  # [N, L]
    mask = pos[None, :] < n_visible.long()[:, None]  # [N, L]
    k = torch.where(mask[..., None, None], kv_gather(k_cache, slots).float(), 0.0)
    v = torch.where(mask[..., None, None], kv_gather(v_cache, slots).float(), 0.0)
    qf = q.float().reshape(N, Hk, G, hd) * (1.0 / math.sqrt(hd))
    s = torch.einsum("nkgd,nlkd->nkgl", qf, k)  # [N, Hk, G, L]
    keep = mask[:, None, None, :]
    s = torch.where(keep, s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    out = torch.einsum("nkgl,nlkd->nkgd", p, v) / denom
    return out.reshape(N, H, hd).to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,  # [B, H, hd] one new token per sequence
    k_cache,  # [S, Hk, hd] flat slot pool for ONE layer (tensor or QuantKV)
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages]
    seq_lens: torch.Tensor,  # [B] context length INCLUDING the new token
    page_size: int,
) -> torch.Tensor:
    """Decode attention: each query attends to positions 0..seq_len-1 of
    its own paged context, truncated at max_pages * page_size."""
    return _attend_rows(q, k_cache, v_cache, page_table,
                        seq_lens.clamp_min(0), page_size)


def ragged_paged_attention(
    q: torch.Tensor,  # [T, H, hd] flattened mixed-batch query stream
    k_cache,  # [S, Hk, hd] flat slot pool for ONE layer (tensor or QuantKV)
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages] one row per sequence
    tok_seq: torch.Tensor,  # [T] sequence index of each token
    tok_pos: torch.Tensor,  # [T] kv position of each token (-1 = pad)
    kv_lens: torch.Tensor,  # [B] context length incl. each seq's new tokens
    page_size: int,
) -> torch.Tensor:
    """Ragged mixed-batch attention: token t attends causally over its
    own sequence's paged context, positions <= tok_pos[t] and
    < kv_lens[tok_seq[t]]. Padding tokens (tok_pos < 0) produce zeros,
    as the kernel writes for stream rows that no span covers."""
    B = page_table.shape[0]
    seq = tok_seq.long().clamp(0, B - 1)
    n_visible = torch.where(
        tok_pos >= 0, torch.minimum(tok_pos + 1, kv_lens[seq]),
        torch.zeros_like(tok_pos))
    return _attend_rows(q, k_cache, v_cache, page_table[seq],
                        n_visible, page_size)


def ragged_tokens(q_start: torch.Tensor, q_lens: torch.Tensor,
                  kv_lens: torch.Tensor, T: int):
    """Per-token (tok_seq, tok_pos) [T] from the per-sequence span
    encoding: sequence s owns stream rows [q_start[s], q_start[s] +
    q_lens[s]) at kv positions kv_lens[s] - q_lens[s] + i. Rows no span
    covers get tok_pos -1 (and tok_seq 0)."""
    t = torch.arange(T, device=q_start.device)
    ends = (q_start + q_lens).long()
    s = torch.searchsorted(ends, t, right=True).clamp_max(len(q_start) - 1)
    covered = (q_lens[s] > 0) & (q_start[s] <= t) & (t < ends[s])
    pos = kv_lens[s] - q_lens[s] + (t - q_start[s])
    tok_seq = torch.where(covered, s, torch.zeros_like(s)).to(torch.int32)
    tok_pos = torch.where(covered, pos, torch.full_like(pos, -1))
    return tok_seq, tok_pos.to(torch.int32)


def ragged_attention_any(
    attn_impl: str,  # "kernel" (serving) | "plain" (reference check)
    q, k_cache, v_cache, page_table,
    tok_seq, tok_pos, kv_lens,  # per-token metadata (plain version)
    q_start, q_lens,  # per-sequence span metadata (kernel)
    page_size: int,
) -> torch.Tensor:
    """The ONE ragged-attention dispatch of forward_ragged. "kernel"
    launches the CUDA kernel for CUDA tensors (its wrapper raises rather
    than fall back) and runs the plain version only for CPU tensors; a
    QuantKV pool goes to the int8-pool kernel. "plain" is the explicit
    reference path a comparison asks for."""
    if attn_impl == "plain":
        return ragged_paged_attention(q, k_cache, v_cache, page_table,
                                      tok_seq, tok_pos, kv_lens, page_size)
    from ollamamq_tpu_torch.ops.cuda import ragged_attention as ra

    fn = (ra.ragged_paged_attention_int8_cuda if isinstance(k_cache, QuantKV)
          else ra.ragged_paged_attention_cuda)
    return fn(q, k_cache, v_cache, page_table, q_start, q_lens, kv_lens,
              page_size)


def paged_decode_attention_any(
    attn_impl: str,  # "kernel" (serving) | "plain" (reference check)
    q, k_cache, v_cache, page_table, seq_lens, page_size: int,
) -> torch.Tensor:
    """The ONE decode-attention dispatch of forward_decode (see
    ragged_attention_any)."""
    if attn_impl == "plain":
        return paged_decode_attention(q, k_cache, v_cache, page_table,
                                      seq_lens, page_size)
    from ollamamq_tpu_torch.ops.cuda import paged_attention as pa

    fn = (pa.paged_decode_attention_int8_cuda if isinstance(k_cache, QuantKV)
          else pa.paged_decode_attention_cuda)
    return fn(q, k_cache, v_cache, page_table, seq_lens, page_size)


def causal_attention(
    q: torch.Tensor,  # [B, T, H, hd]
    k: torch.Tensor,  # [B, T, Hk, hd]
    v: torch.Tensor,  # [B, T, Hk, hd]
    seq_lens: torch.Tensor,  # [B] valid lengths (padding masked out)
) -> torch.Tensor:
    """Causal self-attention over a padded batch with no KV pool, f32
    softmax (the quantization guardrail's probe). GQA repeats each kv
    head over its H // Hk query heads."""
    B, T, H, hd = q.shape
    n_rep = H // k.shape[2]
    k = k.float().repeat_interleave(n_rep, dim=2)
    v = v.float().repeat_interleave(n_rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * (1.0 / math.sqrt(hd))
    pos = torch.arange(T, device=q.device)
    causal = pos[None, :] <= pos[:, None]  # [q, k]
    valid = pos[None, None, :] < seq_lens.to(q.device)[:, None, None]  # [B, 1, k]
    mask = causal[None, None] & valid[:, None]
    logits = torch.where(mask, logits, -1e30)  # the JAX package's NEG_INF
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)
