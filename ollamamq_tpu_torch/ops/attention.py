"""Paged attention: plain PyTorch versions and the kernel dispatchers.

KV cache layout (flat token-slot pool, page-aligned), as in the JAX
package:
    k_cache, v_cache: [num_layers, num_pages * page_size, kv_heads, head_dim]
A page is page_size contiguous slots; page 0 is the trash page that
padding rows point at. Slot of (page_table row, position p) is
row[p // page_size] * page_size + p % page_size. A pool may be a QuantKV
(int8 payload, f32 [S, Hk] scales): the plain versions dequantize at
the gather, in f32, and the dispatchers route it to the int8 kernels.

The chunk attentions of the bucketed and chunked prefill
(paged_chunk_attention, its blockwise twin) and the dense causal
attention are plain PyTorch by design, as their JAX counterparts are
plain jnp outside any Pallas kernel. The other plain versions here
define what the hand-written CUDA kernels (ops/cuda/) compute and are
what those kernels are held against. They
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


# Masked logits, as in the JAX package: a row with nothing visible then
# softmaxes to a uniform (finite) distribution, never NaN.
NEG_INF = -1e30


def _dense_attention(q, k, v, mask) -> torch.Tensor:
    """[B, T, H, hd] attention over dense K/V under a boolean mask
    broadcastable to [B, H, Tq, Tk]; f32 logits and softmax. GQA repeats
    each kv head over its H // Hk query heads."""
    hd = q.shape[-1]
    n_rep = q.shape[2] // k.shape[2]
    k = k.float().repeat_interleave(n_rep, dim=2)
    v = v.float().repeat_interleave(n_rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * (1.0 / math.sqrt(hd))
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def causal_attention(
    q: torch.Tensor,  # [B, T, H, hd]
    k: torch.Tensor,  # [B, T, Hk, hd]
    v: torch.Tensor,  # [B, T, Hk, hd]
    seq_lens: torch.Tensor,  # [B] valid lengths (padding masked out)
) -> torch.Tensor:
    """Causal self-attention over a padded batch with no KV pool, f32
    softmax (the embedding forward of a generative model and the
    quantization guardrail's probe)."""
    T = q.shape[1]
    pos = torch.arange(T, device=q.device)
    causal = pos[None, :] <= pos[:, None]  # [q, k]
    valid = pos[None, None, :] < seq_lens.to(q.device)[:, None, None]  # [B, 1, k]
    return _dense_attention(q, k, v, causal[None, None] & valid[:, None])


def flat_slot_indices(
    page_table: torch.Tensor,  # [B, max_pages] int32 page ids
    positions: torch.Tensor,  # [B, L] int32 token positions within each seq
    page_size: int,
) -> torch.Tensor:
    """Per-sequence token positions -> flat cache slot indices [B, L]. A
    position past the table's last page (bucket padding beyond the
    context cap) maps into the trash page 0."""
    pos = positions.long()
    idx = pos // page_size
    MP = page_table.shape[1]
    page = torch.gather(page_table.long(), 1, idx.clamp_max(MP - 1))
    page = torch.where(idx < MP, page, 0)
    return page * page_size + pos % page_size


def paged_chunk_attention(
    q: torch.Tensor,  # [B, C, H, hd] a chunk of new tokens per sequence
    k_cache,  # [S, Hk, hd] flat slot pool for ONE layer (tensor or QuantKV)
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages]
    start: torch.Tensor,  # [B] global position of the chunk's first token
    chunk_lens: torch.Tensor,  # [B] valid tokens in this chunk (<= C)
    page_size: int,
) -> torch.Tensor:
    """Chunked-prefill attention over the whole padded context: the
    chunk's K/V are already in the pool, so the query at global position
    start + i attends to cache positions <= start + i that lie before
    start + chunk_len. Decode attention is the case C == 1."""
    B, C, H, hd = q.shape
    L = page_table.shape[1] * page_size
    positions = torch.arange(L, dtype=torch.int32, device=q.device).expand(B, L)
    slots = flat_slot_indices(page_table, positions, page_size)  # [B, L]
    k = kv_gather(k_cache, slots)  # [B, L, Hk, hd] (int8 pools dequantize)
    v = kv_gather(v_cache, slots)
    q_pos = start.long()[:, None] + torch.arange(C, device=q.device)[None, :]
    causal = positions[:, None, :] <= q_pos[:, :, None]  # [B, C, L]
    in_seq = positions[:, None, :] < (start + chunk_lens).long()[:, None, None]
    return _dense_attention(q, k, v, (causal & in_seq)[:, None])


def paged_chunk_attention_blockwise(
    q: torch.Tensor,  # [B, C, H, hd] a chunk of new tokens per sequence
    k_cache,  # [S, Hk, hd] flat slot pool for ONE layer (tensor or QuantKV)
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages]
    start: torch.Tensor,  # [B] global position of the chunk's first token
    chunk_lens: torch.Tensor,  # [B] valid tokens in this chunk (<= C)
    page_size: int,
    block_pages: int = 8,
) -> torch.Tensor:
    """paged_chunk_attention without the padded context: the context is
    walked in blocks of `block_pages` pages with an f32 online softmax,
    and only as many blocks as the longest sequence needs (the trip count
    depends on the data), so the reads scale with the real context. The
    pages of a block are GATHERED at clipped page indices, never sliced: a
    slice clamped at the table's end would relabel the last partial
    block's positions, while a clipped gather keeps each position's label
    and the in_seq mask rejects the clipped rows (their positions are >=
    max_pages * page_size >= start + chunk_len)."""
    B, C, H, hd = q.shape
    max_pages = page_table.shape[1]
    Hk = k_cache.shape[1]
    n_rep = H // Hk
    BLK = block_pages * page_size
    n_blocks = -(-max_pages // block_pages)
    end = (start + chunk_lens).long()  # [B]
    needed = int((-(-end // BLK)).max()) if B else 0  # one host read
    dev = q.device
    qf = q.float() * (1.0 / math.sqrt(hd))
    q_pos = start.long()[:, None] + torch.arange(C, device=dev)[None, :]  # [B, C]
    m = torch.full((B, H, C), NEG_INF, dtype=torch.float32, device=dev)
    l_sum = torch.zeros((B, H, C), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, C, hd), dtype=torch.float32, device=dev)
    pt = page_table.long()
    in_page = torch.arange(page_size, device=dev)
    for i in range(min(needed, n_blocks)):
        pidx = (i * block_pages + torch.arange(block_pages, device=dev)).clamp(
            0, max_pages - 1)
        pages = pt[:, pidx]  # [B, block_pages]
        pos = i * BLK + torch.arange(BLK, device=dev)  # global positions
        slots = (pages[:, :, None] * page_size + in_page).reshape(B, BLK)
        k = kv_gather(k_cache, slots).float().repeat_interleave(n_rep, dim=2)
        v = kv_gather(v_cache, slots).float().repeat_interleave(n_rep, dim=2)
        logits = torch.einsum("bchd,blhd->bhcl", qf, k)  # [B, H, C, BLK]
        causal = pos[None, None, None, :] <= q_pos[:, None, :, None]
        in_seq = pos[None, None, None, :] < end[:, None, None, None]
        logits = torch.where(causal & in_seq, logits, NEG_INF)
        new_m = torch.maximum(m, logits.amax(dim=-1))
        # Keep the exp arguments finite for rows that have seen nothing.
        p = torch.exp(logits - new_m[..., None])
        p = torch.where(logits <= NEG_INF / 2, 0.0, p)
        corr = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - new_m))
        l_sum = l_sum * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhcl,blhd->bhcd", p, v)
        m = new_m
    out = acc / l_sum.clamp_min(1e-30)[..., None]  # [B, H, C, hd]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def bidirectional_attention(
    q: torch.Tensor,  # [B, T, H, hd]
    k: torch.Tensor,  # [B, T, Hk, hd]
    v: torch.Tensor,  # [B, T, Hk, hd]
    seq_lens: torch.Tensor,  # [B] valid lengths (padding masked out)
) -> torch.Tensor:
    """Full (non-causal) attention for encoder / embedding models: every
    position sees every valid key of its row. Builds [B, H, T, T] f32
    logits, as the JAX package's version does."""
    T = q.shape[1]
    pos = torch.arange(T, device=q.device)
    valid = pos[None, :] < seq_lens.to(q.device)[:, None]  # [B, k]
    return _dense_attention(q, k, v, valid[:, None, None, :])
