"""Ring attention: causal attention with the sequence cut over the "seq"
mesh axis, the one-shot prefill of a long prompt.

The JAX package computes it under shard_map: each device holds a
contiguous chunk of the sequence, computes blockwise attention for its
own queries while the K/V chunks rotate around the ring (`ppermute`
d -> d+1), and an f32 online softmax keeps the result exact against
full attention. Here each shard is a rank and the rotation is the seq
group's point-to-point hand-off (parallel/mesh.py SeqGroup).

Causality over the ring: at rotation s the shard holding query chunk i
holds the K/V chunk first at shard (i - s) mod sp:
  - an earlier chunk: full attention
  - its own chunk: causal within the block
  - a later chunk: nothing (every logit masked)

A later chunk's block is skipped: for a query row that holds a valid
key (every row below seq_lens), a fully masked block leaves the running
max, the sum and the accumulator bit for bit as they were, so skipping
it changes only padding rows, which nobody reads. The last rotation is
skipped too: the chunk it would bring back is the shard's own. The
local block runs in query tiles of at most QUERY_TILE rows, which bound
the [B, H, tile, C] f32 logits; each row's arithmetic is the
reference's.

This is plain PyTorch, as the reference is plain jnp outside any Pallas
kernel.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ollamamq_tpu_torch.ops.attention import NEG_INF

QUERY_TILE = 1024


def _block(q, k, v, q_pos, k_pos, seq_lens, acc, m_i, l_i, scale) -> None:
    """One (query tile, K/V chunk) block of the online softmax, updating
    acc [B, H, Q, hd], m_i and l_i [B, H, Q, 1] in place. q [B, Q, H, hd]
    in f32, k and v [B, C, H, hd] in f32 (heads repeated)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    mask = k_pos[None, :] <= q_pos[:, None]  # causal across chunks
    mask = mask[None, None] & (k_pos[None, None, None, :]
                               < seq_lens[:, None, None, None])
    logits = torch.where(mask, logits, NEG_INF)
    m_new = torch.maximum(m_i, logits.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m_i - m_new)
    p = torch.exp(logits - m_new)
    l_i.mul_(alpha).add_(p.sum(dim=-1, keepdim=True))
    acc.mul_(alpha).add_(torch.einsum("bhqk,bkhd->bhqd", p, v))
    m_i.copy_(m_new)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   seq_lens: torch.Tensor, seq,
                   on_chunk: Optional[Callable] = None) -> torch.Tensor:
    """This shard's causal attention over the whole sequence.

    q [B, C, H, hd] and k, v [B, C, Hk, hd] are the local chunk (C = T /
    sp; this shard holds global positions seq.index * C ...), seq_lens
    [B] the global valid lengths, `seq` the ring (parallel/mesh.py
    SeqGroup). `on_chunk(j, k_j, v_j)` sees every K/V chunk the shard
    holds, its own first, with j the chunk's index along the sequence:
    the prefill writes each into the shard's pages. Returns [B, C, H,
    hd] in q's dtype."""
    sp, idx = seq.size, seq.index
    B, C, Hk, hd = k.shape
    H = q.shape[2]
    n_rep = H // Hk
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    seq_lens = seq_lens.to(dev)
    qf = q.float()
    q_pos = idx * C + torch.arange(C, device=dev)
    acc = torch.zeros(B, H, C, hd, dtype=torch.float32, device=dev)
    m_i = torch.full((B, H, C, 1), NEG_INF, dtype=torch.float32, device=dev)
    l_i = torch.zeros(B, H, C, 1, dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])  # one hand-off carries both
    for s in range(sp):
        j = (idx - s) % sp  # the chunk kv holds
        if on_chunk is not None:
            on_chunk(j, kv[0], kv[1])
        if j <= idx:
            kk = kv[0].float().repeat_interleave(n_rep, dim=2)
            vv = kv[1].float().repeat_interleave(n_rep, dim=2)
            k_pos = j * C + torch.arange(C, device=dev)
            for lo in range(0, C, QUERY_TILE):
                hi = min(C, lo + QUERY_TILE)
                _block(qf[:, lo:hi], kk, vv, q_pos[lo:hi], k_pos, seq_lens,
                       acc[:, :, lo:hi], m_i[:, :, lo:hi], l_i[:, :, lo:hi],
                       scale)
        if s < sp - 1:
            kv = seq.rotate(kv)
    out = acc / l_i.clamp_min(1e-20)  # [B, H, C, hd]
    return out.permute(0, 2, 1, 3).to(q.dtype)
