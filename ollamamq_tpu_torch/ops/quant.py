"""Matmul, embedding, logits and KV-write entry points, and the int8
weight and KV formats they accept.

Two quantized containers, as in the JAX package:

  QuantTensor: a weight as (q int8, s f32 per-channel scales). Layer
    matmul weights [d, e] quantize along their LAST axis (one scale per
    output feature, s [e]); embed / lm_head [V, D] along axis 0 (one
    scale per vocab row, s [V]: the logits' output channel and the
    embedding's gathered row, so a tied embedding needs one vector).

  QuantKV: a KV slot pool as (q int8 [..., S, Hk, hd], s f32 [..., S,
    Hk]), one scale per (slot, kv head), page-aligned with the payload.
    Indexing a QuantKV indexes both (pool[layer] is that layer's pool),
    so a layer loop reads `k_cache[layer]` whatever the pool's format.

Every call site of the model goes through qeinsum / embed_lookup /
logits_head / kv_write, so the forwards take either format unchanged.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Scale floor: an all-zero channel or row must not divide by 0.
_EPS = 1e-8


class QuantTensor(NamedTuple):
    """Per-channel symmetric int8 weight: w ~= q * s (s broadcast along
    the quantized axis)."""

    q: torch.Tensor  # int8, the weight's shape
    s: torch.Tensor  # f32 scales


class QuantKV:
    """One quantized KV pool: int8 payload q [..., S, Hk, hd] and f32
    scales s [..., S, Hk]. `pool[i]` indexes payload and scales together
    (a layer of an [L, S, Hk, hd] pool, or slots of one layer), returning
    views where torch indexing does, so writes through them land in the
    pool. Not a tuple: `pool[0]` is never the payload field."""

    __slots__ = ("q", "s")

    def __init__(self, q: torch.Tensor, s: torch.Tensor):
        if q.dtype != torch.int8 or s.dtype != torch.float32:
            raise ValueError(f"QuantKV wants int8 payload and f32 scales, got "
                             f"{q.dtype} and {s.dtype}")
        if tuple(q.shape[:-1]) != tuple(s.shape):
            raise ValueError(f"QuantKV scales {tuple(s.shape)} do not match "
                             f"payload {tuple(q.shape)}")
        self.q = q
        self.s = s

    def __getitem__(self, idx) -> "QuantKV":
        return QuantKV(self.q[idx], self.s[idx])

    @property
    def shape(self):
        return self.q.shape


def nbytes(x) -> int:
    """Device bytes of a tensor or a quantized container (payload plus
    scales)."""
    if isinstance(x, (QuantTensor, QuantKV)):
        return nbytes(x.q) + nbytes(x.s)
    return x.numel() * x.element_size()


# -- weights ------------------------------------------------------------------
def quantize_tensor(w: torch.Tensor, axis: int = -1) -> QuantTensor:
    """Per-channel symmetric int8 quantization of `w`. axis=-1 on
    [..., d, e] reduces d: scales [..., e] (one per output feature and
    leading layer). axis=0 on [V, ...] reduces the rest: scales [V]."""
    wf = w.to(torch.float32)
    nd = wf.dim()
    axis = axis % nd
    if axis == nd - 1:
        s = wf.abs().amax(dim=-2).clamp_min(_EPS) / 127.0
        q = torch.clamp(torch.round(wf / s.unsqueeze(-2)), -127, 127)
        return QuantTensor(q.to(torch.int8), s)
    if axis == 0:
        s = wf.abs().amax(dim=tuple(range(1, nd))).clamp_min(_EPS) / 127.0
        q = torch.clamp(torch.round(wf / s.reshape((-1,) + (1,) * (nd - 1))),
                        -127, 127)
        return QuantTensor(q.to(torch.int8), s)
    raise ValueError(f"unsupported quantization axis {axis} for ndim {nd}")


def dequantize_tensor(t: QuantTensor, axis: int = -1,
                      dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_tensor (tests, round-trip bounds)."""
    qf = t.q.to(torch.float32)
    nd = qf.dim()
    if axis % nd == nd - 1:
        return (qf * t.s.unsqueeze(-2)).to(dtype)
    return (qf * t.s.reshape((-1,) + (1,) * (nd - 1))).to(dtype)


def qeinsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """Einsum of activations against a weight in the activation dtype. An
    int8 weight is cast to x's dtype for the contraction; its f32
    per-channel scales multiply the output's last axis in f32 (JAX's
    promotion), then the result is cast back to x's dtype."""
    if isinstance(w, QuantTensor):
        y = torch.einsum(spec, x, w.q.to(x.dtype))
        return (y * w.s).to(x.dtype)
    return torch.einsum(spec, x, w)


def embed_lookup(embed, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Embedding-row gather in the activation dtype; int8 rows are scaled
    by their row scale."""
    idx = tokens.long()
    if isinstance(embed, QuantTensor):
        rows = embed.q[idx].to(dtype)
        return (rows * embed.s[idx].unsqueeze(-1)).to(dtype)
    return embed[idx].to(dtype)


def logits_head(x: torch.Tensor, head) -> torch.Tensor:
    """lm_head / tied-embedding logits ("...d,vd->...v") in float32; an
    int8 head multiplies the logit columns by its row scales."""
    if isinstance(head, QuantTensor):
        y = torch.matmul(x.to(torch.float32), head.q.to(torch.float32).t())
        return y * head.s
    return torch.matmul(x.to(torch.float32), head.to(torch.float32).t())


# -- KV cache -----------------------------------------------------------------
def kv_quantize(vals: torch.Tensor):
    """K/V rows [..., Hk, hd] -> (int8 rows, f32 scales [..., Hk]):
    symmetric amax over head_dim per token and head, round half to even."""
    vf = vals.to(torch.float32)
    s = vf.abs().amax(dim=-1).clamp_min(_EPS) / 127.0
    q = torch.clamp(torch.round(vf / s.unsqueeze(-1)), -127, 127)
    return q.to(torch.int8), s


def kv_write(cache, slots: torch.Tensor, vals: torch.Tensor):
    """Scatter K/V rows [N, Hk, hd] into one layer's slot pool IN PLACE and
    return the pool; a QuantKV pool takes the quantized payload AND its
    scales. (The JAX package returns a new pool from a donated buffer.)
    Padding rows may share the trash slot; which of them lands there is
    unspecified and never read."""
    idx = slots.long()
    if isinstance(cache, QuantKV):
        q, s = kv_quantize(vals)
        cache.q[idx] = q
        cache.s[idx] = s
        return cache
    cache[idx] = vals.to(cache.dtype)
    return cache


def kv_gather(cache, slots: torch.Tensor) -> torch.Tensor:
    """Rows of the slot pool at `slots`; a QuantKV pool dequantizes to f32
    (q * s in f32, the value the int8 kernels compute after each load)."""
    idx = slots.long()
    if isinstance(cache, QuantKV):
        return cache.q[idx].to(torch.float32) * cache.s[idx].unsqueeze(-1)
    return cache[idx]
