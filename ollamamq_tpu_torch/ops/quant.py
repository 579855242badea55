"""Matmul, embedding, logits and KV-write entry points.

Every call site of the model goes through these, so the int8 weight and
KV formats can slot in later without touching the forwards. This package
serves bf16/f32 weights and pools only.
"""

from __future__ import annotations

import torch


def qeinsum(spec: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Einsum of activations against a weight in the activation dtype."""
    return torch.einsum(spec, x, w)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Embedding-row gather in the activation dtype."""
    return embed[tokens.long()].to(dtype)


def logits_head(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """lm_head / tied-embedding logits ("...d,vd->...v") in float32."""
    return torch.matmul(x.to(torch.float32), head.to(torch.float32).t())


def kv_write(cache: torch.Tensor, slots: torch.Tensor,
             vals: torch.Tensor) -> torch.Tensor:
    """Scatter K/V rows [N, Hk, hd] into one layer's slot pool [S, Hk, hd]
    IN PLACE and return the pool. (The JAX package returns a new pool
    from a donated buffer; here the pool is updated where it lies.)
    Padding rows may share the trash slot; which of them lands there is
    unspecified and never read."""
    cache[slots.long()] = vals.to(cache.dtype)
    return cache
