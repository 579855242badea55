"""Rotary position embeddings (HF-Llama rotate-half convention)."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim//2], float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, head_dim]; positions: [..., T] integer. Angles and
    the rotation run in float32; the result returns in x's dtype."""
    head_dim = x.shape[-1]
    inv_freq = rope_freqs(head_dim, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * inv_freq  # [..., T, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., T, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
