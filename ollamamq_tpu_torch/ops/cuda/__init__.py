"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

A wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain PyTorch version from ops/attention.py for CPU tensors only. Each
wrapper module keeps a plain integer `launches`, incremented once per
launch of its kernel; launch_counts()/reset_launch_counts() read and
clear them all.
"""

from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check(t: torch.Tensor, name: str, device, dtype=None, shape=None) -> None:
    """Raise unless `t` is contiguous on `device` with the given dtype and
    shape (None entries in `shape` match any extent)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and (t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape))):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _modules():
    from ollamamq_tpu_torch.ops.cuda import paged_attention, ragged_attention

    return {"paged_decode_attention": paged_attention,
            "ragged_paged_attention": ragged_attention}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in _modules().items()}


def reset_launch_counts() -> None:
    for mod in _modules().values():
        mod.launches = 0
