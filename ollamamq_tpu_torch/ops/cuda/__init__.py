"""Hand-written CUDA kernels for Hopper and their PyTorch wrappers.

A wrapper launches its kernel for CUDA tensors (or raises) and runs the
plain PyTorch version from ops/attention.py for CPU tensors only. Each
wrapper module keeps one plain integer per kernel variant (`launches`
for the pool in q's dtype, `launches_int8` for the int8 pool),
incremented once per launch of that kernel; launch_counts() and
reset_launch_counts() read and clear them all.
"""

from __future__ import annotations

import torch

from ollamamq_tpu_torch.ops.quant import QuantKV

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


def check_quant_pool(pool, name: str, device, shape) -> None:
    """Raise unless `pool` is a QuantKV with a contiguous int8 payload of
    `shape` [S, Hk, hd] and contiguous f32 scales [S, Hk] on `device`."""
    if not isinstance(pool, QuantKV):
        raise ValueError(f"{name}: expected a QuantKV pool, got {type(pool).__name__}")
    check(pool.q, f"{name}.q", device, torch.int8, shape)
    check(pool.s, f"{name}.s", device, torch.float32, shape[:2])


def raise_on_launch_error(rc: int, name: str) -> None:
    """A kernel entry point returns the cudaError_t of its launch."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _counters():
    """Kernel name -> (wrapper module, counter attribute)."""
    from ollamamq_tpu_torch.ops.cuda import paged_attention, ragged_attention

    return {"paged_decode_attention": (paged_attention, "launches"),
            "paged_decode_attention_int8": (paged_attention, "launches_int8"),
            "ragged_paged_attention": (ragged_attention, "launches"),
            "ragged_paged_attention_int8": (ragged_attention, "launches_int8")}


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in _counters().items()}


def reset_launch_counts() -> None:
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)
