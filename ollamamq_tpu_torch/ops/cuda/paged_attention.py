"""Wrappers of the paged decode-attention CUDA kernels
(csrc/paged_decode_attention.cu), the Hopper counterparts of the Pallas
kernel paged_decode_attention_pallas: the pool in q's dtype, and the
int8 pool (its quantized=True variant)."""

from __future__ import annotations

import torch

from ollamamq_tpu_torch.ops.attention import paged_decode_attention
from ollamamq_tpu_torch.ops.cuda import (DTYPE_CODES, build, check, check_quant_pool,
                                         raise_on_launch_error)

# Launches of each kernel in this process (plain integers; see ops/cuda).
launches = 0
launches_int8 = 0


def _check_common(q, page_table, seq_lens, Hk):
    B, H, _ = q.shape
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q: unsupported dtype {q.dtype}")
    if H % Hk:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {Hk}")
    check(q, "q", q.device)
    check(page_table, "page_table", q.device, torch.int32, (B, None))
    check(seq_lens, "seq_lens", q.device, torch.int32, (B,))


def paged_decode_attention_cuda(
    q: torch.Tensor,  # [B, H, hd]
    k_cache: torch.Tensor,  # [S, Hk, hd] one layer's slot pool, q's dtype
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] int32
    seq_lens: torch.Tensor,  # [B] int32, counting the current token
    page_size: int,
) -> torch.Tensor:
    """Decode attention through the CUDA kernel; the plain version for
    CPU tensors. On the card there is no fallback: a bad input or a
    refused launch raises."""
    global launches
    if q.device.type == "cpu":
        return paged_decode_attention(q, k_cache, v_cache, page_table,
                                      seq_lens, page_size)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_cuda: unsupported device {q.device}")
    B, H, hd = q.shape
    S, Hk, _ = k_cache.shape
    _check_common(q, page_table, seq_lens, Hk)
    check(k_cache, "k_cache", q.device, q.dtype, (S, Hk, hd))
    check(v_cache, "v_cache", q.device, q.dtype, (S, Hk, hd))
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = build.kernel_fn("paged_decode_attention")
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, H, Hk, hd, page_size, page_table.shape[1], DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_launch_error(rc, "paged_decode_attention")
    launches += 1
    return out


def paged_decode_attention_int8_cuda(
    q: torch.Tensor,  # [B, H, hd] f32 or bf16
    k_cache,  # QuantKV: int8 [S, Hk, hd] payload, f32 [S, Hk] scales
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages] int32
    seq_lens: torch.Tensor,  # [B] int32, counting the current token
    page_size: int,
) -> torch.Tensor:
    """Decode attention over an int8 pool through the CUDA kernel (output
    in q's dtype); the plain version for CPU tensors. On the card there
    is no fallback: a bad input or a refused launch raises."""
    global launches_int8
    if q.device.type == "cpu":
        return paged_decode_attention(q, k_cache, v_cache, page_table,
                                      seq_lens, page_size)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_int8_cuda: unsupported device {q.device}")
    B, H, hd = q.shape
    S, Hk, _ = k_cache.shape
    _check_common(q, page_table, seq_lens, Hk)
    check_quant_pool(k_cache, "k_cache", q.device, (S, Hk, hd))
    check_quant_pool(v_cache, "v_cache", q.device, (S, Hk, hd))
    out = torch.empty_like(q)
    if B == 0:
        return out
    fn = build.kernel_fn("paged_decode_attention_int8")
    rc = fn(q.data_ptr(), k_cache.q.data_ptr(), v_cache.q.data_ptr(),
            k_cache.s.data_ptr(), v_cache.s.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, H, Hk, hd, page_size, page_table.shape[1], DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_launch_error(rc, "paged_decode_attention_int8")
    launches_int8 += 1
    return out
