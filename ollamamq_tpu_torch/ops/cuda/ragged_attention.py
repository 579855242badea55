"""Wrappers of the ragged paged-attention CUDA kernels
(csrc/ragged_paged_attention.cu), the Hopper counterparts of the Pallas
kernel ragged_paged_attention_pallas: the pool in q's dtype, and the
int8 pool (its quantized=True variant)."""

from __future__ import annotations

import torch

from ollamamq_tpu_torch.ops.attention import ragged_paged_attention, ragged_tokens
from ollamamq_tpu_torch.ops.cuda import (DTYPE_CODES, build, check, check_quant_pool,
                                         raise_on_launch_error)

# Launches of each kernel in this process (plain integers; see ops/cuda).
launches = 0
launches_int8 = 0


def _plain(q, k_cache, v_cache, page_table, q_start, q_lens, kv_lens, page_size):
    tok_seq, tok_pos = ragged_tokens(q_start, q_lens, kv_lens, q.shape[0])
    return ragged_paged_attention(q, k_cache, v_cache, page_table,
                                  tok_seq, tok_pos, kv_lens, page_size)


def _check_common(q, page_table, q_start, q_lens, kv_lens, Hk):
    H = q.shape[1]
    B = page_table.shape[0]
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"q: unsupported dtype {q.dtype}")
    if H % Hk:
        raise ValueError(f"num_heads {H} is not a multiple of kv heads {Hk}")
    check(q, "q", q.device)
    check(page_table, "page_table", q.device, torch.int32, (B, None))
    for name, t in (("q_start", q_start), ("q_lens", q_lens),
                    ("kv_lens", kv_lens)):
        check(t, name, q.device, torch.int32, (B,))


def ragged_paged_attention_cuda(
    q: torch.Tensor,  # [T, H, hd] flattened mixed-batch queries
    k_cache: torch.Tensor,  # [S, Hk, hd] one layer's slot pool, q's dtype
    v_cache: torch.Tensor,
    page_table: torch.Tensor,  # [B, max_pages] int32
    q_start: torch.Tensor,  # [B] int32 span offset (T for padding)
    q_lens: torch.Tensor,  # [B] int32 span length (0 for padding)
    kv_lens: torch.Tensor,  # [B] int32 context length incl. the span
    page_size: int,
) -> torch.Tensor:
    """Ragged attention through the CUDA kernel; the plain version for
    CPU tensors. Stream rows no span covers come back as exact zeros.
    On the card there is no fallback: a bad input or a refused launch
    raises."""
    global launches
    if q.device.type == "cpu":
        return _plain(q, k_cache, v_cache, page_table, q_start, q_lens,
                      kv_lens, page_size)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention_cuda: unsupported device {q.device}")
    T, H, hd = q.shape
    S, Hk, _ = k_cache.shape
    B = page_table.shape[0]
    _check_common(q, page_table, q_start, q_lens, kv_lens, Hk)
    check(k_cache, "k_cache", q.device, q.dtype, (S, Hk, hd))
    check(v_cache, "v_cache", q.device, q.dtype, (S, Hk, hd))
    out = torch.empty_like(q)
    if T == 0:
        return out
    if B == 0:
        return out.zero_()
    fn = build.kernel_fn("ragged_paged_attention")
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            page_table.data_ptr(), q_start.data_ptr(), q_lens.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), T, B, H, Hk, hd, page_size,
            page_table.shape[1], DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_launch_error(rc, "ragged_paged_attention")
    launches += 1
    return out


def ragged_paged_attention_int8_cuda(
    q: torch.Tensor,  # [T, H, hd] f32 or bf16
    k_cache,  # QuantKV: int8 [S, Hk, hd] payload, f32 [S, Hk] scales
    v_cache,
    page_table: torch.Tensor,  # [B, max_pages] int32
    q_start: torch.Tensor,  # [B] int32 span offset (T for padding)
    q_lens: torch.Tensor,  # [B] int32 span length (0 for padding)
    kv_lens: torch.Tensor,  # [B] int32 context length incl. the span
    page_size: int,
) -> torch.Tensor:
    """Ragged attention over an int8 pool through the CUDA kernel (output
    in q's dtype); the plain version for CPU tensors. Stream rows no span
    covers come back as exact zeros. On the card there is no fallback: a
    bad input or a refused launch raises."""
    global launches_int8
    if q.device.type == "cpu":
        return _plain(q, k_cache, v_cache, page_table, q_start, q_lens,
                      kv_lens, page_size)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention_int8_cuda: unsupported device {q.device}")
    T, H, hd = q.shape
    S, Hk, _ = k_cache.shape
    B = page_table.shape[0]
    _check_common(q, page_table, q_start, q_lens, kv_lens, Hk)
    check_quant_pool(k_cache, "k_cache", q.device, (S, Hk, hd))
    check_quant_pool(v_cache, "v_cache", q.device, (S, Hk, hd))
    out = torch.empty_like(q)
    if T == 0:
        return out
    if B == 0:
        return out.zero_()
    fn = build.kernel_fn("ragged_paged_attention_int8")
    rc = fn(q.data_ptr(), k_cache.q.data_ptr(), v_cache.q.data_ptr(),
            k_cache.s.data_ptr(), v_cache.s.data_ptr(),
            page_table.data_ptr(), q_start.data_ptr(), q_lens.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), T, B, H, Hk, hd, page_size,
            page_table.shape[1], DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_launch_error(rc, "ragged_paged_attention_int8")
    launches_int8 += 1
    return out
