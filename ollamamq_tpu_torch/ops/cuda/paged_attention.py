"""Wrappers of the paged decode-attention CUDA kernels
(csrc/paged_decode_attention.cu), the Hopper counterparts of the Pallas
kernel paged_decode_attention_pallas: the pool in q's dtype, and the
int8 pool (its quantized=True variant).

With q in bf16 the kernel splits each sequence's context over blocks of
SPLIT positions on tensor cores and a second launch combines the
splits' partials; decode_launch_plan computes its split, tile, threads,
shared memory, split count and scratch shape, and the C entry point
launches exactly that plan (it refuses one it was not built for). q in
float32 runs the per-sequence kernel and takes no plan."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ollamamq_tpu_torch.ops.attention import paged_decode_attention
from ollamamq_tpu_torch.ops.cuda import (DTYPE_CODES, build, check, check_quant_pool,
                                         raise_on_launch_error)

# Launches of each kernel in this process (plain integers; see ops/cuda).
launches = 0
launches_int8 = 0

# The split kernel's fixed shapes (split:: constants in the .cu).
SPLIT = 512  # context positions per block (tuned on the card, PERF.md)
WARPS = 4  # warps per block
WARP_POS = 16  # positions per warp and K/V tile
KV_TILE = WARPS * WARP_POS  # positions per block tile
STAGES = 2  # cp.async ring depth of each warp
MAX_GROUP = 8  # query heads per kv head, at most
PAD_BF16 = 8  # bf16 elements of padding per shared bf16 row
PAD_INT8 = 16  # bytes of padding per shared int8 row
HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernel is instantiated for


class DecodePlan(NamedTuple):
    split: int  # context positions per block
    kv_tile: int  # positions per block tile (16 per warp)
    threads: int  # one warp per 16 positions of a tile
    smem_bytes: int  # dynamic shared memory per block
    n_splits: int  # grid extent over the context: ceil(cap / split)
    scratch: Tuple[int, ...]  # f32 partials per sequence: (Hk, n_splits, group, hd + 2)

    def scratch_shape(self, B: int) -> Tuple[int, ...]:
        """The f32 scratch buffer of a call over B sequences: each
        split's unnormalised O [group, hd], then its max (log2 units)
        and its sum, per (sequence, kv head, split)."""
        return (B, *self.scratch)

    def splits_with_work(self, n: int) -> int:
        """Splits of a sequence whose clamped context is n (>= 0) that
        have positions to attend; the combine kernel reduces them when
        there are two or more."""
        return -(-n // self.split)


def decode_launch_plan(H: int, Hk: int, hd: int, page_size: int, max_pages: int,
                       int8: bool) -> DecodePlan:
    """The bf16-q decode kernel's plan for H query heads over Hk kv heads
    of width hd, a page table of max_pages pages of page_size slots, over
    an int8 pool or a bf16 one. Raises for a shape the kernel was not
    built for."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the bf16 decode kernel takes {HEAD_DIMS}")
    if H % Hk or not 1 <= H // Hk <= MAX_GROUP:
        raise ValueError(f"{H} heads over {Hk} kv heads: the bf16 decode kernel "
                         f"takes groups of 1 to {MAX_GROUP}")
    group = H // Hk
    if int8:  # int8 K, V rows and their f32 scales
        stage = 2 * WARP_POS * (hd + PAD_INT8) + 2 * WARP_POS * 4
    else:  # bf16 K, V rows
        stage = 2 * WARP_POS * (hd + PAD_BF16) * 2
    warp = max(STAGES * stage, (2 + hd) * MAX_GROUP * 4)  # ring, then merge record
    n_splits = -(-max_pages * page_size // SPLIT)
    return DecodePlan(SPLIT, KV_TILE, WARPS * 32, WARPS * warp, n_splits,
                      (Hk, n_splits, group, hd + 2))


def _plan_args(q, Hk, page_size, max_pages, int8):
    """(scratch, (split, kv_tile, threads, smem_bytes, n_splits)) for the C
    entry point; no scratch and zeros for float32 q, whose kernel takes
    no plan."""
    B, H, hd = q.shape
    if q.dtype != torch.bfloat16:
        return None, (0, 0, 0, 0, 0)
    p = decode_launch_plan(H, Hk, hd, page_size, max_pages, int8)
    scratch = torch.empty(p.scratch_shape(B), dtype=torch.float32, device=q.device)
    return scratch, (p.split, p.kv_tile, p.threads, p.smem_bytes, p.n_splits)


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
    max_pages = page_table.shape[1]
    scratch, plan = _plan_args(q, Hk, page_size, max_pages, int8=False)
    fn = build.kernel_fn("paged_decode_attention")
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, H, Hk, hd, page_size, max_pages, *plan, DTYPE_CODES[q.dtype],
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
    max_pages = page_table.shape[1]
    scratch, plan = _plan_args(q, Hk, page_size, max_pages, int8=True)
    fn = build.kernel_fn("paged_decode_attention_int8")
    rc = fn(q.data_ptr(), k_cache.q.data_ptr(), v_cache.q.data_ptr(),
            k_cache.s.data_ptr(), v_cache.s.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            B, H, Hk, hd, page_size, max_pages, *plan, DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_launch_error(rc, "paged_decode_attention_int8")
    launches_int8 += 1
    return out
