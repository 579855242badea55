"""Wrappers of the ragged paged-attention CUDA kernels
(csrc/ragged_paged_attention.cu), the Hopper counterparts of the Pallas
kernel ragged_paged_attention_pallas: the pool in q's dtype, and the
int8 pool (its quantized=True variant).

With q in bf16 the kernel runs one block per (sequence, query tile, kv
head) on tensor cores; launch_plan computes its tile sizes, threads,
shared memory and grid, and the C entry point launches exactly that plan
(it refuses one it was not built for). q in float32 runs the per-row
kernel and takes no plan."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ollamamq_tpu_torch.ops.attention import ragged_paged_attention, ragged_tokens
from ollamamq_tpu_torch.ops.cuda import (DTYPE_CODES, build, check, check_quant_pool,
                                         raise_on_launch_error)

# Launches of each kernel in this process (plain integers; see ops/cuda).
launches = 0
launches_int8 = 0

# The tensor-core kernel's fixed shapes (tc:: constants in the .cu).
TARGET_ROWS = 64  # query-head rows a block aims for: QT * group
KV_TILE = 64  # context positions per K/V tile
ROW_PAD = 8  # bf16 elements of padding per shared K/V row
MAX_ROWS = 128  # matrix rows per block at most (8 warps)
HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernel is instantiated for


class LaunchPlan(NamedTuple):
    q_tile: int  # QT: consecutive tokens of one span per block
    kv_tile: int  # context positions per K/V tile
    rows: int  # matrix rows per block: QT * group padded to 16
    threads: int  # one warp per 16 rows
    smem_bytes: int  # dynamic shared memory per block

    def blocks(self, T: int, B: int) -> int:
        """Grid extent over the stream: ceil(T / QT) + B bounds the work
        items sum(ceil(q_len / QT)) from shapes alone; the blocks past the
        last item zero the rows no span covers."""
        return -(-T // self.q_tile) + B


def launch_plan(H: int, Hk: int, hd: int, int8: bool) -> LaunchPlan:
    """The bf16-q kernel's plan for H query heads over Hk kv heads of
    width hd, over an int8 pool or a bf16 one. Raises for a shape the
    kernel was not built for."""
    group = H // Hk
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd}: the bf16 ragged kernel takes {HEAD_DIMS}")
    q_tile = max(1, TARGET_ROWS // group)
    rows = -(-q_tile * group // 16) * 16
    if rows > MAX_ROWS:
        raise ValueError(f"group {group}: {rows} rows per block exceed {MAX_ROWS}")
    tile = KV_TILE * (hd + ROW_PAD) * 2  # one bf16 K or V tile
    if int8:  # int8 K, V ring, its f32 scales, the dequantized bf16 tiles
        smem = 2 * 2 * KV_TILE * hd + 2 * 2 * KV_TILE * 4 + 2 * tile
    else:  # bf16 K, V ring of two stages
        smem = 2 * 2 * tile
    return LaunchPlan(q_tile, KV_TILE, rows, rows // 16 * 32, smem)


def _plan_args(q, Hk, B, int8):
    """(q_tile, kv_tile, threads, smem_bytes, blocks) for the C entry
    point; zeros for float32 q, whose kernel takes no plan."""
    T, H, hd = q.shape
    if q.dtype != torch.bfloat16:
        return (0, 0, 0, 0, 0)
    p = launch_plan(H, Hk, hd, int8)
    return (p.q_tile, p.kv_tile, p.threads, p.smem_bytes, p.blocks(T, B))


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
    plan = _plan_args(q, Hk, B, int8=False)
    fn = build.kernel_fn("ragged_paged_attention")
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            page_table.data_ptr(), q_start.data_ptr(), q_lens.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), T, B, H, Hk, hd, page_size,
            page_table.shape[1], *plan, DTYPE_CODES[q.dtype],
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
    plan = _plan_args(q, Hk, B, int8=True)
    fn = build.kernel_fn("ragged_paged_attention_int8")
    rc = fn(q.data_ptr(), k_cache.q.data_ptr(), v_cache.q.data_ptr(),
            k_cache.s.data_ptr(), v_cache.s.data_ptr(),
            page_table.data_ptr(), q_start.data_ptr(), q_lens.data_ptr(),
            kv_lens.data_ptr(), out.data_ptr(), T, B, H, Hk, hd, page_size,
            page_table.shape[1], *plan, DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    raise_on_launch_error(rc, "ragged_paged_attention_int8")
    launches_int8 += 1
    return out
