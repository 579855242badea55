"""The launch plan of the bf16-q ragged attention kernel
(csrc/ragged_paged_attention.cu, planned by ops/cuda/ragged_attention.py)
on the CPU: the numbers the wrapper hands the C entry point for every
model the port serves, and the grid bound that lets the kernel launch
without reading the span lengths on the host.

The block assignment below mirrors the kernel's: block w takes the w-th
(sequence, query tile) in sequence order, and the blocks past the last
work item zero the stream rows that no span covers.
"""

import numpy as np
import pytest
import torch

from ollamamq_tpu_torch.config import MODEL_CONFIGS
from ollamamq_tpu_torch.ops.attention import ragged_tokens
from ollamamq_tpu_torch.ops.cuda import build
from ollamamq_tpu_torch.ops.cuda import ragged_attention as ra

SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-pool", "int8-pool"])
@pytest.mark.parametrize("model", sorted(MODEL_CONFIGS))
def test_plan_fits_every_model(model, int8):
    cfg = MODEL_CONFIGS[model]
    group = cfg.num_heads // cfg.num_kv_heads
    p = ra.launch_plan(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, int8)
    assert p.smem_bytes <= SMEM_LIMIT
    assert p.rows % 16 == 0 and p.rows <= ra.MAX_ROWS
    assert p.q_tile * group <= p.rows < p.q_tile * group + 16
    assert p.threads == p.rows // 16 * 32
    assert p.kv_tile == ra.KV_TILE and p.kv_tile % 16 == 0


@pytest.mark.parametrize("H,Hk,q_tile,rows", [
    (32, 8, 16, 64),  # llama3.2:1b, llama3:8b, qwen3:8b: group 4
    (24, 8, 21, 64),  # llama3.2:3b: group 3, 63 rows padded to 64
    (28, 4, 9, 64),  # qwen2.5:7b: group 7, 63 rows padded to 64
    (8, 8, 64, 64),  # group 1
    (4, 2, 32, 64),  # test-tiny: group 2
    (128, 1, 1, 128),  # a group past 64 query heads: one token a block
], ids=["group4", "group3", "group7", "group1", "group2", "group128"])
def test_plan_query_tile(H, Hk, q_tile, rows):
    p = ra.launch_plan(H, Hk, 64, int8=False)
    assert (p.q_tile, p.rows, p.threads) == (q_tile, rows, rows // 16 * 32)


@pytest.mark.parametrize("hd,int8,smem", [
    (64, False, 36_864), (64, True, 35_840),
    (128, False, 69_632), (128, True, 68_608),
    (16, False, 12_288), (16, True, 11_264),
])
def test_plan_shared_memory(hd, int8, smem):
    """The C side launches only if smem_bytes equals its own formula:
    two stages of bf16 K and V tiles with rows padded by 8 elements; an
    int8 pool stages its payload and f32 scales instead and adds one
    dequantized bf16 K and V tile."""
    assert ra.launch_plan(32, 8, hd, int8).smem_bytes == smem


@pytest.mark.parametrize("bad", [dict(hd=80), dict(hd=256), dict(H=256, Hk=1)],
                         ids=["hd80", "hd256", "group256"])
def test_plan_refuses_shapes_the_kernel_lacks(bad):
    args = dict(H=32, Hk=8, hd=64) | bad
    with pytest.raises(ValueError):
        ra.launch_plan(args["H"], args["Hk"], args["hd"], int8=False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_args_follow_q_dtype(dtype):
    """bf16 q hands the C entry point its plan and grid; float32 q runs
    the per-row kernel and hands it zeros."""
    q = torch.zeros((40, 32, 64), dtype=dtype)
    args = ra._plan_args(q, 8, 10, int8=False)
    if dtype == torch.float32:
        assert args == (0, 0, 0, 0, 0)
    else:
        p = ra.launch_plan(32, 8, 64, int8=False)
        assert args == (p.q_tile, p.kv_tile, p.threads, p.smem_bytes, 40 // 16 + 1 + 10)


def test_entry_points_take_the_plan():
    """q, pools (and scale planes), page table, span metadata, out; then
    T, B, H, Hk, hd, page_size, max_pages, the five plan numbers and the
    dtype as ints; then the stream."""
    for name, n_ptr in (("ragged_paged_attention", 8), ("ragged_paged_attention_int8", 10)):
        _, argtypes = build.KERNELS[name]
        assert len(argtypes) == n_ptr + 13 + 1
        assert argtypes[n_ptr:n_ptr + 13] == [build._I] * 13


def _random_layout(rng, T, B):
    """Spans packed from row 0 in stream order (decode rows and prefill
    spans of any length), then padding sequences (q_len 0, q_start T);
    the stream rows past the spans are covered by none."""
    q_start = np.full(B, T, np.int32)
    q_len = np.zeros(B, np.int32)
    kv_len = np.zeros(B, np.int32)
    off = 0
    for s in range(int(rng.integers(1, B + 1))):
        room = T - off
        if room == 0:
            break
        ql = 1 if rng.random() < 0.5 else int(rng.integers(1, room + 1))
        ql = min(ql, room)
        q_start[s], q_len[s] = off, ql
        kv_len[s] = ql + int(rng.integers(0, 300))
        off += ql
    return q_start, q_len, kv_len


def _assign(q_start, q_len, T, B, q_tile):
    """The kernel's block assignment: {(seq, tile): block} and, per
    block past the last work item, the uncovered rows it zeroes."""
    grid = -(-T // q_tile) + B
    tiles = [-(-int(n) // q_tile) for n in q_len]
    items = sum(tiles)
    work = {}
    w = 0
    for s, n in enumerate(tiles):
        for t in range(n):
            work[(s, t)] = w
            w += 1
    ends = q_start + q_len
    zeroed = []
    n_tail = grid - items
    for k in range(n_tail):
        for r in range(k, T, n_tail):
            s = int(np.searchsorted(ends, r, side="right"))
            if not (s < B and q_len[s] > 0 and q_start[s] <= r):
                zeroed.append(r)
    return grid, items, work, zeroed


@pytest.mark.parametrize("seed", range(8))
def test_grid_bound_covers_every_row(seed):
    """ceil(T / QT) + B blocks always exceed the work items
    sum(ceil(q_len / QT)), so at least one block is left to zero the
    uncovered rows; every covered row falls in exactly one work item,
    and every uncovered row is zeroed exactly once."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        T = int(rng.integers(1, 600))
        B = int(rng.integers(1, 65))
        group = int(rng.choice([1, 2, 3, 4, 7, 8]))
        q_tile = ra.launch_plan(group * 4, 4, 64, int8=False).q_tile
        q_start, q_len, kv_len = _random_layout(rng, T, B)
        grid, items, work, zeroed = _assign(q_start, q_len, T, B, q_tile)
        assert grid > items
        assert grid == ra.LaunchPlan(q_tile, 64, 64, 128, 0).blocks(T, B)
        _, tok_pos = ragged_tokens(torch.from_numpy(q_start), torch.from_numpy(q_len),
                                   torch.from_numpy(kv_len), T)
        covered = np.zeros(T, int)
        for (s, t) in work:
            first = q_start[s] + t * q_tile
            covered[first:min(first + q_tile, q_start[s] + q_len[s])] += 1
        in_span = tok_pos.numpy() >= 0
        assert np.array_equal(covered, in_span.astype(int))
        assert sorted(zeroed) == np.flatnonzero(~in_span).tolist()
