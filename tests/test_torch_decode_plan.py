"""The launch plan of the bf16-q paged decode attention kernel
(csrc/paged_decode_attention.cu, planned by ops/cuda/paged_attention.py)
on the CPU: the numbers the wrapper hands the C entry point for every
model the port serves, how the split blocks and their warps cover each
sequence's context, and a numpy mirror of the split and combine
kernels' arithmetic held against the plain version.

The mirror follows the kernels: block (s, kvh, b) attends [s * SPLIT,
min((s + 1) * SPLIT, n)) in tiles of KV_TILE positions, warp w taking
16 of each; each warp keeps an online softmax in log2 units with the
Pallas kernel's guards, the block merges its warps, a sequence with one
split that has work is written by its block, and the combine reduces
the partials of the others. Tolerance: rtol = atol = 1e-5 in float32
(the mirror's sums run in another order than the plain version's).
"""

import math

import numpy as np
import pytest
import torch

from ollamamq_tpu_torch.config import MODEL_CONFIGS
from ollamamq_tpu_torch.ops import attention as tatt
from ollamamq_tpu_torch.ops.cuda import build
from ollamamq_tpu_torch.ops.cuda import paged_attention as pa
from ollamamq_tpu_torch.ops.quant import QuantKV, kv_quantize

SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-pool", "int8-pool"])
@pytest.mark.parametrize("model", sorted(MODEL_CONFIGS))
def test_plan_fits_every_model(model, int8):
    cfg = MODEL_CONFIGS[model]
    group = cfg.num_heads // cfg.num_kv_heads
    p = pa.decode_launch_plan(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 32, 16, int8)
    assert p.smem_bytes <= SMEM_LIMIT
    assert group <= pa.MAX_GROUP
    assert p.threads == pa.WARPS * 32
    assert p.kv_tile == pa.WARPS * pa.WARP_POS and p.split % p.kv_tile == 0
    assert p.n_splits == math.ceil(32 * 16 / p.split)
    assert p.scratch_shape(5) == (5, cfg.num_kv_heads, p.n_splits, group, cfg.head_dim + 2)


@pytest.mark.parametrize("hd,int8,smem", [
    (64, False, 36_864), (64, True, 21_504),
    (128, False, 69_632), (128, True, 37_888),
    (16, False, 12_288), (16, True, 9_216),
])
def test_plan_shared_memory(hd, int8, smem):
    """The C side launches only if smem_bytes equals its own formula: per
    warp, two ring stages of 16 K rows and 16 V rows (bf16 rows padded by
    8 elements; int8 rows padded by 16 bytes, plus their f32 scales),
    which the warp's merge record (8 maxima, 8 sums, 8 x hd f32) reuses."""
    assert pa.decode_launch_plan(32, 8, hd, 16, 8, int8).smem_bytes == smem


@pytest.mark.parametrize("page_size,max_pages", [(32, 16), (8, 130), (16, 1), (1, 1025)])
def test_plan_split_count(page_size, max_pages):
    """n_splits = ceil(max_pages * page_size / SPLIT), from shapes alone."""
    p = pa.decode_launch_plan(32, 8, 64, page_size, max_pages, int8=False)
    assert p.n_splits == -(-page_size * max_pages // pa.SPLIT)
    assert (p.n_splits - 1) * p.split < page_size * max_pages <= p.n_splits * p.split


@pytest.mark.parametrize("bad", [dict(hd=80), dict(hd=256), dict(H=72, Hk=8),
                                 dict(H=128, Hk=1), dict(H=30, Hk=8)],
                         ids=["hd80", "hd256", "group9", "group128", "uneven"])
def test_plan_refuses_shapes_the_kernel_lacks(bad):
    args = dict(H=32, Hk=8, hd=64) | bad
    with pytest.raises(ValueError):
        pa.decode_launch_plan(args["H"], args["Hk"], args["hd"], 16, 8, int8=False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_args_follow_q_dtype(dtype):
    """bf16 q hands the C entry point its plan and an f32 scratch buffer;
    float32 q runs the per-sequence kernel and hands it zeros and none."""
    q = torch.zeros((6, 32, 64), dtype=dtype)
    scratch, args = pa._plan_args(q, 8, 16, 80, int8=False)
    if dtype == torch.float32:
        assert scratch is None and args == (0, 0, 0, 0, 0)
    else:
        p = pa.decode_launch_plan(32, 8, 64, 16, 80, int8=False)
        assert args == (p.split, p.kv_tile, p.threads, p.smem_bytes, p.n_splits)
        assert scratch.dtype == torch.float32
        assert tuple(scratch.shape) == p.scratch_shape(6) == (6, 8, p.n_splits, 4, 66)


def test_entry_points_take_the_plan():
    """q, pools (and scale planes), page table, seq_lens, out, scratch;
    then B, H, Hk, hd, page_size, max_pages, the five plan numbers and
    the dtype as ints; then the stream."""
    for name, n_ptr in (("paged_decode_attention", 7), ("paged_decode_attention_int8", 9)):
        src, argtypes = build.KERNELS[name]
        assert src == "paged_decode_attention.cu"
        assert len(argtypes) == n_ptr + 12 + 1
        assert argtypes[:n_ptr] == [build._P] * n_ptr
        assert argtypes[n_ptr:n_ptr + 12] == [build._I] * 12
        assert argtypes[-1] == build._P


def _block_ranges(n, plan):
    """The split kernel's blocks for a sequence of clamped length n:
    {s: (lo, hi)} for the blocks with work, and per block the positions
    each warp takes, tile by tile."""
    ranges, warps = {}, {}
    for s in range(plan.n_splits):
        lo = s * plan.split
        if lo >= n:
            continue  # the block exits at once
        hi = min(lo + plan.split, n)
        ranges[s] = (lo, hi)
        for w in range(pa.WARPS):
            first = lo + w * pa.WARP_POS
            n_tiles = -(-(hi - first) // plan.kv_tile) if first < hi else 0
            warps[(s, w)] = [p for j in range(n_tiles)
                             for p in range(first + j * plan.kv_tile,
                                            first + j * plan.kv_tile + pa.WARP_POS)
                             if p < hi]
    return ranges, warps


@pytest.mark.parametrize("seed", range(6))
def test_splits_cover_each_context_once(seed):
    """Over seeded random seq_lens (0, negative, past the cap included),
    the blocks with work attend [0, min(seq_len, cap)) exactly once, as
    do their warps; their count is the combine's work count, the grid
    holds them, and a sequence with one such block is the one the split
    kernel writes (the combine skips it), none the one the combine
    zeroes."""
    rng = np.random.default_rng(seed)
    for _ in range(30):
        page_size = int(rng.choice([1, 8, 16, 32]))
        max_pages = int(rng.integers(1, 3 * pa.SPLIT // page_size + 2))
        plan = pa.decode_launch_plan(32, 8, 64, page_size, max_pages, int8=bool(seed % 2))
        cap = page_size * max_pages
        for seq_len in rng.integers(-5, cap + 2 * pa.SPLIT, size=8).tolist() + [0, -1, cap]:
            n = max(0, min(seq_len, cap))
            ranges, warps = _block_ranges(n, plan)
            covered = np.zeros(cap, int)
            for lo, hi in ranges.values():
                covered[lo:hi] += 1
            assert covered[:n].tolist() == [1] * n and not covered[n:].any()
            by_warp = np.zeros(cap, int)
            for pos in warps.values():
                by_warp[pos] += 1
            assert np.array_equal(by_warp, covered)
            assert len(ranges) == plan.splits_with_work(n) <= plan.n_splits
            assert sorted(ranges) == list(range(len(ranges)))  # splits 0..n_work-1
            assert (len(ranges) == 1) == (0 < n <= plan.split)
            assert (len(ranges) == 0) == (n == 0)


def _mirror(q, k, v, pt, seq_lens, page_size, plan, k_scale=None, v_scale=None):
    """numpy mirror of paged_decode_split_kernel + paged_decode_combine_kernel
    in float32 (no bf16 rounding: the point is the split, the masking and
    the merges). An int8 pool passes its payload as k, v and its [S, Hk]
    scales: the K scale multiplies each position's score, the V scale
    its probability, as the kernel applies them."""
    B, H, hd = q.shape
    Hk = k.shape[1]
    G = H // Hk
    cap = pt.shape[1] * page_size
    scale_log2 = np.float32(1 / math.sqrt(hd) * math.log2(math.e))
    out = np.full((B, H, hd), np.nan, np.float32)  # every entry must be written
    part = np.full(plan.scratch_shape(B), np.nan, np.float32)

    def warp_state(qg, positions, lo_tile_positions):
        m = np.full(G, -np.inf, np.float32)
        l = np.zeros(G, np.float32)
        o = np.zeros((G, hd), np.float32)
        for tile in lo_tile_positions:
            vis = [p for p in tile if p in positions]
            if not vis:
                continue
            slots = np.array([pt[b, p // page_size] * page_size + p % page_size for p in vis])
            s = qg @ k[slots, kvh].T  # [G, n]
            if k_scale is not None:
                s = s * k_scale[slots, kvh]
            s = s * scale_log2
            m_new = np.maximum(m, s.max(axis=1))
            alpha = np.where(m == -np.inf, 0, np.exp2(m - m_new)).astype(np.float32)
            p_ = np.exp2(s - m_new[:, None]).astype(np.float32)
            l = l * alpha + p_.sum(axis=1)
            pv = p_ if v_scale is None else p_ * v_scale[slots, kvh]
            o = o * alpha[:, None] + pv @ v[slots, kvh]
            m = m_new
        return m, l, o

    for b in range(B):
        n = max(0, min(int(seq_lens[b]), cap))
        ranges, warps = _block_ranges(n, plan)
        for kvh in range(Hk):
            qg = q[b, kvh * G:(kvh + 1) * G]
            for s, (lo, hi) in ranges.items():
                states = []
                for w in range(pa.WARPS):
                    mine = set(warps[(s, w)])
                    first = lo + w * pa.WARP_POS
                    tiles = [range(first + j * plan.kv_tile, first + j * plan.kv_tile + pa.WARP_POS)
                             for j in range(-(-(hi - first) // plan.kv_tile) if first < hi else 0)]
                    states.append(warp_state(qg, mine, tiles))
                m_all = np.max([st[0] for st in states], axis=0)
                wts = [np.where(st[0] == -np.inf, 0, np.exp2(st[0] - m_all)) for st in states]
                l_all = sum(wt * st[1] for wt, st in zip(wts, states))
                acc = sum(wt[:, None] * st[2] for wt, st in zip(wts, states))
                if len(ranges) == 1:
                    out[b, kvh * G:(kvh + 1) * G] = acc / np.maximum(l_all, 1e-20)[:, None]
                else:
                    part[b, kvh, s, :, :hd] = acc
                    part[b, kvh, s, :, hd] = m_all
                    part[b, kvh, s, :, hd + 1] = l_all
            n_work = len(ranges)
            if n_work == 0:
                out[b, kvh * G:(kvh + 1) * G] = 0.0
            elif n_work > 1:  # the combine kernel
                rec = part[b, kvh, :n_work]  # [n_work, G, hd + 2]
                m_all = rec[:, :, hd].max(axis=0)
                wt = np.exp2(rec[:, :, hd] - m_all)  # every split with work: finite max
                l_all = (wt * rec[:, :, hd + 1]).sum(axis=0)
                acc = (wt[:, :, None] * rec[:, :, :hd]).sum(axis=0)
                out[b, kvh * G:(kvh + 1) * G] = acc / np.maximum(l_all, 1e-20)[:, None]
    return out


@pytest.mark.parametrize("int8", [False, True], ids=["bf16-pool", "int8-pool"])
def test_numpy_mirror_matches_plain(int8):
    """Split plus combine, with the -inf guards, equals the plain version
    over contexts around one and two splits, past the cap, empty and
    negative; rows with nothing visible are exact zeros."""
    rng = np.random.default_rng(7)
    S = pa.SPLIT
    B, H, Hk, hd, ps = 7, 6, 2, 16, 8
    MP = (2 * S + 40) // ps
    seq_lens = np.array([S - 1, S + 1, 2 * S + 3, 0, -4, MP * ps + 50, 37], np.int32)
    plan = pa.decode_launch_plan(H, Hk, hd, ps, MP, int8)
    slots = (MP * B + 2) * ps
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(slots, Hk, hd)).astype(np.float32)
    v = rng.normal(size=(slots, Hk, hd)).astype(np.float32)
    pt = (1 + rng.permutation(MP * B).reshape(B, MP)).astype(np.int32)
    tq, tpt, tsl = (torch.from_numpy(a) for a in (q, pt, seq_lens))
    if int8:
        (kq, ks), (vq, vs) = (kv_quantize(torch.from_numpy(a)) for a in (k, v))
        got = _mirror(q, kq.numpy().astype(np.float32), vq.numpy().astype(np.float32), pt,
                      seq_lens, ps, plan, ks.numpy(), vs.numpy())
        ref = tatt.paged_decode_attention(tq, QuantKV(kq, ks), QuantKV(vq, vs), tpt, tsl, ps)
    else:
        got = _mirror(q, k, v, pt, seq_lens, ps, plan)
        ref = tatt.paged_decode_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                                          tpt, tsl, ps)
    ref = ref.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert np.all(got[seq_lens <= 0] == 0.0)
    assert np.all(ref[seq_lens <= 0] == 0.0)
