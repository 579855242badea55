#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ollamamq_tpu_torch) on one GPU.

    python3 chip_smoke.py            # one card, about four minutes
    python3 chip_smoke.py --profile  # also torch.profiler windows of serving

Phases, each printing JSON lines; any failure exits non-zero:

  build    nvcc builds both CUDA sources from ollamamq_tpu_torch/csrc, in
           parallel, and all four entry points load: ragged and decode
           attention over a pool in q's dtype and over an int8 pool.
  decode-plan
           each decode entry point, called directly with q in bf16,
           refuses a launch plan that differs from decode_launch_plan in
           any one number.
  kernels  each kernel against its plain PyTorch version on the card, q in
           bf16 (atol = rtol = 2e-2) and float32 (1e-4), at the
           llama3.2:1b and llama3:8b attention shapes, a 512-token
           llama3.2:1b prefill (ragged only), a serving decode step of
           llama3.2:1b (8 sequences of 20 to 140 tokens; decode only),
           the CPU tests' edge cases (GQA, MQA, group 1, empty rows,
           contexts past max_pages), the ragged kernel's query-tiling
           edges (a span starting mid-page, spans of QT, QT + 1 and
           2 QT + 3 rows, groups 3 and 7, long tail padding, a prefill
           past max_pages) and the decode kernel's split edges (contexts
           of SPLIT - 1, SPLIT, SPLIT + 1 and 2 SPLIT + 3 at page sizes 8
           and 16, one 512-token sequence alone, a context past
           max_pages beside empty and negative ones, groups 3 and 7 at
           head dim 128, MQA and group 1 over several splits), and the
           span shapes of the page lifecycle at the llama3.2:1b shape:
           speculative verify spans (1 + 4 rows across page boundaries,
           1 + d beside decode rows and a prefill), prefix-hit spans from
           page boundaries 128 and 256 over pages that other rows of the
           call read too, and a decode call after a rollback. Every pool
           slot a kernel must not read holds NaN; in an int8 pool (built
           by the port's kv_quantize) it holds payload 127 and a NaN
           scale. Times with CUDA events: kernel_ms and sdpa_dense_ms as
           50 calls captured in a CUDA graph and replayed (device time;
           SDPA over dense K/V, dequantized to q's dtype for an int8 pool,
           a yardstick only), *_eager_ms as 50 eager calls back to back
           (host launch cost included), decode's kernel_cold_l2_ms with
           the L2 flushed before each replayed call, plain_ms eager;
           bound_ms is the bytes the call must move over 3.35 TB/s, or
           its FLOPs over the dtype's peak, whichever is larger. Ragged lines count the K/V
           positions loaded per kv head per row, per query tile and
           distinct; bf16 decode lines give the launch plan's split
           count and the split blocks that have work.
  serve    the port's HTTP server in-process with llama3.2:1b at full
           width (16 layers, bf16, seeded random weights): requests from
           3 users over /api/generate, /api/chat, /v1/chat/completions,
           one sampled; greedy determinism; both bf16-pool kernels' launch
           counters must rise and the int8 ones stay 0; one prompt's
           prefill and decode logits through the kernels against the plain
           attention path on the same card (serve-logits).
  serve-int8
           the same engine, jobs and checks with int8 weights and int8 KV
           pages, after the bf16 engine is freed: both int8 kernels'
           counters must rise and the bf16 ones stay 0, and the KV pool
           must shrink to at most (hd + 4) / (2 hd) + 0.01 of bf16's
           (serve-int8-logits: the same logits check on the int8 path).
  quant-guardrail
           greedy token-match rate and logit error of the int8 llama3.2:1b
           tree against its bf16 source at full width; printed, not gated.
  serve-runtime
           llama3.2:1b in bf16 through the HTTP server with the prefix
           cache, speculation (k 4), default preemption on a 44-page pool
           that the traffic overflows, and one injected ragged fault: a
           warm request, then 6 users sharing a 4-page system prefix, a
           repeated pattern and a sampled request at once. Gates: every
           reply stop/length, preemptions, prefix hits and accepted drafts
           >= 1, exactly one retry, the sampled request never speculates,
           no page used afterwards and the tree's invariants hold, only
           the two bf16 kernels launched. Prints tokens/s and, per reply,
           the first token that differs from the request served alone
           (not gated).
  serve-runtime-f32
           byte identity at full width in float32 (TF32 off): a lone
           greedy request with and without a forced self-preemption
           (cache off and on), and a repeated pattern with spec off and
           on; token ids must be identical.
  serve-sched
           the fair-share front's scheduling and observability: llama3.2:1b
           in bf16 through the HTTP server under --scheduler srpt, token
           fairness, max_queued_per_user 3 and max_queued 6. With the
           engine loop not started, one user's fourth request gets 429,
           a second user's three are queued (6 in all) and a third
           user's request gets 503, each with a Retry-After >= 1; the
           loop then serves the 6. Then one user sends 4 long requests
           (160 tokens) and four users 2 short ones (16), paced by the
           client under the caps. Gates: every reply stop/length; the
           /metrics scrape parses, its TTFT count grew by the replies
           served and its generated-token counter by their eval_count;
           the MFU gauge in (0, 1] with the card's peak from the table
           (a card missing from it fails); /debug/stepprof samples in the
           ragged and decode modes with all four phases; /debug/hbm
           allocated bytes >= weights + KV pool; /health online after a
           watchdog probe on cuda with no alert firing; only the two
           bf16 kernels launched. Prints the step-phase medians per mode,
           TTFT p50/p99 and TPOT p50 (from the histograms' growth in this
           phase), per-user generated tokens and the MFU.
  serve-models
           the model lifecycle and the rest of the API surface: an engine
           holding llama3.2:1b (bf16, seeded, serve's shape with 4 slots)
           behind the HTTP server. (a) a streamed /api/pull of
           nomic-embed-text (768-d encoder, 12 layers, seeded bf16):
           progress lines then success; /api/tags and /api/ps list both
           models, each with its runtime's weight bytes. (b) 4 greedy
           streams of 160 tokens saturate the 4 decode slots while
           /api/embed sends 8 inputs of 16 to 300 tokens to each model,
           plus one /v1/embeddings and one /api/embeddings: dimensions
           2048 and 768, every norm within 1e-3 of 1, every embed reply
           before the last stream ends, the window launched only the two
           bf16 attention kernels, and an embed-only sub-window (which
           times one batch of 8 per model) none. (c) the first input
           embedded alone against inside the batch: cosine >= 0.999; the
           encoder's card embeddings of the batch against the port's
           plain float32 forward on the CPU with the card's weights:
           cosine >= 0.995. (d) with the loop stopped, an embed placed on
           the encoder: /api/delete answers 409, then the loop restarts
           and serves it. (e) /api/delete of the idle encoder: 200,
           torch.cuda.memory_allocated falls by >= 0.95 of its weight
           bytes, /api/embed on it answers 404; a re-pull gives
           bit-identical lone embeddings. (g) /, /api/show, /api/version,
           /v1/models, /v1/models/{model} and /v1/completions (JSON and
           SSE) answer in the reference's shapes; /api/create, /api/push
           and /api/blobs/x answer 501. (f) save_safetensors writes
           llama3.2:1b's weights in HF layout to a temporary directory; a
           second engine built from it streams greedy ids identical to
           the seeded engine's for 2 prompts x 32 tokens; the directory
           is deleted. Prints embed ms per batch per model, pull seconds,
           bytes freed by the delete and checkpoint write/load seconds.

Then the card as nvidia-smi names it, the kernels line, and the last
line {"ok": true, "device": {...}}. Without CUDA, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import gzip
import http.client
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# Kernel shapes timed with q in bf16 (the rest are checked, not timed).
TIMED_SHAPES = ("llama3.2:1b", "llama3:8b-attn", "llama3.2:1b-prefill512",
                "llama3.2:1b-serve8")
OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
# Kernel -> (source, the TPU kernel it replaces, the serve phase whose
# window counts its launches).
KERNEL_ROWS = {
    "ragged_paged_attention": (
        "ollamamq_tpu_torch/csrc/ragged_paged_attention.cu",
        "ollamamq_tpu/ops/pallas/ragged_attention.py:259", "serve"),
    "paged_decode_attention": (
        "ollamamq_tpu_torch/csrc/paged_decode_attention.cu",
        "ollamamq_tpu/ops/pallas/paged_attention.py:229", "serve"),
    "ragged_paged_attention_int8": (
        "ollamamq_tpu_torch/csrc/ragged_paged_attention.cu",
        "ollamamq_tpu/ops/pallas/ragged_attention.py:259", "serve_int8"),
    "paged_decode_attention_int8": (
        "ollamamq_tpu_torch/csrc/paged_decode_attention.cu",
        "ollamamq_tpu/ops/pallas/paged_attention.py:229", "serve_int8"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() over `iters` calls captured in one
    CUDA graph and replayed back to back: the calls' device time without
    the host's launch cost between them (which cuda_ms includes once a
    call takes less device time than its wrapper takes on the host)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as PyTorch asks
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def cold_l2_ms(fn, iters: int) -> float:
    """Mean device milliseconds of fn() with a cold L2: graph_ms of a
    read of 100 MB (twice the H100's 50 MB L2) followed by fn(), less
    graph_ms of the read alone. graph_ms replays the same call with its
    inputs left in L2; a serving step meets them after the weights'
    reads have passed through it."""
    import torch

    buf = torch.zeros(100 * 2**20 // 4, dtype=torch.float32, device="cuda")
    sink = torch.zeros((), dtype=torch.float32, device="cuda")

    def flush():
        torch.sum(buf, dim=0, out=sink)

    def flushed():
        flush()
        return fn()

    ms = graph_ms(flushed, iters) - graph_ms(flush, iters)
    del buf, sink
    return ms


# -- kernel cases ------------------------------------------------------------
def _pool(seed, contexts, Hk, hd, ps, MP, dtype, int8=False):
    """A paged pool holding `contexts[b]` written positions for sequence b
    (capped at MP * ps), pages shuffled across the pool. Every other slot,
    the trash page included, holds NaN; in an int8 pool (rows quantized
    by the port's kv_quantize) it holds payload 127 and a NaN scale.
    Returns (k, v, page_table) on the card, k and v tensors in `dtype` or
    QuantKV pools."""
    import torch

    from ollamamq_tpu_torch.ops.quant import QuantKV, kv_quantize

    g = torch.Generator().manual_seed(seed)
    cap = MP * ps
    contexts = [max(0, min(c, cap)) for c in contexts]  # positions written
    need = [-(-c // ps) for c in contexts]
    n_pages = sum(need) + 2
    perm = (torch.randperm(n_pages - 1, generator=g) + 1).tolist()
    k = torch.full((n_pages * ps, Hk, hd), float("nan"))
    v = torch.full_like(k, float("nan"))
    written = torch.zeros(n_pages * ps, dtype=torch.bool)
    pt = torch.zeros((len(contexts), MP), dtype=torch.int32)
    for b, (c, n) in enumerate(zip(contexts, need)):
        pages = [perm.pop() for _ in range(n)]
        pt[b, :n] = torch.tensor(pages, dtype=torch.int32)
        pos = torch.arange(c)
        slots = pt[b].long()[pos // ps] * ps + pos % ps
        k[slots] = torch.randn((len(pos), Hk, hd), generator=g)
        v[slots] = torch.randn((len(pos), Hk, hd), generator=g)
        written[slots] = True
    if not int8:
        return k.to("cuda", dtype), v.to("cuda", dtype), pt.cuda()
    pools = []
    for rows in (k, v):
        q, s = kv_quantize(torch.nan_to_num(rows))
        q[~written] = 127
        s[~written] = float("nan")
        pools.append(QuantKV(q.cuda(), s.cuda()))
    return pools[0], pools[1], pt.cuda()


def decode_case(name, seed, B, H, Hk, hd, ps, MP, seq_lens, dtype, int8=False):
    import torch

    k, v, pt = _pool(seed, seq_lens, Hk, hd, ps, MP, dtype, int8)
    g = torch.Generator().manual_seed(seed + 1)
    q = torch.randn((B, H, hd), generator=g).to("cuda", dtype)
    sl = torch.tensor(seq_lens, dtype=torch.int32, device="cuda")
    return dict(name=name, q=q, k=k, v=v, pt=pt, seq_lens=sl, ps=ps)


def ragged_case(name, seed, spans, B, T, H, Hk, hd, ps, MP, dtype, int8=False,
                pool=None):
    """spans: [(q_len, kv_len)] contiguous in stream order; sequences past
    the spans are padding rows, stream rows past them are covered by no
    span. `pool` (k, v, page_table) replaces the default pool."""
    import torch

    contexts = [kv for _, kv in spans] + [0] * (B - len(spans))
    k, v, pt = pool or _pool(seed, contexts, Hk, hd, ps, MP, dtype, int8)
    g = torch.Generator().manual_seed(seed + 1)
    q = torch.randn((T, H, hd), generator=g).to("cuda", dtype)
    q_start = torch.full((B,), T, dtype=torch.int32)
    q_len = torch.zeros(B, dtype=torch.int32)
    kv_len = torch.zeros(B, dtype=torch.int32)
    off = 0
    for i, (ql, kv) in enumerate(spans):
        q_start[i], q_len[i], kv_len[i] = off, ql, kv
        off += ql
    assert off <= T, name
    return dict(name=name, q=q, k=k, v=v, pt=pt, q_start=q_start.cuda(),
                q_len=q_len.cuda(), kv_len=kv_len.cuda(), ps=ps, T_real=off)


def prefix_hit_case(name, seed, dtype, int8=False):
    """Prefix-cache hit spans at the llama3.2:1b attention shape: row 0
    decodes at context 300 over its own 10 pages; rows 1 and 2 are spans
    starting at the page boundaries 128 and 256 whose first 4 and 8 pages
    ARE row 0's (shared, read by three rows of one call) and whose tails
    are private; row 3 is a 1 + 4 verify span over the same shared pages."""
    import torch

    ps, MP = 32, 16
    k, v, pt = _pool(seed, [300, 40, 70, 13, 0, 0], 8, 64, ps, MP, dtype, int8)
    shared = pt.clone()
    for row, n_shared, n_tail in ((1, 4, 2), (2, 8, 3), (3, 4, 1)):
        own = pt[row, :n_tail].clone()
        shared[row] = 0
        shared[row, :n_shared] = pt[0, :n_shared]
        shared[row, n_shared:n_shared + n_tail] = own
    spans = [(1, 300), (40, 168), (70, 326), (5, 141)]
    return ragged_case(name, seed, spans, 6, 128, 32, 8, 64, ps, MP, dtype, int8,
                       pool=(k, v, shared))


def _is_int8(c) -> bool:
    from ollamamq_tpu_torch.ops.quant import QuantKV

    return isinstance(c["k"], QuantKV)


def _decode_calls(c):
    from ollamamq_tpu_torch.ops.attention import paged_decode_attention
    from ollamamq_tpu_torch.ops.cuda import paged_attention as pa

    kern = (pa.paged_decode_attention_int8_cuda if _is_int8(c)
            else pa.paged_decode_attention_cuda)
    args = (c["q"], c["k"], c["v"], c["pt"], c["seq_lens"], c["ps"])
    return (lambda: kern(*args), lambda: paged_decode_attention(*args))


def _ragged_calls(c):
    from ollamamq_tpu_torch.ops.attention import ragged_paged_attention, ragged_tokens
    from ollamamq_tpu_torch.ops.cuda import ragged_attention as ra

    kern = (ra.ragged_paged_attention_int8_cuda if _is_int8(c)
            else ra.ragged_paged_attention_cuda)
    tok_seq, tok_pos = ragged_tokens(c["q_start"], c["q_len"], c["kv_len"],
                                     c["q"].shape[0])
    c["tok_pos"] = tok_pos
    return (lambda: kern(c["q"], c["k"], c["v"], c["pt"], c["q_start"],
                         c["q_len"], c["kv_len"], c["ps"]),
            lambda: ragged_paged_attention(
                c["q"], c["k"], c["v"], c["pt"], tok_seq, tok_pos,
                c["kv_len"], c["ps"]))


def _visible(c, kind):
    """Per query row, how many context positions it attends (capped)."""
    import torch

    cap = c["pt"].shape[1] * c["ps"]
    if kind == "decode":
        return c["seq_lens"].clamp(0, cap)
    n = torch.where(c["tok_pos"] >= 0, c["tok_pos"] + 1, torch.zeros_like(c["tok_pos"]))
    return n.clamp(0, cap)


def bound(c, kind, dtype_name):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    (q, out and metadata once; each sequence's visible K/V rows once: hd
    elements of the pool's own size per (row, kv head), plus a 4-byte f32
    scale in an int8 pool) over HBM bandwidth and its attention FLOPs (QK
    and PV, 4 per head-dim element per visible position) over q's
    dtype's peak (an int8 pool is dequantized to q's dtype before the
    math)."""
    q, k = c["q"], c["k"]
    isz = q.element_size()
    N, H, hd = q.shape
    Hk = k.shape[1]
    row_head_bytes = hd + 4 if _is_int8(c) else hd * k.element_size()
    cap = c["pt"].shape[1] * c["ps"]
    if kind == "decode":
        kv_rows = int(c["seq_lens"].clamp(0, cap).sum())
        meta = c["pt"].numel() * 4 + c["seq_lens"].numel() * 4
    else:
        kv_rows = int(c["kv_len"].clamp(0, cap).sum())
        meta = c["pt"].numel() * 4 + 3 * c["kv_len"].numel() * 4
    nbytes = 2 * q.numel() * isz + 2 * kv_rows * Hk * row_head_bytes + meta
    flops = 4.0 * float(_visible(c, kind).sum()) * H * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kv_positions(c):
    """K/V positions loaded per kv head at this ragged case: by a kernel
    that reads each row's visible prefix per stream row (the float32-q
    kernel), by the bf16-q kernel that reads each query tile's deepest
    frontier once (its launch plan's QT), and the distinct positions."""
    from ollamamq_tpu_torch.ops.cuda.ragged_attention import launch_plan

    T, H, hd = c["q"].shape
    qt = launch_plan(H, c["k"].shape[1], hd, _is_int8(c)).q_tile
    cap = c["pt"].shape[1] * c["ps"]
    per_tile = 0
    for ql, kv in zip(c["q_len"].tolist(), c["kv_len"].tolist()):
        for first in range(0, ql, qt):
            last = min(first + qt, ql) - 1
            per_tile += max(0, min(kv - ql + last + 1, kv, cap))
    return {"kv_positions_per_row": int(_visible(c, "ragged").sum()),
            "kv_positions_per_tile": per_tile,
            "kv_positions_distinct": int(c["kv_len"].clamp(0, cap).sum())}


def decode_blocks(c):
    """The bf16 decode kernel's split count and the split blocks that
    have work at this decode case (its launch plan)."""
    from ollamamq_tpu_torch.ops.cuda.paged_attention import decode_launch_plan

    B, H, hd = c["q"].shape
    Hk, MP = c["k"].shape[1], c["pt"].shape[1]
    plan = decode_launch_plan(H, Hk, hd, c["ps"], MP, _is_int8(c))
    n = c["seq_lens"].clamp(0, MP * c["ps"]).tolist()
    return {"split": plan.split, "n_splits": plan.n_splits,
            "grid_blocks": plan.n_splits * Hk * B,
            "blocks_with_work": Hk * sum(plan.splits_with_work(x) for x in n)}


def sdpa_dense(c, kind):
    """F.scaled_dot_product_attention over K/V pre-gathered into dense
    per-sequence tensors in q's dtype (GQA heads expanded; an int8 pool
    dequantized first): a yardstick only, the gather is not timed and the
    port never calls it."""
    import torch
    import torch.nn.functional as F

    from ollamamq_tpu_torch.ops.quant import kv_gather

    q, k, v, pt, ps = c["q"], c["k"], c["v"], c["pt"], c["ps"]
    H, hd = q.shape[1], q.shape[2]
    G = H // k.shape[1]
    cap = pt.shape[1] * ps
    pos = torch.arange(cap, device="cuda")
    slots = pt.long()[:, pos // ps] * ps + pos % ps  # [B, cap]

    def dense(pool):
        rows = torch.nan_to_num(kv_gather(pool, slots)).to(q.dtype)
        return rows.transpose(1, 2).repeat_interleave(G, dim=1)

    kd, vd = dense(k), dense(v)
    if kind == "decode":
        qd = q[:, :, None, :]
        mask = (pos[None, :] < c["seq_lens"][:, None])[:, None, None, :]
    else:
        live = (c["q_len"] > 0).nonzero().flatten()
        maxq = int(c["q_len"].max())
        qs, ql, kl = c["q_start"][live], c["q_len"][live], c["kv_len"][live]
        rows = (qs[:, None] + torch.arange(maxq, device="cuda")[None, :]).clamp_max(q.shape[0] - 1)
        qd = q[rows.long()].transpose(1, 2)  # [n, H, maxq, hd]
        kd, vd = kd[live], vd[live]
        qpos = (kl - ql)[:, None] + torch.arange(maxq, device="cuda")[None, :]
        mask = (pos[None, None, :] <= qpos[:, :, None]) & (pos[None, None, :] < kl[:, None, None])
        mask = mask | (pos[None, None, :] == 0)  # keep padded query rows finite
        mask = mask[:, None]
    return lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)


def timed_cases(dtype, int8):
    """(kind, case) pairs at the timed shapes (TIMED_SHAPES)."""
    import random

    rnd = random.Random(0)
    ctx64 = [rnd.randint(1, 512) for _ in range(64)]
    decode_spans = [(1, rnd.randint(1, 512)) for _ in range(48)]
    mixed = decode_spans + [(128, 128), (96, 352), (32, 32)]  # 304 rows
    ctx8 = [rnd.randint(20, 140) for _ in range(8)]  # a serving decode step
    d = dict(dtype=dtype, int8=int8)
    return [
        ("decode", decode_case("llama3.2:1b", 1, 64, 32, 8, 64, 32, 16, ctx64, **d)),
        ("decode", decode_case("llama3:8b-attn", 3, 64, 32, 8, 128, 32, 16, ctx64, **d)),
        ("ragged", ragged_case("llama3.2:1b", 2, mixed, 64, 320, 32, 8, 64, 32, 16, **d)),
        ("ragged", ragged_case("llama3:8b-attn", 4, mixed, 64, 320, 32, 8, 128, 32, 16, **d)),
        ("ragged", ragged_case("llama3.2:1b-prefill512", 22, [(512, 512)], 8, 512, 32, 8, 64, 32, 16, **d)),
        ("decode", decode_case("llama3.2:1b-serve8", 31, 8, 32, 8, 64, 32, 16, ctx8, **d)),
    ]


def kernel_cases(dtype, int8):
    """(kind, case) pairs: the timed shapes first, then edge cases."""
    from ollamamq_tpu_torch.ops.cuda.paged_attention import decode_launch_plan

    d = dict(dtype=dtype, int8=int8)
    S = decode_launch_plan(32, 8, 64, 8, 40, int8).split  # the decode kernel's split
    edges = [S - 1, S, S + 1, 2 * S + 3]
    two = (2 * S + 64) // 16  # pages of 16 past two splits
    return timed_cases(dtype, int8) + [
        ("decode", decode_case("gqa-a", 5, 3, 8, 4, 32, 8, 6, [20, 9, 37], **d)),
        ("decode", decode_case("gqa-b", 6, 3, 8, 4, 32, 8, 6, [1, 48, 16], **d)),
        ("decode", decode_case("mqa", 7, 2, 4, 1, 16, 8, 4, [8, 25], **d)),
        ("decode", decode_case("group1", 8, 2, 4, 4, 64, 8, 4, [5, 30], **d)),
        ("decode", decode_case("past-cap+empty", 9, 3, 8, 2, 32, 8, 4, [40, 0, 33], **d)),
        ("ragged", ragged_case("mixed", 10, [(11, 11), (1, 20), (5, 29), (1, 1)], 10, 40, 4, 2, 16, 8, 8, **d)),
        ("ragged", ragged_case("decode-tile", 11, [(1, 5 + 3 * i) for i in range(9)], 10, 40, 4, 2, 16, 8, 8, **d)),
        ("ragged", ragged_case("long-prefill", 12, [(21, 21), (1, 9), (1, 17), (3, 30)], 10, 40, 4, 2, 16, 8, 8, **d)),
        ("ragged", ragged_case("mqa", 13, [(6, 6), (1, 12)], 3, 8, 4, 1, 16, 8, 8, **d)),
        ("ragged", ragged_case("group1", 14, [(6, 6), (1, 12)], 3, 8, 4, 4, 16, 8, 8, **d)),
        ("ragged", ragged_case("past-cap", 15, [(3, 40), (1, 33)], 4, 6, 8, 2, 32, 8, 4, **d)),
        # Edges of the query tiling (QT = 16 at group 4, 21 at group 3,
        # 9 at group 7): a span starting mid-page after prior context,
        # spans of QT, QT + 1 and 2 QT + 3 rows, long tail padding with
        # padding sequences, a prefill whose frontier passes the cap.
        ("ragged", ragged_case("mid-page", 16, [(37, 82), (1, 30), (5, 13)], 4, 48, 32, 8, 64, 8, 12, **d)),
        ("ragged", ragged_case("qt-edges", 17, [(16, 16), (17, 50), (35, 90), (1, 7)], 6, 72, 32, 8, 64, 16, 8, **d)),
        ("ragged", ragged_case("group3", 18, [(21, 21), (22, 60), (45, 100), (1, 33)], 6, 96, 24, 8, 128, 16, 8, **d)),
        ("ragged", ragged_case("group7", 19, [(9, 9), (10, 40), (21, 70), (1, 12)], 6, 48, 28, 4, 128, 16, 8, **d)),
        ("ragged", ragged_case("tail-pad", 20, [(5, 20), (1, 9), (12, 12)], 8, 64, 8, 2, 32, 8, 4, **d)),
        ("ragged", ragged_case("prefill-past-cap", 21, [(24, 40), (12, 60), (1, 70)], 4, 40, 8, 2, 32, 8, 4, **d)),
        # Edges of the decode kernel's split over the context: contexts
        # around one and two splits, one sequence alone, a context past
        # max_pages beside empty and negative ones, the GQA groups of
        # llama3.2:3b and qwen2.5:7b, MQA and group 1 over several splits.
        ("decode", decode_case("split-edges-ps8", 23, 4, 32, 8, 64, 8, -(-edges[-1] // 8) + 1, edges, **d)),
        ("decode", decode_case("split-edges-ps16", 24, 4, 32, 8, 64, 16, -(-edges[-1] // 16) + 1, edges, **d)),
        ("decode", decode_case("alone-512", 25, 1, 32, 8, 64, 32, 16, [512], **d)),
        ("decode", decode_case("past-cap+zero", 26, 4, 32, 8, 64, 16, (S + 64) // 16, [S + 200, 0, -3, S // 2 + 20], **d)),
        ("decode", decode_case("group3-hd128", 27, 3, 24, 8, 128, 16, two, [5, S + 72, 2 * S + 44], **d)),
        ("decode", decode_case("group7-hd128", 28, 3, 28, 4, 128, 16, two, [S + 2, 1, 2 * S], **d)),
        ("decode", decode_case("mqa-split", 29, 3, 8, 1, 64, 16, two, [77, 2 * S + 4, S + 1], **d)),
        ("decode", decode_case("group1-split", 30, 3, 8, 8, 128, 16, two, [2 * S, 3, S + 72], **d)),
        # Span shapes the page lifecycle brings to the serve path, at the
        # llama3.2:1b attention shape: speculative verify spans (1 + 4
        # rows whose positions cross a page boundary, then 1 + d beside
        # decode rows and a prefill span), prefix-hit spans over pages
        # other rows of the call read too, and a decode call after a
        # rollback (contexts at and one past page multiples, their
        # freed tail entries the trash page, whose slots hold NaN).
        ("ragged", ragged_case("verify-spans", 32, [(5, kv) for kv in (36, 100, 130, 194, 260, 322, 418, 484)],
                               8, 40, 32, 8, 64, 32, 16, **d)),
        ("ragged", ragged_case("verify-mixed", 33, [(1, 77), (2, 64), (3, 97), (4, 250), (5, 33), (1, 5), (48, 48)],
                               8, 80, 32, 8, 64, 32, 16, **d)),
        ("ragged", prefix_hit_case("prefix-hit", 34, **d)),
        ("decode", decode_case("post-rollback", 35, 8, 32, 8, 64, 32, 16, [32, 33, 64, 65, 96, 97, 128, 129], **d)),
    ]


def decode_plan_phase(report) -> None:
    """Each bf16-q decode entry point refuses a launch plan that differs
    from decode_launch_plan in any one of its five numbers
    (cudaErrorInvalidValue, 1), called directly at the llama3.2:1b shape;
    a refused call launches nothing, and no wrapper counts it."""
    import torch

    from ollamamq_tpu_torch.ops.cuda import DTYPE_CODES, build
    from ollamamq_tpu_torch.ops.cuda.paged_attention import decode_launch_plan

    for int8 in (False, True):
        kind, c = timed_cases(torch.bfloat16, int8)[0]
        assert kind == "decode" and c["name"] == "llama3.2:1b"
        B, H, hd = c["q"].shape
        Hk, MP = c["k"].shape[1], c["pt"].shape[1]
        plan = decode_launch_plan(H, Hk, hd, c["ps"], MP, int8)
        good = [plan.split, plan.kv_tile, plan.threads, plan.smem_bytes, plan.n_splits]
        scratch = torch.empty(plan.scratch_shape(B), dtype=torch.float32, device="cuda")
        out = torch.empty_like(c["q"])
        pools = (c["k"].q, c["v"].q, c["k"].s, c["v"].s) if int8 else (c["k"], c["v"])
        name = "paged_decode_attention" + ("_int8" if int8 else "")
        fn = build.kernel_fn(name)
        refused = {}
        for i, field in enumerate(("split", "kv_tile", "threads", "smem_bytes", "n_splits")):
            bad = list(good)
            bad[i] += 1 if field == "n_splits" else 64
            refused[field] = fn(c["q"].data_ptr(), *(t.data_ptr() for t in pools),
                                c["pt"].data_ptr(), c["seq_lens"].data_ptr(), out.data_ptr(),
                                scratch.data_ptr(), B, H, Hk, hd, c["ps"], MP, *bad,
                                DTYPE_CODES[torch.bfloat16],
                                torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        line = {"phase": "decode-plan", "kernel": name, "plan": good, "rc": refused,
                "ok": all(rc == 1 for rc in refused.values())}
        emit(line)
        report["decode_plan"].append(line)
        if not line["ok"]:
            raise SystemExit(f"a decode entry point took a plan not its own: {line}")


def kernel_phase(report) -> None:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32

    summary = {name: {} for name in KERNEL_ROWS}
    for int8 in (False, True):
        for dtype in (bf16, f32):
            dname = str(dtype).replace("torch.", "")
            tol = TOL[dname]
            flat = kernel_cases(dtype, int8)
            for kind, c in flat:
                shape_name = c["name"]
                kern, plain = (_decode_calls if kind == "decode" else _ragged_calls)(c)
                out = kern()
                ref = plain()
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                ok = bool(torch.isfinite(out).all()) and torch.allclose(
                    out.float(), ref.float(), rtol=tol, atol=tol)
                if kind == "ragged":
                    pad = c["tok_pos"] < 0
                    ok = ok and bool((out[pad] == 0).all())
                else:  # nothing visible: exact zeros
                    ok = ok and bool((out[c["seq_lens"] <= 0] == 0).all())
                name = ("paged_decode_attention" if kind == "decode"
                        else "ragged_paged_attention") + ("_int8" if int8 else "")
                line = {"phase": "kernels", "kernel": name, "case": shape_name,
                        "dtype": dname, "pool": "int8" if int8 else dname,
                        "tol": tol, "max_abs_err": err, "ok": ok}
                if kind == "decode" and dtype == bf16:
                    line.update(decode_blocks(c))
                if shape_name in TIMED_SHAPES and dtype == bf16:
                    sdpa = sdpa_dense(c, kind)
                    line["kernel_ms"] = graph_ms(kern, 50)
                    line["kernel_eager_ms"] = cuda_ms(kern, 50)
                    if kind == "decode":
                        line["kernel_cold_l2_ms"] = cold_l2_ms(kern, 20)
                    line["plain_ms"] = cuda_ms(plain, 5, warmup=1)
                    line["sdpa_dense_ms"] = graph_ms(sdpa, 50)
                    line["sdpa_dense_eager_ms"] = cuda_ms(sdpa, 50)
                    line["bound_ms"], line["bound_by"] = bound(c, kind, dname)
                    if kind == "ragged":
                        line["rows"] = int(c["q"].shape[0])
                        line["rows_in_spans"] = c["T_real"]
                        line.update(kv_positions(c))
                    summary[name][shape_name] = line
                emit(line)
                report["kernels"].append(line)
                if not ok:
                    raise SystemExit(f"kernel mismatch: {line}")
                del out, ref
            del flat
            torch.cuda.empty_cache()
    report["kernel_summary"] = summary


# -- serving -----------------------------------------------------------------
def _post(port, path, body, user, timeout=600):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    c.request("POST", path, json.dumps(body), {"X-User-ID": user,
                                               "Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    c.close()
    if r.status != 200:
        raise RuntimeError(f"{path} as {user}: HTTP {r.status} {data[:300]!r}")
    return r.getheader("Content-Type"), data


def _ollama_result(ctype, data):
    """(token ids, done_reason) from an Ollama JSON or NDJSON reply."""
    if ctype == "application/x-ndjson":
        frames = [json.loads(x) for x in data.decode().splitlines()]
        ids = [t for f in frames for t in f.get("token_ids", [])]
        last = frames[-1]
    else:
        last = json.loads(data)
        ids = last["token_ids"]
    if not last.get("done") or "error" in last:
        raise RuntimeError(f"stream did not finish cleanly: {last}")
    return ids, last["done_reason"]


def serve_phase(report, profile: bool, int8: bool = False) -> None:
    """Serve llama3.2:1b at full width through the HTTP server and check
    replies, greedy determinism, which kernels the window launched and
    the kernel path's logits. int8=True serves int8 weights and int8 KV
    pages and runs after the bf16 phase, whose engine must be gone."""
    import torch

    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.engine import kv_cache as kvc
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.models import llama
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server

    model = "llama3.2:1b"
    quant = "int8" if int8 else "bfloat16"
    phase = "serve-int8" if int8 else "serve"
    suffix = "_int8" if int8 else ""
    ecfg = EngineConfig(model=model, max_slots=8, num_pages=8 * 16 + 8,
                        page_size=32, max_pages_per_seq=16,
                        max_batch_tokens=512, token_granule=16,
                        max_new_tokens=48, decode_steps_per_iter=8,
                        dtype="bfloat16", weights_dtype=quant, kv_dtype=quant,
                        seed=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = TorchEngine(ecfg)  # the CUDA device: the entry point's default
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rt = engine.runtimes[model]
    srv = serve_in_thread(engine, port=0, timeout_s=600)
    port = srv.server_address[1]
    text = ("The quick brown fox jumps over the lazy dog while the scheduler "
            "keeps every user's queue fair. ")
    greedy = {"temperature": 0, "num_predict": 32}
    jobs = {
        "alice/generate": ("/api/generate", "alice",
                           {"model": model, "prompt": text * 2, "stream": False,
                            "options": greedy}),
        "bob/chat-stream": ("/api/chat", "bob",
                            {"model": model, "options": greedy, "messages": [
                                {"role": "user", "content": text}]}),
        "carol/openai": ("/v1/chat/completions", "carol",
                         {"model": model, "max_tokens": 32, "temperature": 0,
                          "messages": [{"role": "user", "content": text[:60]}]}),
        "carol/sampled": ("/api/generate", "carol",
                          {"model": model, "prompt": text * 3, "stream": False,
                           "options": {"temperature": 0.8, "top_k": 40,
                                       "top_p": 0.9, "seed": 7,
                                       "repeat_penalty": 1.1,
                                       "num_predict": 32}}),
    }
    results, errors = {}, []

    def run(name):
        path, user, body = jobs[name]
        try:
            results[name] = _post(port, path, body, user)
        except Exception as e:  # noqa: BLE001 — reported, then fails the phase
            errors.append(f"{name}: {e}")

    before = dict(rt.stats())
    reset_launch_counts()
    t_serve = time.monotonic()
    threads = [threading.Thread(target=run, args=(n,)) for n in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    # The same greedy prompt twice more, each alone: identical tokens.
    repeat = []
    for _ in range(2):
        ctype, data = _post(port, "/api/generate", jobs["alice/generate"][2], "alice")
        repeat.append(_ollama_result(ctype, data)[0])
    counts = launch_counts()
    serve_s = time.monotonic() - t_serve
    after = dict(rt.stats())
    window_peak = torch.cuda.max_memory_allocated()
    prof = None
    if profile:
        prof = profile_window(port, model, text, rt)
    stop_server(srv)
    if errors or len(results) != len(jobs):
        raise SystemExit(f"serve requests failed: {errors}")

    replies = {}
    for name, (ctype, data) in results.items():
        if name == "carol/openai":
            body = json.loads(data)
            n = body["usage"]["completion_tokens"]
            replies[name] = {"tokens": n, "done_reason": body["choices"][0]["finish_reason"]}
        else:
            ids, reason = _ollama_result(ctype, data)
            n = len(ids)
            replies[name] = {"tokens": n, "done_reason": reason}
        if n <= 0 or replies[name]["done_reason"] not in ("stop", "length"):
            raise SystemExit(f"{name}: no tokens or no done reason: {replies[name]}")
    deterministic = repeat[0] == repeat[1] and len(repeat[0]) > 0
    ragged = after["ragged_dispatches"] - before["ragged_dispatches"]
    steps = after["decode_steps"] - before["decode_steps"]
    tokens = after["tokens_generated"] - before["tokens_generated"]
    own = ("ragged_paged_attention" + suffix, "paged_decode_attention" + suffix)
    line = {"phase": phase, "model": model, "layers": rt.cfg.num_layers,
            "dtype": "bfloat16", "weights_dtype": rt.weights_dtype,
            "kv_dtype": rt.kv_dtype, "init_s": init_s, "serve_s": serve_s,
            "requests": len(jobs) + 2, "users": 3, "tokens": tokens,
            "tokens_per_s": tokens / serve_s, "replies": replies,
            "greedy_repeat_identical": deterministic,
            "ragged_dispatches": ragged, "decode_steps": steps,
            "decode_dispatches": after["decode_dispatches"] - before["decode_dispatches"],
            "launches": counts,
            "launches_per_ragged_dispatch": counts[own[0]] / max(1, ragged),
            "launches_per_decode_step": counts[own[1]] / max(1, steps),
            "param_bytes": rt.param_bytes, "kv_bytes": rt.kv_bytes,
            "init_max_memory_allocated": init_peak,
            "max_memory_allocated": window_peak}
    if int8:
        hd = rt.cfg.head_dim
        line["kv_bytes_vs_bf16"] = rt.kv_bytes / report["serve"]["kv_bytes"]
        line["kv_bytes_vs_bf16_limit"] = (hd + 4) / (2 * hd) + 0.01
        line["param_bytes_vs_bf16"] = rt.param_bytes / report["serve"]["param_bytes"]
        line["tokens_per_s_vs_bf16"] = line["tokens_per_s"] / report["serve"]["tokens_per_s"]
    if prof is not None:
        line["profile"] = prof
    emit(line)
    report[phase.replace("-", "_")] = line
    if not deterministic:
        raise SystemExit(f"greedy repeat differs: {repeat}")
    # The window ran this phase's two kernels and none of the others.
    if any(counts[k] <= 0 for k in own) or any(
            counts[k] != 0 for k in counts if k not in own):
        raise SystemExit(f"{phase}: the window did not launch exactly {own}: {counts}")
    if int8 and line["kv_bytes_vs_bf16"] > line["kv_bytes_vs_bf16_limit"]:
        raise SystemExit(f"int8 KV pool did not shrink enough: {line}")

    # One prompt's prefill and first decode step through the kernels vs
    # the plain attention path, on the serving weights (outside the
    # counted window).
    cfg, ps = rt.cfg, ecfg.page_size
    n = 77
    prompt = torch.tensor(rt.tokenizer.encode(text)[:n], dtype=torch.int32, device="cuda")
    T = 80
    small = EngineConfig(model=model, num_pages=5, page_size=ps, max_pages_per_seq=4)
    pt = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32, device="cuda")
    tokens = torch.zeros(T, dtype=torch.int32, device="cuda")
    tokens[:n] = prompt
    tok_pos = torch.full((T,), -1, dtype=torch.int32, device="cuda")
    tok_pos[:n] = torch.arange(n, dtype=torch.int32, device="cuda")
    tok_seq = torch.zeros(T, dtype=torch.int32, device="cuda")
    ws = torch.where(tok_pos >= 0, pt[0, (tok_pos.clamp_min(0) // ps).long()] * ps
                     + tok_pos.clamp_min(0) % ps, torch.zeros_like(tok_pos))
    meta = [torch.tensor([v], dtype=torch.int32, device="cuda") for v in (0, n, n)]
    logits = {}
    for impl in ("kernel", "plain"):
        kc, vc = kvc.alloc_kv_pool(cfg, small, torch.bfloat16, "cuda", kv_dtype=quant)
        pre, _, _ = llama.forward_ragged(
            rt.params, cfg, tokens, tok_seq, tok_pos, ws,
            torch.tensor([n - 1], device="cuda"), kc, vc, pt, *meta, ps,
            attn_impl=impl)
        nxt = pre.argmax(-1).to(torch.int32)
        dec, _, _ = llama.forward_decode(
            rt.params, cfg, nxt, torch.tensor([n], dtype=torch.int32, device="cuda"),
            kc, vc, pt, ps, attn_impl=impl)
        logits[impl] = (pre, dec)
        del kc, vc
    torch.cuda.synchronize()
    checks = {}
    for i, what in enumerate(("prefill", "decode")):
        got, ref = logits["kernel"][i], logits["plain"][i]
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        checks[what] = {"max_abs_err": err, "ref_max_abs": scale,
                        "rel_err": err / scale,
                        "top1_equal": bool((got.argmax(-1) == ref.argmax(-1)).all()),
                        "ok": bool(torch.isfinite(got).all()) and err <= TOL["bfloat16"] * scale}
    line = {"phase": phase + "-logits", "model": model, "tokens": n,
            "weights_dtype": quant, "kv_dtype": quant,
            "tol": f"max |kernel - plain| <= {TOL['bfloat16']} * max |plain|",
            **checks}
    emit(line)
    report[phase.replace("-", "_") + "_logits"] = line
    if not all(c["ok"] for c in checks.values()):
        raise SystemExit(f"kernel path logits disagree with the plain path: {checks}")


def _first_diff(a, b):
    """Index of the first token where two id streams differ, else None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def serve_runtime_phase(report) -> None:
    """llama3.2:1b at full width in bf16 through the HTTP server with the
    prefix cache, speculation (k 4) and default preemption on a pool too
    small for the traffic, and one injected ragged fault. A warm request
    (system prefix + tail) runs first and takes the fault: it is retried
    once and its finished prompt pages seed the tree. Then 8 requests at
    once: 6 users sharing the 4-page system prefix, a repeated pattern
    (drafts verify) and a sampled request (never speculates). Gates: every
    reply ends stop/length; preemptions >= 1, prefix hits >= 1, accepted
    drafts >= 1, exactly one retry; afterwards no page is used and the
    tree's invariants hold; the window launched both bf16 kernels and no
    int8 entry point. Each reply's first token differing from the same
    request served alone (cache, spec and pressure off) is printed, not
    gated: bf16 rounding differs between batch shapes."""
    import torch

    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.server.app import serve_in_thread, stop_server
    from ollamamq_tpu_torch.testing.faults import FaultPlan

    model, ps, usable, max_new = "llama3.2:1b", 32, 44, 160
    gc.collect()
    torch.cuda.empty_cache()
    # 127 bytes + BOS: the system prefix is exactly 4 pages.
    system = ("System: you are the assistant of a shared serving front; every "
              "user's queue is fair and each answer is short and exact.\n")[:127]
    system = system + "." * (127 - len(system))
    tails = ["Q: what is a page table?", "Q: why preempt a victim?",
             "Q: how does a radix tree share prompts?", "Q: when is a draft accepted?",
             "Q: what does fair share mean for me?", "Q: how long is one page?"]
    # Greedy and penalty-free (Ollama's default repeat_penalty is 1.1):
    # the rows that speculate.
    greedy = {"temperature": 0, "repeat_penalty": 1.0, "num_predict": max_new}
    jobs = {f"user{i}/prefix": (f"user{i}", {"prompt": system + t, "options": greedy})
            for i, t in enumerate(tails)}
    jobs["copy/pattern"] = ("copy", {"prompt": "red green blue " * 10, "options": greedy})
    jobs["sampled/seeded"] = ("sampled", {"prompt": system + "Q: tell me anything.",
                                          "options": {"temperature": 0.8, "top_k": 40,
                                                      "top_p": 0.9, "seed": 11,
                                                      "num_predict": max_new}})
    warm = ("warm", {"prompt": system + "Q: warm the cache.", "options": greedy})
    # Pages: each request needs ceil((prompt + 1 + max_new) / 32) <= 10;
    # the 8 concurrent ones need about 56 pages (the 4 shared ones once)
    # against 44 usable (a request that finishes early, as the drafted one
    # does, frees 10), so decode growth must preempt.
    plan = FaultPlan([{"site": "ragged", "kind": "exception", "at": [1]}])
    ecfg = EngineConfig(model=model, max_slots=8, num_pages=usable + 1, page_size=ps,
                        max_pages_per_seq=16, max_batch_tokens=512, token_granule=16,
                        max_new_tokens=max_new, decode_steps_per_iter=8,
                        dtype="bfloat16", prefix_cache=True, spec=True, spec_k=4,
                        fault_plan=plan, seed=0)
    engine = TorchEngine(ecfg)
    rt = engine.runtimes[model]
    srv = serve_in_thread(engine, port=0, timeout_s=600)
    port = srv.server_address[1]

    def gen(user, body):
        return _ollama_result(*_post(port, "/api/generate",
                                     {"model": model, "stream": False, **body}, user))

    results, errors = {}, []

    def run(name):
        user, body = jobs[name]
        try:
            results[name] = gen(user, body)
        except Exception as e:  # noqa: BLE001 — reported, then fails the phase
            errors.append(f"{name}: {e}")

    reset_launch_counts()
    t0 = time.monotonic()
    results["warm"] = gen(*warm)
    threads = [threading.Thread(target=run, args=(n,)) for n in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    serve_s = time.monotonic() - t0
    counts = launch_counts()
    stats, sampled_speculated = engine.call_on_loop(
        lambda: (rt.prefix_cache.check(), rt.stats(), "sampled" in rt._spec_user)[1:])
    stop_server(srv)
    if errors or len(results) != len(jobs) + 1:
        raise SystemExit(f"serve-runtime requests failed: {errors}")

    # Each request alone on a plain engine (same weights): cache, spec and
    # pressure off.
    plain = TorchEngine(EngineConfig(model=model, max_slots=8, num_pages=8 * 16 + 8,
                                     page_size=ps, max_pages_per_seq=16,
                                     max_batch_tokens=512, token_granule=16,
                                     max_new_tokens=max_new, decode_steps_per_iter=8,
                                     dtype="bfloat16", seed=0), params=rt.params)
    srv = serve_in_thread(plain, port=0, timeout_s=600)
    port = srv.server_address[1]
    alone = {name: gen(*job) for name, job in [("warm", warm), *jobs.items()]}
    stop_server(srv)

    tokens = sum(len(ids) for ids, _ in results.values())
    pc = stats["prefix_cache"]
    line = {"phase": "serve-runtime", "model": model, "layers": rt.cfg.num_layers,
            "dtype": "bfloat16", "max_slots": ecfg.max_slots,
            "num_pages": ecfg.num_pages, "usable_pages": usable, "max_new_tokens": max_new,
            "pages_per_request": {n: -(-(len(body["prompt"]) + 1 + max_new) // ps)
                                  for n, (_, body) in [("warm", warm), *jobs.items()]},
            "requests": len(results), "serve_s": serve_s, "tokens": tokens,
            "tokens_per_s": tokens / serve_s,
            "replies": {n: {"tokens": len(ids), "done_reason": why,
                            "first_diff_vs_alone": _first_diff(ids, alone[n][0])}
                        for n, (ids, why) in results.items()},
            "preempt_count": stats["preemptions"], "retry_count": engine.retry_count(),
            "spec_proposed": stats["spec"]["proposed"],
            "spec_accepted": stats["spec"]["accepted"],
            "spec_rollbacks": stats["spec"]["rollbacks"], "prefix_cache": pc,
            "sampled_speculated": sampled_speculated,
            "used_pages_after": stats["pages_used"],
            "cached_pages_after": stats["kv_pages_cached"],
            "ragged_dispatches": stats["ragged_dispatches"],
            "decode_steps": stats["decode_steps"], "launches": counts,
            "fault_plan": plan.stats()}
    emit(line)
    report["serve_runtime"] = line
    del plain, engine, rt
    bad = [n for n, r in line["replies"].items() if r["done_reason"] not in ("stop", "length")
           or r["tokens"] <= 0]
    own = ("ragged_paged_attention", "paged_decode_attention")
    gates = {"replies": not bad, "preempt": line["preempt_count"] >= 1,
             "prefix_hits": pc["hits"] >= 1, "spec_accepted": line["spec_accepted"] >= 1,
             "one_retry": line["retry_count"] == 1, "sampled_no_spec": not sampled_speculated,
             "no_used_pages": line["used_pages_after"] == 0,
             "kernels": all(counts[k] > 0 for k in own)
             and all(counts[k] == 0 for k in counts if k not in own)}
    if not all(gates.values()):
        raise SystemExit(f"serve-runtime gates failed: {gates} {bad}")


def _collect(req, timeout=600):
    deadline = time.monotonic() + timeout
    items = []
    while time.monotonic() < deadline:
        item = req.stream.get(timeout=0.5)
        if item is not None:
            items.append(item)
            if item.kind in ("done", "error"):
                return items
    raise SystemExit(f"request {req.req_id} did not finish: {items[-3:]}")


def serve_runtime_f32_phase(report) -> None:
    """Byte identity on the card: llama3.2:1b at full width with float32
    weights and KV (TF32 off), so argmax flips from rounding are
    vanishingly rare, through the float32-q bodies of both kernels. One
    greedy request served plainly, then with the third decode-time page
    growth failing (it preempts itself and replays), cache off and on;
    a repeated-pattern prompt with spec off and on. Token ids must be
    identical, with a preemption and with accepted drafts."""
    import dataclasses

    import torch

    from ollamamq_tpu_torch.config import EngineConfig, get_model_config
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.models import weights
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.ops.sampling import SamplingParams
    from ollamamq_tpu_torch.testing.faults import FaultPlan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = "llama3.2:1b"
    gc.collect()
    torch.cuda.empty_cache()
    params = weights.init_random(get_model_config(model), 0, torch.float32, "cuda")
    base = EngineConfig(model=model, max_slots=4, num_pages=4 * 16 + 4, page_size=32,
                        max_pages_per_seq=16, max_batch_tokens=512, token_granule=16,
                        max_new_tokens=96, decode_steps_per_iter=8, dtype="float32",
                        seed=0)

    def serve(prompt, max_tokens, **over):
        eng = TorchEngine(dataclasses.replace(base, **over), params=params)
        eng.start()
        try:
            rt = eng.runtimes[model]
            ids = rt.tokenizer.encode(prompt)
            req = eng.enqueue_request("solo", "", model, prompt_tokens=ids,
                                      sampling=SamplingParams(max_tokens=max_tokens))
            items = _collect(req)
            if items[-1].kind != "done":
                raise SystemExit(f"serve-runtime-f32 {over}: {items[-1]}")
            return list(req.generated_ids), {
                "preemptions": req.preemptions, "spec_accepted": rt.spec_accepted,
                "spec_proposed": rt.spec_proposed, "used_pages": rt.alloc.used_pages,
                "prefix_hits": (rt.prefix_cache.hits if rt.prefix_cache else None)}
        finally:
            eng.stop()

    lone = "The quick brown fox jumps over the lazy dog; the scheduler keeps queues fair."
    copy = "red green blue " * 10
    reset_launch_counts()
    t0 = time.monotonic()
    runs = {"plain": serve(lone, 64)}
    for cache in (False, True):
        runs[f"preempted-cache-{'on' if cache else 'off'}"] = serve(
            lone, 64, prefix_cache=cache,
            fault_plan=FaultPlan([{"site": "extend", "kind": "alloc_fail", "at": [3]}]))
    runs["copy-spec-off"] = serve(copy, 96)
    runs["copy-spec-on"] = serve(copy, 96, spec=True, spec_k=4, spec_min_accept=0.0)
    seconds = time.monotonic() - t0
    counts = launch_counts()
    checks = {
        "preempt_identical": all(runs[k][0] == runs["plain"][0]
                                 for k in ("preempted-cache-off", "preempted-cache-on")),
        "preempted": all(runs[k][1]["preemptions"] >= 1
                         for k in ("preempted-cache-off", "preempted-cache-on")),
        "spec_identical": runs["copy-spec-on"][0] == runs["copy-spec-off"][0],
        "spec_accepted": runs["copy-spec-on"][1]["spec_accepted"] >= 1,
        "no_used_pages": all(r[1]["used_pages"] == 0 for r in runs.values()),
        "kernels": counts["ragged_paged_attention"] > 0
        and counts["paged_decode_attention"] > 0,
    }
    line = {"phase": "serve-runtime-f32", "model": model, "dtype": "float32",
            "tf32": False, "seconds": seconds,
            "runs": {k: {"tokens": len(ids), "first_diff_vs_plain": _first_diff(
                ids, runs["copy-spec-off" if k.startswith("copy") else "plain"][0]), **st}
                     for k, (ids, st) in runs.items()},
            "launches": counts, "checks": checks}
    emit(line)
    report["serve_runtime_f32"] = line
    del params
    if not all(checks.values()):
        raise SystemExit(f"serve-runtime-f32 checks failed: {checks}")


def _get(port, path, user="smoke"):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    c.request("GET", path, headers={"X-User-ID": user})
    r = c.getresponse()
    data = r.read()
    c.close()
    if r.status != 200:
        raise RuntimeError(f"GET {path}: HTTP {r.status} {data[:300]!r}")
    return data


def _post_status(port, body, user):
    """(status, Retry-After, body) of one /api/generate, any status."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    c.request("POST", "/api/generate", json.dumps(body),
              {"X-User-ID": user, "Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, r.getheader("Retry-After"), data


def _parse_prometheus(text):
    """{(name, labels): value} of every sample line; raises on a line that
    does not parse."""
    import re

    pat = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    out = {}
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        m = pat.match(ln)
        if m is None:
            raise SystemExit(f"serve-sched: /metrics line does not parse: {ln!r}")
        out[(m.group(1), m.group(3) or "")] = float(m.group(4))
    return out


def _delta_quantiles(child, before, qs):
    """Quantiles of what a histogram child observed since `before` (its
    bucket counts then), by the registry's own interpolation."""
    from ollamamq_tpu_torch.telemetry.metrics import HistogramChild

    delta = HistogramChild(child.buckets)
    delta.counts = [a - b for a, b in zip(child.counts, before)]
    delta.count = sum(delta.counts)
    return {f"p{int(q * 100)}": delta.quantile(q) for q in qs}


def serve_sched_phase(report) -> None:
    """Scheduling and observability of the fair-share front on the card
    (module docstring, serve-sched). The 503 goes to a third user's
    request: with max_queued 6 and the first user's 3 queued, the second
    user's third request is the sixth and is queued."""
    import torch

    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.core.mqcore import Fairness
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.server.app import OllamaServer
    from ollamamq_tpu_torch.telemetry import mfu, stepprof
    from ollamamq_tpu_torch.telemetry import schema as tm

    model = "llama3.2:1b"
    kind = torch.cuda.get_device_name(0)
    peak = next((p for sub, p in mfu.PEAK_FLOPS_BY_KIND if sub in kind.lower()), None)
    if peak is None:
        raise SystemExit(f"serve-sched: no bf16 peak in the MFU table for {kind!r}")
    gc.collect()
    torch.cuda.empty_cache()
    ecfg = EngineConfig(model=model, max_slots=8, num_pages=8 * 16 + 8, page_size=32,
                        max_pages_per_seq=16, max_batch_tokens=512, token_granule=16,
                        max_new_tokens=160, decode_steps_per_iter=8, dtype="bfloat16",
                        scheduler="srpt", max_queued=6, max_queued_per_user=3, seed=0)
    engine = TorchEngine(ecfg, fairness=Fairness.TOKENS)
    rt = engine.runtimes[model]
    srv = OllamaServer(engine, port=0, timeout_s=600)
    threading.Thread(target=srv.serve_forever, name="http", daemon=True).start()
    port = srv.server_address[1]
    text = "Tell me about fair queues, pages and kernels on a shared card. "
    greedy = {"temperature": 0, "repeat_penalty": 1.0}
    replies, errors, threads = [], [], []

    def run(user, body):
        try:
            ids, why = _ollama_result(*_post(port, "/api/generate", body, user))
            replies.append((user, len(ids), why))
        except Exception as e:  # noqa: BLE001 — reported, then fails the phase
            errors.append(f"{user}: {e}")

    def send(user, max_tokens, prompt):
        """Start one request on its own thread once the caps admit it (the
        client paces itself: nothing else enqueues meanwhile), and return
        when the engine has traced it."""
        body = {"model": model, "prompt": prompt, "stream": False,
                "options": {**greedy, "num_predict": max_tokens}}
        deadline = time.monotonic() + 600
        while (engine.core.total_queued() >= ecfg.max_queued
               or engine.core.queue_len(user) >= ecfg.max_queued_per_user):
            if time.monotonic() > deadline:
                raise SystemExit("serve-sched: the queue never drained")
            time.sleep(0.002)
        n = len(engine.tracer.traces())
        threads.append(threading.Thread(target=run, args=(user, body)))
        threads[-1].start()
        while len(engine.tracer.traces()) == n and not errors:
            time.sleep(0.001)

    # Shedding, with the loop not started: nothing is admitted.
    stepprof.PROFILER.reset()
    ttft = tm.TTFT_MS.labels(model=model)
    tpot = tm.TPOT_MS.labels(model=model)
    ttft0, tpot0 = list(ttft.counts), list(tpot.counts)
    before = _parse_prometheus(_get(port, "/metrics").decode())
    sheds = {}
    for i in range(3):
        send("shed-a", 16, f"{text} (a{i})")
    sheds["user_queue_full"] = _post_status(
        port, {"model": model, "prompt": text, "stream": False}, "shed-a")
    for i in range(3):
        send("shed-b", 16, f"{text} (b{i})")
    queued = engine.core.total_queued()
    sheds["queue_full"] = _post_status(
        port, {"model": model, "prompt": text, "stream": False}, "shed-c")
    reset_launch_counts()
    t0 = time.monotonic()
    engine.start()
    for t in threads:
        t.join(timeout=600)
    # The mix: one user's long requests against four users' short ones.
    threads.clear()
    for i in range(4):
        send("long", 160, f"{text * 3} (long {i})")
        for u in range(4):
            if i < 2:
                send(f"short{u}", 16, f"{text} (short{u} {i})")
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    serve_s = time.monotonic() - t0
    counts = launch_counts()
    engine.health.check_once()  # a watchdog probe on the engine's card
    probe = (str(engine.health.probe_device), engine.health.probes)
    after_text = _get(port, "/metrics").decode()
    after = _parse_prometheus(after_text)
    health = json.loads(_get(port, "/health"))
    prof = json.loads(_get(port, "/debug/stepprof?n=8"))
    hbm = json.loads(_get(port, "/debug/hbm"))
    srv.shutdown()
    srv.server_close()
    engine.stop()
    if errors:
        raise SystemExit(f"serve-sched requests failed: {errors}")

    lab = f'model="{model}"'
    served = len(replies)
    evals = sum(n for _, n, _ in replies)
    per_user = {}
    for user, n, _ in replies:
        per_user[user] = per_user.get(user, 0) + n
    mfu_gauge = after[("ollamamq_mfu", lab)]
    modes = prof["summary"]["modes"]
    phase_ms = {m: {ph: modes[m][ph]["p50_ms"] for ph in stepprof.PHASES}
                for m in ("ragged", "decode") if m in modes}
    last_hbm = next((s for s in reversed(hbm["timeline"]) if "device" in s), None)
    line = {"phase": "serve-sched", "model": model, "layers": rt.cfg.num_layers,
            "scheduler": "srpt", "fairness": "tokens", "max_queued": ecfg.max_queued,
            "max_queued_per_user": ecfg.max_queued_per_user, "queued_before_loop": queued,
            "sheds": {k: {"status": v[0], "retry_after": v[1],
                          "body": json.loads(v[2])} for k, v in sheds.items()},
            "shed_counts": engine.shed_counts, "replies": served,
            "done_reasons": sorted({why for _, _, why in replies}),
            "serve_s": serve_s, "eval_count": evals, "per_user_tokens": per_user,
            "ttft_count_delta": (after[("ollamamq_ttft_ms_count", lab)]
                                 - before.get(("ollamamq_ttft_ms_count", lab), 0.0)),
            "tokens_total_delta": (after[("ollamamq_tokens_generated_total", lab)]
                                   - before.get(("ollamamq_tokens_generated_total", lab), 0.0)),
            "ttft_ms": _delta_quantiles(ttft, ttft0, (0.5, 0.99)),
            "tpot_ms": _delta_quantiles(tpot, tpot0, (0.5,)),
            "mfu": mfu_gauge, "peak_flops": peak, "runtime_peak_flops": rt.peak_flops,
            "step_phase_p50_ms": phase_ms,
            "step_samples": {m: modes[m]["step"]["n"] for m in modes},
            "step_p50_ms": {m: modes[m]["step"]["p50_ms"] for m in modes},
            "hbm_device": last_hbm and last_hbm["device"],
            "param_bytes": rt.param_bytes, "kv_bytes": rt.kv_bytes,
            "health": health["health"], "alerts": health["alerts"],
            "probe_device": probe[0], "probes": probe[1],
            "scheduler_stats": health["scheduler"], "launches": counts}
    emit(line)
    report["serve_sched"] = line
    own = ("ragged_paged_attention", "paged_decode_attention")
    retry_ok = all(v[1] is not None and int(v[1]) >= 1 for v in sheds.values())
    gates = {
        "replies": served == 18 and set(line["done_reasons"]) <= {"stop", "length"},
        "shedding": (sheds["user_queue_full"][0] == 429 and sheds["queue_full"][0] == 503
                     and retry_ok and queued == 6
                     and engine.shed_counts == {"user_queue_full": 1, "queue_full": 1}),
        "ttft_count": line["ttft_count_delta"] == served,
        "tokens_total": line["tokens_total_delta"] == evals,
        "mfu": 0.0 < mfu_gauge <= 1.0 and rt.peak_flops == peak,
        "stepprof": all(m in phase_ms and all(v > 0 for v in phase_ms[m].values())
                        for m in ("ragged", "decode")),
        "hbm": (last_hbm is not None and last_hbm["device"]["allocated_bytes"]
                >= rt.param_bytes + rt.kv_bytes),
        "health": (health["health"]["device_online"] and health["alerts"] == []
                   and health["status"] == "ok" and probe[0].startswith("cuda")
                   and probe[1] >= 1),
        "kernels": all(counts[k] > 0 for k in own)
        and all(counts[k] == 0 for k in counts if k not in own),
    }
    line["gates"] = gates
    if not all(gates.values()):
        raise SystemExit(f"serve-sched gates failed: {gates}")


def _request(port, method, path, body=None, user="smoke", timeout=600):
    """(status, content type, body bytes) of one request, any status."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    c.request(method, path, json.dumps(body) if body is not None else None,
              {"X-User-ID": user, "Content-Type": "application/json"})
    r = c.getresponse()
    data = r.read()
    c.close()
    return r.status, r.getheader("Content-Type"), data


def _cosine(a, b) -> float:
    a, b = [float(x) for x in a], [float(x) for x in b]
    dot = sum(x * y for x, y in zip(a, b))
    return dot / max(1e-30, math.sqrt(sum(x * x for x in a) * sum(y * y for y in b)))


def _params_cpu_f32(params):
    """A params dict's tensors copied to the CPU in float32."""
    return {k: ([{n: t.float().cpu() for n, t in lp.items()} for lp in v]
                if k == "layers" else v.float().cpu()) for k, v in params.items()}


def serve_models_phase(report) -> None:
    """The model lifecycle and the rest of the API surface on the card
    (module docstring, serve-models)."""
    import shutil
    import tempfile

    import torch

    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.engine.engine import TorchEngine
    from ollamamq_tpu_torch.models import llama, weights
    from ollamamq_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from ollamamq_tpu_torch.ops.sampling import SamplingParams
    from ollamamq_tpu_torch.server.app import OllamaServer
    from ollamamq_tpu_torch.telemetry import stepprof

    gen, enc = "llama3.2:1b", "nomic-embed-text"
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.monotonic()
    ecfg = EngineConfig(model=gen, max_slots=4, num_pages=8 * 16 + 8, page_size=32,
                        max_pages_per_seq=16, max_batch_tokens=512, token_granule=16,
                        max_new_tokens=160, decode_steps_per_iter=8, dtype="bfloat16",
                        seed=0)
    engine = TorchEngine(ecfg)
    srv = OllamaServer(engine, port=0, timeout_s=600)
    threading.Thread(target=srv.serve_forever, name="http", daemon=True).start()
    engine.start()
    port = srv.server_address[1]
    gates, line = {}, {"phase": "serve-models", "models": [gen, enc]}

    def ok(path, body=None, method="POST", user="smoke"):
        status, ctype, data = _request(port, method, path, body, user)
        if status != 200:
            raise SystemExit(f"serve-models: {method} {path}: HTTP {status} {data[:300]!r}")
        return json.loads(data) if ctype == "application/json" else data

    try:
        # (a) a streamed pull of the encoder.
        t0 = time.monotonic()
        pulled = [json.loads(x) for x in ok("/api/pull", {"model": enc}).decode().splitlines()]
        line["pull_s"] = time.monotonic() - t0
        line["pull_lines"] = pulled
        rt_gen, rt_enc = engine.runtimes[gen], engine.runtimes[enc]
        tags = {m["name"]: m["size"] for m in ok("/api/tags", method="GET")["models"]}
        ps = {m["name"]: m["size_vram"] for m in ok("/api/ps", method="GET")["models"]}
        sizes = {gen: rt_gen.param_bytes, enc: rt_enc.param_bytes}
        line.update(tags=tags, ps=ps, param_bytes=sizes)
        gates["pull"] = ([x.get("status") for x in pulled][0] == "pulling manifest"
                         and len(pulled) >= 3 and pulled[-1] == {"status": "success"}
                         and tags == sizes and ps == sizes)

        # (b) embeddings while 4 greedy streams saturate the decode slots.
        sentence = "Retrieval indexes embed documents while chat users keep decoding. "
        texts = [(sentence * 5)[:n] for n in (15, 40, 63, 100, 150, 200, 250, 299)]
        replies, errors, stream_end = {}, [], []

        def stream(i):
            try:
                t = time.monotonic()
                data = ok("/api/generate", {"model": gen, "prompt": f"{sentence} ({i})",
                                             "options": {"temperature": 0, "num_predict": 160}},
                          user=f"chat{i}")
                ids, _ = _ollama_result("application/x-ndjson", data)
                stream_end.append((time.monotonic(), t, len(ids)))
            except Exception as e:  # noqa: BLE001 — reported, then fails the phase
                errors.append(f"stream {i}: {e}")

        def embed(name, path, body):
            try:
                out = ok(path, body, user=f"rag-{name}")
                replies[name] = (time.monotonic(), out, engine.runtimes[gen].active_count())
            except Exception as e:  # noqa: BLE001
                errors.append(f"{name}: {e}")

        reset_launch_counts()
        streams = [threading.Thread(target=stream, args=(i,)) for i in range(4)]
        for t in streams:
            t.start()
        deadline = time.monotonic() + 120
        while rt_gen.active_count() < 4 and not errors:
            if time.monotonic() > deadline:
                raise SystemExit("serve-models: the 4 streams never filled the slots")
            time.sleep(0.001)
        saturated = rt_gen.active_count() == 4 and not rt_gen.has_capacity("generate")
        jobs = {f"{gen}/api/embed": ("/api/embed", {"model": gen, "input": texts}),
                f"{enc}/api/embed": ("/api/embed", {"model": enc, "input": texts}),
                f"{enc}/v1/embeddings": ("/v1/embeddings", {"model": enc, "input": texts[3]}),
                f"{gen}/api/embeddings": ("/api/embeddings", {"model": gen, "prompt": texts[5]})}
        workers = [threading.Thread(target=embed, args=(n, *j)) for n, j in jobs.items()]
        for t in workers:
            t.start()
        for t in workers + streams:
            t.join(timeout=600)
        torch.cuda.synchronize()
        window = launch_counts()
        if errors:
            raise SystemExit(f"serve-models requests failed: {errors}")
        vectors = {f"{gen}/api/embed": replies[f"{gen}/api/embed"][1]["embeddings"],
                   f"{enc}/api/embed": replies[f"{enc}/api/embed"][1]["embeddings"],
                   f"{enc}/v1/embeddings": [d["embedding"] for d in
                                            replies[f"{enc}/v1/embeddings"][1]["data"]],
                   f"{gen}/api/embeddings": [replies[f"{gen}/api/embeddings"][1]["embedding"]]}
        dims = {k: sorted({len(v) for v in vs}) for k, vs in vectors.items()}
        norms = [math.sqrt(sum(x * x for x in v)) for vs in vectors.values() for v in vs]
        last_end = max(e for e, _, _ in stream_end)
        own = ("ragged_paged_attention", "paged_decode_attention")
        line.update(decode_saturated=saturated, embed_dims=dims,
                    max_norm_err=max(abs(n - 1) for n in norms),
                    stream_tokens=[n for _, _, n in stream_end],
                    embed_reply_before_last_stream_end_s={
                        k: last_end - t for k, (t, _, _) in replies.items()},
                    active_slots_at_reply={k: a for k, (_, _, a) in replies.items()},
                    launches=window)
        gates["saturated"] = saturated
        gates["dims"] = all(d == [2048 if k.startswith(gen) else 768] for k, d in dims.items())
        gates["norms"] = line["max_norm_err"] <= 1e-3
        gates["during_decode"] = all(t < last_end for t, _, _ in replies.values())
        gates["window_kernels"] = (all(window[k] > 0 for k in own)
                                   and all(window[k] == 0 for k in window if k not in own))

        # The embed-only sub-window: the 8 inputs per model, 3 times; the
        # step profiler's embed samples of 8 padded rows at length 512
        # time one batch (a request set may split across dispatches).
        reset_launch_counts()
        embed_ms, embed_http_ms = {}, {}
        for name in (gen, enc):
            w0, http_runs = time.time(), []
            for _ in range(3):
                t0 = time.monotonic()
                ok("/api/embed", {"model": name, "input": texts})
                http_runs.append((time.monotonic() - t0) * 1e3)
            full = sorted(x["total_ms"] for x in stepprof.PROFILER.window(w0, time.time())
                          if x["mode"] == "embed" and x["padded_tokens"] == 8 * 512)
            embed_ms[name] = full[len(full) // 2] if full else None
            embed_http_ms[name] = sorted(http_runs)[1]
        torch.cuda.synchronize()
        sub = launch_counts()
        line.update(embed_ms_per_batch=embed_ms, embed_http_ms_per_batch=embed_http_ms,
                    embed_only_launches=sub)
        gates["embed_only_kernels"] = all(v == 0 for v in sub.values())

        # (c) alone vs in the batch; the card's encoder vs the CPU's.
        lone = {name: ok("/api/embed", {"model": name, "input": texts[0]})["embeddings"][0]
                for name in (gen, enc)}
        cos_lone = {name: _cosine(lone[name], vectors[f"{name}/api/embed"][0])
                    for name in (gen, enc)}
        cpu_params = _params_cpu_f32(rt_enc.params)
        toks = [rt_enc.tokenizer.encode(t) for t in texts]
        T = 32
        while T < max(map(len, toks)):
            T *= 2
        tok_cpu = torch.zeros((len(toks), T), dtype=torch.int32)
        for i, t in enumerate(toks):
            tok_cpu[i, :len(t)] = torch.tensor(t, dtype=torch.int32)
        t0 = time.monotonic()
        with torch.no_grad():
            ref = llama.forward_encoder(cpu_params, rt_enc.cfg, tok_cpu,
                                        torch.tensor([len(t) for t in toks]))
        cpu_s = time.monotonic() - t0
        del cpu_params
        cos_cpu = [_cosine(v, r.tolist()) for v, r in zip(vectors[f"{enc}/api/embed"], ref)]
        line.update(cosine_lone_vs_batch=cos_lone, cosine_card_vs_cpu_f32_min=min(cos_cpu),
                    cpu_reference_s=cpu_s)
        gates["lone_vs_batch"] = all(c >= 0.999 for c in cos_lone.values())
        gates["card_vs_cpu"] = min(cos_cpu) >= 0.995

        # (d) deleting a busy model: with the loop stopped, an embed is
        # placed on the encoder's queue by one admission pass.
        engine.stop()
        busy = {}
        waiter = threading.Thread(target=lambda: busy.update(
            reply=_request(port, "POST", "/api/embed", {"model": enc, "input": texts[1]},
                           "busy")))
        waiter.start()
        deadline = time.monotonic() + 60
        while engine.core.total_queued() == 0:
            if time.monotonic() > deadline:
                raise SystemExit("serve-models: the busy embed was never queued")
            time.sleep(0.001)
        engine._admit()
        held = rt_enc.has_work()
        busy_delete = _request(port, "POST", "/api/delete", {"model": enc})
        engine.start()
        waiter.join(timeout=120)
        line.update(busy_delete={"status": busy_delete[0],
                                 "body": json.loads(busy_delete[2])},
                    busy_embed_status=busy.get("reply", (None,))[0])
        gates["busy_409"] = (held and busy_delete[0] == 409
                             and busy.get("reply", (None,))[0] == 200)

        # (e) deleting the idle encoder frees its weights; a re-pull
        # brings back bit-identical embeddings.
        enc_bytes = rt_enc.param_bytes
        del rt_enc
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        deleted = _request(port, "POST", "/api/delete", {"model": enc})
        gc.collect()
        torch.cuda.synchronize()
        freed = before - torch.cuda.memory_allocated()
        gone = _request(port, "POST", "/api/embed", {"model": enc, "input": texts[0]})
        t0 = time.monotonic()
        ok("/api/pull", {"model": enc, "stream": False})
        repull_s = time.monotonic() - t0
        again = ok("/api/embed", {"model": enc, "input": texts[0]})["embeddings"][0]
        line.update(delete_status=deleted[0], freed_bytes=freed, encoder_param_bytes=enc_bytes,
                    embed_after_delete_status=gone[0], repull_s=repull_s,
                    repull_bit_identical=again == lone[enc])
        gates["delete"] = deleted[0] == 200 and gone[0] == 404
        gates["freed"] = freed >= 0.95 * enc_bytes
        gates["repull_identical"] = again == lone[enc]

        # (g) the other routes.
        root = _request(port, "GET", "/")
        show = ok("/api/show", {"model": gen})
        version = ok("/api/version", method="GET")
        models = ok("/v1/models", method="GET")
        one = ok("/v1/models/" + gen, method="GET")
        cmpl = ok("/v1/completions", {"model": gen, "prompt": sentence, "max_tokens": 8,
                                      "temperature": 0})
        sse = ok("/v1/completions", {"model": gen, "prompt": sentence, "max_tokens": 8,
                                     "temperature": 0, "stream": True}).decode()
        events = [x[len("data: "):] for x in sse.split("\n\n") if x.startswith("data: ")]
        chunks = [json.loads(x) for x in events[:-1]]
        honest = {p: _request(port, "POST", p, {})[0]
                  for p in ("/api/create", "/api/push", "/api/blobs/x")}
        routes = {
            "root": root[0] == 200 and root[2] == b"Ollama is running",
            "show": ({"modelfile", "parameters", "template", "details", "model_info"}
                     <= set(show) and show["model_info"]["llama.embedding_length"] == 2048),
            "version": isinstance(version.get("version"), str),
            "v1_models": (models["object"] == "list"
                          and {m["id"] for m in models["data"]} == {gen, enc}),
            "v1_model": one["id"] == gen and one["object"] == "model",
            "completions": (cmpl["object"] == "text_completion"
                            and cmpl["choices"][0]["finish_reason"] in ("stop", "length")
                            and cmpl["usage"]["completion_tokens"] > 0),
            # Random weights mostly pick ids outside the byte tokenizer's
            # range, which stream no text: the finish chunk may stand alone.
            "completions_sse": (events[-1] == "[DONE]" and len(chunks) >= 1
                                and all(c["object"] == "text_completion"
                                        and "text" in c["choices"][0] for c in chunks)
                                and chunks[-1]["choices"][0]["finish_reason"]
                                in ("stop", "length")),
            "honest_501": set(honest.values()) == {501},
        }
        line["routes"] = routes
        gates["routes"] = all(routes.values())

        # (f) a safetensors checkpoint of the generative model.
        prompts = [f"{sentence} (checkpoint {i})" for i in range(2)]

        def greedy_ids(eng):
            out = []
            for prompt in prompts:
                rt = eng.runtimes[gen]
                req = eng.enqueue_request("ckpt", "", gen, prompt_tokens=rt.tokenizer.encode(prompt),
                                          sampling=SamplingParams(max_tokens=32))
                items = _collect(req)
                if items[-1].kind != "done":
                    raise SystemExit(f"serve-models checkpoint stream: {items[-1]}")
                out.append(list(req.generated_ids))
            return out

        seeded = greedy_ids(engine)
        tmp = tempfile.mkdtemp(prefix="ollamamq-ckpt-")
        try:
            t0 = time.monotonic()
            path = weights.save_safetensors(rt_gen.params, rt_gen.cfg, tmp)
            write_s = time.monotonic() - t0
            file_bytes = os.path.getsize(path)
            t0 = time.monotonic()
            eng2 = TorchEngine(ecfg, models={gen: tmp})
            torch.cuda.synchronize()
            load_s = time.monotonic() - t0
            eng2.start()
            try:
                loaded = greedy_ids(eng2)
            finally:
                eng2.stop()
                del eng2
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        line.update(checkpoint_write_s=write_s, checkpoint_load_s=load_s,
                    checkpoint_bytes=file_bytes, checkpoint_tokens=[len(x) for x in loaded],
                    checkpoint_ids_identical=loaded == seeded, checkpoint_dir_removed=not
                    os.path.exists(tmp))
        gates["checkpoint"] = (loaded == seeded and all(len(x) > 0 for x in loaded)
                               and not os.path.exists(tmp))
    finally:
        srv.shutdown()
        srv.server_close()
        engine.stop()
    line["seconds"] = time.monotonic() - t_phase
    line["gates"] = gates
    emit(line)
    report["serve_models"] = line
    emit({"phase": "serve-models-numbers",
          "embed_ms_per_batch": line["embed_ms_per_batch"], "pull_s": line["pull_s"],
          "freed_bytes": line["freed_bytes"],
          "checkpoint_write_s": line["checkpoint_write_s"],
          "checkpoint_load_s": line["checkpoint_load_s"]})
    if not all(gates.values()):
        raise SystemExit(f"serve-models gates failed: {gates}")


def guardrail_phase(report) -> None:
    """quant_guardrail of the int8 llama3.2:1b tree against its bf16
    source (seeded random weights) at full width on the card. The bound on
    random weights is unknown: printed, not gated."""
    import torch

    from ollamamq_tpu_torch.config import get_model_config
    from ollamamq_tpu_torch.models import weights

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    out = weights.quant_guardrail(get_model_config("llama3.2:1b"), seed=0,
                                  dtype=torch.bfloat16, device="cuda")
    line = {"phase": "quant-guardrail", "model": "llama3.2:1b", "gated": False,
            "seconds": time.monotonic() - t0, **out}
    emit(line)
    report["quant_guardrail"] = line
    if not all(math.isfinite(out[k]) for k in ("max_logit_err", "rel_logit_err")):
        raise SystemExit(f"guardrail logits are not finite: {line}")


def profile_window(port, model, text, rt):
    """torch.profiler over one more 4-user burst: device time by kernel
    name, the device-busy share of the window's wall time, and the
    engine dispatches the window ran. The same greedy burst runs twice on
    the warm engine: unprofiled for its wall time (the profiler slows the
    host several-fold), then profiled for device time, so the busy share
    is the profiled device time over the unprofiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    body = {"model": model, "prompt": text, "stream": False,
            "options": {"temperature": 0, "num_predict": 48}}
    keys = ("ragged_dispatches", "decode_dispatches", "decode_steps", "tokens_generated")

    def burst():
        errors = []

        def one(user):
            try:
                _post(port, "/api/generate", body, user)
            except Exception as e:  # noqa: BLE001 — reported, then fails the window
                errors.append(f"{user}: {e}")

        before = rt.stats()
        t0 = time.monotonic()
        threads = [threading.Thread(target=one, args=(f"p{i}",)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        after = rt.stats()
        if errors or any(t.is_alive() for t in threads):
            raise SystemExit(f"profile burst failed: {errors}")
        return (time.monotonic() - t0) * 1e3, {k: after[k] - before[k] for k in keys}

    wall_ms, counts = burst()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall_ms, profiled_counts = burst()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    os.makedirs(OUT_DIR, exist_ok=True)
    trace = os.path.join(OUT_DIR, f"serve_trace_{rt.weights_dtype}.json")
    prof.export_chrome_trace(trace)
    with open(trace, "rb") as src, gzip.open(trace + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(trace)
    groups = {"attention kernels": ("paged_decode_", "ragged_paged_kernel"),
              "gemm": ("gemm", "nvjet", "sm90_xmma", "cutlass"),
              "copy / cast": ("copy",)}
    by_group = {g: 0.0 for g in (*groups, "other")}
    for us, key, _n in rows:
        g = next((g for g, pats in groups.items() if any(p in key for p in pats)), "other")
        by_group[g] += us / 1e3
    # The serving path's own attention kernels must show up by name (a
    # renamed kernel would otherwise be counted under "other").
    expected = {"decode_steps": ("paged_decode_split_kernel", "paged_decode_combine_kernel"),
                "ragged_dispatches": ("ragged_paged_kernel_tc",)}
    attention = {name: {"ms": sum(us for us, k, _ in rows if name in k) / 1e3,
                        "calls": sum(n for _, k, n in rows if name in k)}
                 for names in expected.values() for name in names}
    missing = [name for key, names in expected.items() if profiled_counts[key] > 0
               for name in names if attention[name]["calls"] == 0]
    if missing:
        raise SystemExit(f"profile: the window ran {profiled_counts} but found no "
                         f"device time of {missing}")
    # A forward is one decode step or one ragged dispatch. Arrival timing
    # may split the two bursts' prefills differently, so each burst is
    # divided by its own count.
    wall_fwd = wall_ms / (counts["decode_steps"] + counts["ragged_dispatches"])
    dev_fwd = total_us / 1e3 / (profiled_counts["decode_steps"]
                                + profiled_counts["ragged_dispatches"])
    return {"wall_ms": wall_ms, **counts, "profiled_wall_ms": profiled_wall_ms,
            "profiled_counts": profiled_counts,
            "device_kernel_ms": total_us / 1e3,
            "wall_ms_per_forward": wall_fwd,
            "device_ms_per_forward": dev_fwd,
            "device_busy_share": dev_fwd / wall_fwd,
            "device_ms_by_group": by_group,
            "attention_kernels": attention,
            "top": [{"name": k[:90], "ms": us / 1e3, "calls": n}
                    for us, k, n in rows[:15]]}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a serving burst of each serve phase "
                         "(chiprun_out/chip_smoke/)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "ollamamq_tpu_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    from ollamamq_tpu_torch.ops.cuda import build

    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0), "kernels": [],
              "decode_plan": []}
    t0 = time.monotonic()
    built = build.build()
    for name in build.KERNELS:  # every entry point loads from its library
        build.kernel_fn(name)
    line = {"phase": "build", "seconds": time.monotonic() - t0,
            "entry_points": list(build.KERNELS),
            "sources": {src: {"seconds": b["seconds"], "cached": b["cached"],
                              "entry_points": b["entry_points"],
                              "ptxas": [ln.strip() for ln in b["log"].splitlines()
                                        if "registers" in ln]}
                        for src, b in built.items()}}
    emit(line)
    report["build"] = line

    decode_plan_phase(report)
    kernel_phase(report)
    serve_phase(report, args.profile)
    serve_phase(report, args.profile, int8=True)
    guardrail_phase(report)
    serve_runtime_phase(report)
    serve_runtime_f32_phase(report)
    serve_sched_phase(report)
    serve_models_phase(report)

    card = card_line()
    s = report["kernel_summary"]
    kernels = []
    for name, (source, replaces, serve) in KERNEL_ROWS.items():
        m = s[name]["llama3.2:1b"]
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": report[serve]["launches"][name],
               "max_abs_err": m["max_abs_err"], "ms": m["kernel_ms"],
               "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
               "bound_by": m["bound_by"], "library_ms": m["sdpa_dense_ms"]}
        if name.endswith("_int8"):
            row["variant"] = "quantized=True"
        kernels.append(row)
    report["card"] = card
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
