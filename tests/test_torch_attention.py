"""The PyTorch port's plain paged-attention versions against the JAX
package's Pallas kernels (interpret mode on the CPU), on the cases the
kernels' own tests use, plus stream padding rows.

The port's CUDA kernels implement exactly these plain versions; they are
held against them on the card by chip_smoke.py. Tolerance: rtol = atol
= 2e-5 in float32, as the Pallas kernels' own tests use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.ops.pallas.paged_attention import paged_decode_attention_pallas
from ollamamq_tpu.ops.pallas.ragged_attention import ragged_paged_attention_pallas
from ollamamq_tpu_torch.ops import attention as tatt
from ollamamq_tpu_torch.ops.cuda.paged_attention import SPLIT, paged_decode_attention_cuda
from ollamamq_tpu_torch.ops.cuda.ragged_attention import ragged_paged_attention_cuda

TOL = dict(rtol=2e-5, atol=2e-5)


def _decode_case(B, H, Hk, hd, PS, MP, seq_lens, seed=0):
    rng = np.random.default_rng(seed)
    S = (MP * B + 2) * PS
    q = rng.normal(size=(B, H, hd)).astype(np.float32)
    k = rng.normal(size=(S, Hk, hd)).astype(np.float32)
    v = rng.normal(size=(S, Hk, hd)).astype(np.float32)
    pt = np.zeros((B, MP), np.int32)
    nxt = 1
    for b, L in enumerate(seq_lens):
        need = -(-L // PS)
        pt[b, :need] = range(nxt, nxt + need)
        nxt += need
    return q, k, v, pt, np.asarray(seq_lens, np.int32)


# Contexts around the CUDA kernel's split of SPLIT positions (one split,
# two, three) at two page sizes.
_EDGES = [SPLIT - 1, SPLIT, SPLIT + 1, 2 * SPLIT + 3]

DECODE_CASES = {
    "gqa-a": dict(B=3, H=8, Hk=4, hd=32, PS=8, MP=6, seq_lens=[20, 9, 37]),
    "gqa-b": dict(B=3, H=8, Hk=4, hd=32, PS=8, MP=6, seq_lens=[1, 48, 16]),
    "mqa": dict(B=2, H=4, Hk=1, hd=16, PS=8, MP=4, seq_lens=[8, 25]),
    "split-edges-ps8": dict(B=4, H=4, Hk=2, hd=16, PS=8, MP=-(-_EDGES[-1] // 8),
                            seq_lens=_EDGES),
    "split-edges-ps16": dict(B=4, H=4, Hk=2, hd=16, PS=16, MP=-(-_EDGES[-1] // 16),
                             seq_lens=_EDGES),
    # The GQA groups of llama3.2:3b (3) and qwen2.5:7b (7) at head dim 128.
    "group3-hd128": dict(B=3, H=6, Hk=2, hd=128, PS=16, MP=-(-(SPLIT + 9) // 16),
                         seq_lens=[5, SPLIT + 9, 40]),
    "group7-hd128": dict(B=2, H=7, Hk=1, hd=128, PS=16, MP=-(-(SPLIT + 1) // 16),
                         seq_lens=[SPLIT + 1, 33]),
}


@pytest.mark.parametrize("case", list(DECODE_CASES.values()), ids=list(DECODE_CASES))
def test_plain_decode_matches_pallas(case):
    q, k, v, pt, sl = _decode_case(**case)
    PS = case["PS"]
    ref = paged_decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(sl), PS, interpret=True)
    args = [torch.from_numpy(a) for a in (q, k, v, pt, sl)]
    out = tatt.paged_decode_attention(*args, PS)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # The kernel wrapper on a CPU tensor IS the plain version.
    np.testing.assert_array_equal(
        paged_decode_attention_cuda(*args, PS).numpy(), out.numpy())


def test_plain_decode_zero_length_row_is_zero():
    q, k, v, pt, sl = _decode_case(3, 8, 4, 32, 8, 6, [20, 0, 9])
    k[:] = np.nan  # stale pool data must never reach a masked sum
    k[pt[0, :3].repeat(8) * 8 + np.tile(np.arange(8), 3)] = 1.0
    k[pt[2, :2].repeat(8) * 8 + np.tile(np.arange(8), 2)] = 1.0
    out = tatt.paged_decode_attention(
        *[torch.from_numpy(a) for a in (q, k, v, pt, sl)], 8).numpy()
    assert np.all(out[1] == 0.0)
    assert np.all(np.isfinite(out))


def _ragged_case(spans, B=10, PS=8, MP=8, Hk=2, H=4, hd=16, seed=0, T=40):
    """spans = [(q_len, kv_len), ...] contiguous in stream order; rows of
    B past the spans are padding sequences, and the stream rows past the
    spans (up to T) are covered by no span. Every case shares T and B, so
    the interpret-mode Pallas kernel compiles once per head layout."""
    rng = np.random.default_rng(seed)
    S = (MP * B + 2) * PS
    q = rng.normal(size=(T, H, hd)).astype(np.float32)
    k = rng.normal(size=(S, Hk, hd)).astype(np.float32)
    v = rng.normal(size=(S, Hk, hd)).astype(np.float32)
    pt = np.zeros((B, MP), np.int32)
    nxt = 1
    q_start = np.full(B, T, np.int32)
    q_len = np.zeros(B, np.int32)
    kv_len = np.zeros(B, np.int32)
    tok_seq = np.zeros(T, np.int32)
    tok_pos = np.full(T, -1, np.int32)
    off = 0
    for i, (ql, kv) in enumerate(spans):
        need = -(-kv // PS)
        pt[i, :need] = range(nxt, nxt + need)
        nxt += need
        q_start[i], q_len[i], kv_len[i] = off, ql, kv
        tok_seq[off:off + ql] = i
        tok_pos[off:off + ql] = np.arange(kv - ql, kv)
        off += ql
    return dict(q=q, k=k, v=v, pt=pt, tok_seq=tok_seq, tok_pos=tok_pos,
                kv_len=kv_len, q_start=q_start, q_len=q_len, PS=PS)


RAGGED_CASES = {
    # The MIXED_CASES of the Pallas kernel's own test (there with B 6, 10,
    # 6 and no stream padding; here padded to the shared T and B).
    "mixed-prefill-decode": dict(spans=[(11, 11), (1, 20), (5, 29), (1, 1)]),
    "decode-tile": dict(spans=[(1, 5 + 3 * i) for i in range(9)]),
    "long-prefill": dict(spans=[(21, 21), (1, 9), (1, 17), (3, 30)]),
    "group1": dict(spans=[(6, 6), (1, 12)], Hk=4, H=4, seed=2),
    # Edges of the CUDA kernel's query tiling: a span that starts mid-page
    # after 34 positions of prior context, and the GQA groups of
    # llama3.2:3b (3) and qwen2.5:7b (7) at a small head dim.
    "mid-page": dict(spans=[(27, 61), (1, 13), (5, 21)], seed=3),
    "group3": dict(spans=[(13, 13), (1, 30), (9, 40)], Hk=2, H=6, seed=4),
    "group7": dict(spans=[(10, 10), (1, 25), (9, 33)], Hk=1, H=7, seed=5),
}


@pytest.mark.parametrize("name", list(RAGGED_CASES))
def test_plain_ragged_matches_pallas(name):
    check_ragged_case(_ragged_case(**RAGGED_CASES[name]))


def check_ragged_case(c):
    """The plain ragged version (and the kernel wrapper's CPU path) against
    the interpret-mode Pallas kernel on one case from _ragged_case."""
    ref = np.asarray(ragged_paged_attention_pallas(
        *[jnp.asarray(c[n]) for n in ("q", "k", "v", "pt", "q_start",
                                      "q_len", "kv_len")],
        c["PS"], interpret=True))
    t = {n: torch.from_numpy(a) for n, a in c.items() if n != "PS"}
    out = tatt.ragged_paged_attention(
        t["q"], t["k"], t["v"], t["pt"], t["tok_seq"], t["tok_pos"],
        t["kv_len"], c["PS"]).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    pad_rows = c["tok_pos"] < 0
    assert np.all(out[pad_rows] == 0.0)  # rows no span covers: exact zeros
    assert np.all(ref[pad_rows] == 0.0)
    # Span metadata -> per-token metadata, and the wrapper's CPU path.
    seq, pos = tatt.ragged_tokens(t["q_start"], t["q_len"], t["kv_len"],
                                  out.shape[0])
    np.testing.assert_array_equal(pos.numpy(), c["tok_pos"])
    np.testing.assert_array_equal(seq.numpy()[~pad_rows], c["tok_seq"][~pad_rows])
    via_wrapper = ragged_paged_attention_cuda(
        t["q"], t["k"], t["v"], t["pt"], t["q_start"], t["q_len"],
        t["kv_len"], c["PS"]).numpy()
    np.testing.assert_array_equal(via_wrapper, out)
