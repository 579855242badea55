"""The port's plain int8-pool attention against the JAX package's int8
Pallas kernels (quantized=True, interpret mode on the CPU).

Inputs follow tests/test_quantization.py's _mixed_stream: K/V rows drawn
with numpy and quantized by JAX's kv_quantize (the port's equals it, see
test_torch_quant.py), a three-sequence stream of a 10-token prefill, a
decode row and a 5-token span over paged contexts. Cases: the JAX test's
GQA layout, MQA (one kv head) and group 1 (as many kv heads as query
heads). Tolerance rtol 1e-4, atol 1e-5, as the JAX test holds its
kernels to the jnp reference. The port's CUDA int8 kernels implement
these plain versions and are held against them on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollamamq_tpu.ops import quant as jq
from ollamamq_tpu.ops.pallas.paged_attention import paged_decode_attention_pallas
from ollamamq_tpu.ops.pallas.ragged_attention import ragged_paged_attention_pallas
from ollamamq_tpu_torch.ops import attention as tatt
from ollamamq_tpu_torch.ops.cuda import paged_attention as pa
from ollamamq_tpu_torch.ops.cuda import ragged_attention as ra
from ollamamq_tpu_torch.ops.quant import QuantKV

TOL = dict(rtol=1e-4, atol=1e-5)
PS, MP, S = 8, 8, 160
# (q_start, q_len, kv_len) per sequence, contiguous in stream order.
SPANS = [(0, 10, 26), (10, 1, 11), (11, 5, 17)]
LAYOUTS = {"gqa": (2, 4), "mqa": (1, 4), "group1": (4, 4)}  # (Hk, H)


def _case(Hk, H, hd=16, seed=4):
    rng = np.random.default_rng(seed)
    kq, ks = jq.kv_quantize(jnp.asarray(rng.normal(size=(S, Hk, hd)).astype(np.float32)))
    vq, vs = jq.kv_quantize(jnp.asarray(rng.normal(size=(S, Hk, hd)).astype(np.float32)))
    pt = np.zeros((3, MP), np.int32)
    pt[0, :4] = [1, 2, 3, 4]
    pt[1, :2] = [5, 6]
    pt[2, :3] = [7, 8, 9]
    tok_seq = np.concatenate([np.full(ql, s, np.int32) for s, (_, ql, _) in enumerate(SPANS)])
    tok_pos = np.concatenate([np.arange(kv - ql, kv, dtype=np.int32) for _, ql, kv in SPANS])
    T = len(tok_pos)
    return dict(
        pools=tuple(np.asarray(a) for a in (kq, ks, vq, vs)),
        pt=pt, q_start=np.array([s[0] for s in SPANS], np.int32),
        q_len=np.array([s[1] for s in SPANS], np.int32),
        kv_len=np.array([s[2] for s in SPANS], np.int32),
        tok_seq=tok_seq, tok_pos=tok_pos,
        q_ragged=rng.normal(size=(T, H, hd)).astype(np.float32),
        q_decode=rng.normal(size=(3, H, hd)).astype(np.float32))


def _torch_pools(c):
    kq, ks, vq, vs = (torch.from_numpy(np.array(a)) for a in c["pools"])
    return QuantKV(kq, ks), QuantKV(vq, vs)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_int8_ragged_matches_pallas(layout):
    c = _case(*LAYOUTS[layout])
    kq, ks, vq, vs = (jnp.asarray(a) for a in c["pools"])
    ref = np.asarray(ragged_paged_attention_pallas(
        jnp.asarray(c["q_ragged"]), kq, vq, jnp.asarray(c["pt"]),
        jnp.asarray(c["q_start"]), jnp.asarray(c["q_len"]), jnp.asarray(c["kv_len"]),
        PS, interpret=True, k_scale=ks, v_scale=vs))
    kc, vc = _torch_pools(c)
    out = tatt.ragged_paged_attention(
        _t(c["q_ragged"]), kc, vc, _t(c["pt"]), _t(c["tok_seq"]), _t(c["tok_pos"]),
        _t(c["kv_len"]), PS).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    # The int8 kernel's wrapper on CPU tensors IS the plain version.
    via_wrapper = ra.ragged_paged_attention_int8_cuda(
        _t(c["q_ragged"]), kc, vc, _t(c["pt"]), _t(c["q_start"]), _t(c["q_len"]),
        _t(c["kv_len"]), PS).numpy()
    np.testing.assert_array_equal(via_wrapper, out)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_int8_decode_matches_pallas(layout):
    c = _case(*LAYOUTS[layout], seed=5)
    kq, ks, vq, vs = (jnp.asarray(a) for a in c["pools"])
    ref = np.asarray(paged_decode_attention_pallas(
        jnp.asarray(c["q_decode"]), kq, vq, jnp.asarray(c["pt"]),
        jnp.asarray(c["kv_len"]), PS, interpret=True, k_scale=ks, v_scale=vs))
    kc, vc = _torch_pools(c)
    args = (_t(c["q_decode"]), kc, vc, _t(c["pt"]), _t(c["kv_len"]), PS)
    out = tatt.paged_decode_attention(*args).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_array_equal(pa.paged_decode_attention_int8_cuda(*args).numpy(), out)


def test_plain_int8_never_reads_stale_slots():
    """Slots past every row's frontier hold payload 127 and a NaN scale
    (an int8 payload cannot hold NaN): the plain versions' output is
    finite and equals the output over a clean pool."""
    c = _case(2, 4)
    kc, vc = _torch_pools(c)
    dirty_k, dirty_v = (QuantKV(p.q.clone(), p.s.clone()) for p in (kc, vc))
    readable = np.zeros(S, bool)
    for s, (_, _, kv) in enumerate(SPANS):
        pos = np.arange(kv)
        readable[c["pt"][s][pos // PS] * PS + pos % PS] = True
    stale = torch.from_numpy(~readable)
    for p in (dirty_k, dirty_v):
        p.q[stale] = 127
        p.s[stale] = float("nan")
    for q, run in (
            (c["q_ragged"], lambda q, k, v: tatt.ragged_paged_attention(
                q, k, v, _t(c["pt"]), _t(c["tok_seq"]), _t(c["tok_pos"]),
                _t(c["kv_len"]), PS)),
            (c["q_decode"], lambda q, k, v: tatt.paged_decode_attention(
                q, k, v, _t(c["pt"]), _t(c["kv_len"]), PS))):
        clean = run(_t(q), kc, vc)
        dirty = run(_t(q), dirty_k, dirty_v)
        assert bool(torch.isfinite(dirty).all())
        assert torch.equal(dirty, clean)


def test_dispatch_routes_quant_pools_to_int8_kernels(monkeypatch):
    """ragged_attention_any / paged_decode_attention_any send a QuantKV
    pool to the int8-pool kernel wrappers and a plain pool to the
    others, mirroring the JAX package's dispatch."""
    calls = []
    for mod in (pa, ra):
        for name in dir(mod):
            if name.endswith("_cuda"):
                monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: calls.append(_n))
    c = _case(2, 4)
    kc, vc = _torch_pools(c)
    for pools in ((kc, vc), (kc.q.float(), vc.q.float())):
        tatt.ragged_attention_any("kernel", _t(c["q_ragged"]), *pools, _t(c["pt"]),
                                  _t(c["tok_seq"]), _t(c["tok_pos"]), _t(c["kv_len"]),
                                  _t(c["q_start"]), _t(c["q_len"]), PS)
        tatt.paged_decode_attention_any("kernel", _t(c["q_decode"]), *pools, _t(c["pt"]),
                                        _t(c["kv_len"]), PS)
    assert calls == ["ragged_paged_attention_int8_cuda", "paged_decode_attention_int8_cuda",
                     "ragged_paged_attention_cuda", "paged_decode_attention_cuda"]
