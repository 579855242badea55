"""The plain reference against the port's own plain path on a tiny
configuration, on the CPU in float32: one forward_ragged over a whole
sequence (every position's logits) with the plain attention, the same
weights, and an MoE capacity that drops no token."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from servebench import reference, spec, weights
from servebench.tests import tiny


def _port_logits(a, conf, params, ids):
    from ollamamq_tpu_torch.config import EngineConfig
    from ollamamq_tpu_torch.engine import kv_cache as kvc
    from ollamamq_tpu_torch.models import llama
    from servebench.system import model_config

    cfg = model_config("tiny", conf, a)
    if a["E"]:  # capacity E / K: every token reaches its experts
        cfg = dataclasses.replace(cfg, moe_capacity_factor=a["E"] / a["K"])
    T, ps = len(ids), 16
    pages = -(-T // ps)
    ecfg = EngineConfig(model="tiny", num_pages=pages + 1, page_size=ps,
                        max_pages_per_seq=pages)
    kc, vc = kvc.alloc_kv_pool(cfg, ecfg, torch.float32, "cpu")
    pos = torch.arange(T, dtype=torch.int32)
    pt = torch.arange(1, pages + 1, dtype=torch.int32)[None, :]
    logits, _, _ = llama.forward_ragged(
        params, cfg, torch.tensor(ids, dtype=torch.int32),
        torch.zeros(T, dtype=torch.int32), pos, (pt[0, pos // ps] * ps + pos % ps).long(),
        torch.arange(T)[None, :], kc, vc, pt, torch.tensor([0], dtype=torch.int32),
        torch.tensor([T], dtype=torch.int32), torch.tensor([T], dtype=torch.int32),
        ps, attn_impl="plain")
    return logits[0]


@pytest.mark.parametrize("moe", [False, True], ids=["qwen3-tiny", "mixtral-tiny"])
def test_reference_matches_the_port_plain_path(moe):
    conf = tiny.conf(moe)
    a = spec.arch(conf)
    seed = 2 ** 35 + 17
    params = weights.params(a, seed, torch.float32, "cpu")
    ids = torch.randint(3, a["V"], (70,), generator=torch.Generator().manual_seed(1)).tolist()
    port = _port_logits(a, conf, params, ids)
    tops = weights.top_shapes(a)
    ref = reference.logits(
        a, lambda n: weights.make(seed, n, tops[n], torch.float32, "cpu"),
        weights.served_layers(a, seed, torch.float32, "cpu"), [ids],
        [range(len(ids))])[0]
    assert port.shape == ref.shape
    err = (port - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err
    assert torch.equal(port.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("quant", ["int8", "fp8"])
def test_low_precision_reference_moves_the_logits(quant):
    """The control's rounding moves the logits, by far less than their
    scale."""
    conf = tiny.conf(False)
    a = spec.arch(conf)
    tops = weights.top_shapes(a)
    ids = list(range(3, 60))

    def run(quant):
        return reference.logits(
            a, lambda n: weights.make(3, n, tops[n], torch.bfloat16, "cpu"),
            weights.served_layers(a, 3, torch.bfloat16, "cpu"), [ids],
            [range(len(ids))], quant=quant)[0]

    full, low = run(None), run(quant)
    diff = (full - low).abs().max().item()
    assert 1e-4 < diff < 0.2 * full.abs().max().item()


def test_weights_repeat_and_stand_alone():
    a = spec.arch(tiny.conf(True))
    whole = weights.params(a, 42, torch.bfloat16, "cpu")
    alone = weights.layer(a, 42, 1, torch.bfloat16, "cpu")
    for k, t in alone.items():
        assert torch.equal(whole["layers"][1][k], t)
    other = weights.params(a, 43, torch.bfloat16, "cpu")
    assert not torch.equal(whole["embed"], other["embed"])
    n = sum(t.numel() for t in whole["layers"][0].values()) * a["L"]
    n += sum(whole[k].numel() for k in ("embed", "final_norm", "lm_head"))
    assert weights.nbytes(a) == 2 * n


def test_mixtral_16_layers_weight_bytes():
    """The configuration kept for a later Mixtral cell weighs serve-moe's
    46,964,940,800 bytes."""
    a = spec.arch(spec.load_json(f"{spec.HERE}/configs/mixtral-8x7b-16l.json"))
    assert weights.nbytes(a) == 46_964_940_800
