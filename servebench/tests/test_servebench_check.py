"""The served-token check on tiny cells on the CPU: a sound run is
correct; a run whose timed path is broken underneath is not, once for
each fault a one-chip serving cell can have (the KV state left as it
was, half of the batch's rows given the other half's logits, a token
altered where it is sampled); and the controls read worse than the
program. The harness runs whole (cell.run), without its look for a card.
The same controls at the cells' own sizes run on the card
(test_controls_on_the_card, marked chip)."""

from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest
import torch

from servebench import cell as cellrun
from servebench import check, control, spec
from servebench.tests import tiny

SEED = 2 ** 32 + 77


def _run(moe: bool, rate: float = 2.0, **kw):
    c = tiny.cell(moe, rate)
    return cellrun.run(c, SEED, 4.0, False, "cpu", time.monotonic(), c.limits,
                       log=lambda s: None, **kw)


@pytest.mark.parametrize("moe", [False, True], ids=["qwen3-tiny", "mixtral-tiny"])
def test_sound_run_is_correct(moe):
    res = _run(moe)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] == 8
    assert set(res["metrics"]) >= {"setup_s", "output_tps", "ttft_p95_ms"}
    assert res["device"]["platform"] == "cpu"


def _kv_unchanged(monkeypatch):
    from ollamamq_tpu_torch.models import llama

    monkeypatch.setattr(llama, "kv_write", lambda pool, slots, vals: None)


def _half_batch(monkeypatch):
    from ollamamq_tpu_torch.models import llama

    orig = llama._logits

    def half(params, cfg, x, tp=None):
        out = orig(params, cfg, x, tp).clone()
        h = out.shape[0] // 2
        out[h:2 * h] = out[:h]
        return out

    monkeypatch.setattr(llama, "_logits", half)


def _token_altered(monkeypatch):
    from ollamamq_tpu_torch.engine import engine

    orig = engine.sample_tokens_rowwise

    def altered(logits, *args, **kwargs):
        return (orig(logits, *args, **kwargs) + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "sample_tokens_rowwise", altered)


@pytest.mark.parametrize("fault", [_kv_unchanged, _half_batch, _token_altered],
                         ids=["state-unchanged", "half-batch", "token-altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = _run(False, rate=40.0)  # over the tiny engine's capacity: its 4 slots stay busy
    assert not res["correct"], res["compared"]


def test_program_int8_control_runs():
    """The dense cells' control, the port's int8 path, serves and
    is read by the same check (at this size its gaps may read 0: the
    card's run at the cell's size is what has to fail)."""
    res = _run(False, precision="int8")
    assert res["attempted"] == 8 and res["failed"] == 0
    assert res["compared"]["gap_msq"]["value"] >= 0.0


def test_fp8_reference_control_reads_its_own_picks():
    """The MoE cells' control: the fp8 reference's own greedy picks,
    read under the float32 reference; a pick that is the reference's own
    reads 0, so the control never reads below 0 and reads 0 only where it
    agrees everywhere."""
    got = {}

    def ctl(c, seed, sample, ref, device):
        got.update(control.low_reference(c, seed, sample, ref, device, "fp8"))
        low = check.reference_logits(c.arch, seed, sample, c.conf["chat"], device,
                                     quant="fp8")
        got["agree"] = all(torch.equal(l.argmax(-1), r.argmax(-1))
                           for l, r in zip(low, ref))
        return got

    _run(True, control=ctl)
    assert got["gap_max"] >= 0.0
    assert (got["gap_max"] == 0.0) == got["agree"]


def test_draw_keeps_the_longest_and_repeats():
    fin = [{"i": i, "ids": [0] * n, "prompt_tokens": 10} for i, n in
           enumerate([5, 50, 7, 9, 11, 13])]
    a = check.draw(fin, 3, served_tokens=60, max_total=1000)
    assert a[0]["i"] == 1 and a == check.draw(fin, 3, served_tokens=60, max_total=1000)
    assert sum(len(r["ids"]) for r in a) >= 60
    assert check.draw(fin, 3, served_tokens=60, max_total=70) == [fin[1]]


@pytest.mark.chip
@pytest.mark.parametrize("workload,precision", [("qwen3-rag", "int8"),
                                                ("qwen3-rag", "int8w")])
def test_controls_on_the_card(workload, precision):
    """The control at the cell's own size, served in the program's place,
    comes out not correct by the cell's own check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    out = subprocess.run([sys.executable, os.path.join(spec.HERE, "control.py"),
                          "--workload", workload, "--seconds", "40", "--seeds", "91",
                          "--precision", precision],
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert not last["correct"], last["compared"]
