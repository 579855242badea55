"""The yardstick's arithmetic against hand-worked cases: percentiles,
window rates, model FLOPs and MFU, each attention count function, and
the reduction of a trace."""

from __future__ import annotations

import pytest

from servebench import counts, readings, stats

# A small architecture whose counts are easy to work by hand.
A = {"V": 10, "D": 4, "F": 6, "L": 2, "H": 2, "Hk": 1, "hd": 2, "E": 0, "K": 0}


def test_percentile_interpolates_between_ranks():
    assert stats.percentile([1, 2, 3, 4], 50) == 2.5
    assert stats.percentile([10, 20, 30, 40, 50], 95) == pytest.approx(48.0)
    assert stats.percentile([5], 95) == 5
    assert stats.percentile([], 95) is None
    assert stats.percentile([3, 1, 2], 0) == 1 and stats.percentile([3, 1, 2], 100) == 3


def test_rate_in_window_counts_only_the_window():
    ev = [(0.5, 3), (1.0, 2), (2.0, 4), (3.5, 100)]
    assert stats.rate_in_window(ev, 1.0, 3.0) == pytest.approx(3.0)


def test_first_last_and_token_gap():
    frames = [(1.0, 1), (1.2, 1), (1.5, 2), (9.0, 1)]
    first, last, n = stats.first_last(frames, 2.0)
    assert (first, last, n) == (1.0, 1.5, 4)
    assert stats.per_token_gap(first, last, n) == pytest.approx(0.5 / 3)
    assert stats.per_token_gap(1.0, 1.0, 1) is None


def test_layer_params_and_token_flops_by_hand():
    # q 4x4, k 4x2, v 4x2, o 4x4, mlp 3*4*6, norms 2*4
    assert counts.layer_active_params(A) == 16 + 8 + 8 + 16 + 72 + 8
    # 2 * L * 128 + 4 * L * ctx * q_dim + 2 * V * D
    assert counts.token_flops(A, 3, logits=False) == 2 * 2 * 128 + 4 * 2 * 3 * 4
    assert counts.token_flops(A, 3, logits=True) == 512 + 96 + 80
    moe = dict(A, E=4, K=2)
    assert counts.layer_active_params(moe) == 48 + 2 * 72 + 4 * 4 + 8


def test_prefill_flops_is_the_sum_of_its_tokens():
    P = 5
    by_token = sum(counts.token_flops(A, c, logits=False) for c in range(1, P + 1))
    assert counts.prefill_flops(A, P) == pytest.approx(by_token + 2 * 10 * 4)


def test_window_flops_and_mfu_by_hand():
    class R:  # a run with one request: prompt 3, four tokens by the close
        arch = A
        t1 = 10.0
        seconds = 2.0
        peaks = (100.0, 1.0)

        class cell:
            chips = 1

        requests = [{"prompt_tokens": 3,
                     "frames": [(1.0, 1), (2.0, 1), (3.0, 2), (11.0, 1)]}]

    pre, dec = readings.window_flops(R)
    assert pre == counts.prefill_flops(A, 3)
    # tokens 2..4 come from positions 3, 4, 5 over contexts 4, 5, 6
    assert dec == sum(counts.token_flops(A, c, logits=True) for c in (4, 5, 6))
    assert readings.share_of_peak(R, pre + dec) == pytest.approx(
        100.0 * (pre + dec) / (2.0 * 100.0))


def test_ragged_call_counts_by_hand():
    # one span of 3 rows at the end of a 5-position context, page 4:
    # contexts 3, 4, 5 -> 12 positions; 4 * H * hd * 12 FLOPs
    f, b = counts.ragged_call(A, [(3, 5), (0, 9)], page_size=4)
    assert f == 4 * 2 * 2 * 12
    # q and out 2 * 3 * H * hd * 2 B, K and V 2 * 5 * Hk * hd * 2 B,
    # 2 pages of int32 ids, three int32 span fields
    assert b == 2 * 3 * 4 * 2 + 2 * 5 * 2 * 2 + 4 * 2 + 12


def test_least_time_is_the_larger_bound():
    assert counts.least_seconds(10.0, 1.0, 5.0, 1.0) == 2.0
    assert counts.least_seconds(1.0, 10.0, 5.0, 2.0) == 5.0


def test_peaks_by_device_name():
    assert counts.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert counts.peaks("NVIDIA H100 PCIe") is None  # no cell runs on it
    assert counts.peaks("cpu") is None


def test_roofline_share_pairs_calls_with_ranges():
    class R:
        peaks = (100.0, 10.0)
        trace = {"by_range": {"ragged_attn": 4.0},
                 "range_counts": {"ragged_attn": 3}}

    calls = [(100.0, 5.0, 2), (50.0, 40.0, 1)]  # least: 1 s x 2, 4 s x 1
    assert readings.roofline(R, "ragged_attn", calls) == pytest.approx(150.0)
    R.trace = dict(R.trace, range_counts={"ragged_attn": 2})
    assert readings.roofline(R, "ragged_attn", calls) is None


def test_trace_summary_by_hand():
    """Two kernels launched inside a ragged-attention range and one
    outside, on the engine thread inside a step_ragged range; the device
    busy 30 of the slice's 100 us."""
    from servebench import trace

    def ann(name, ts, dur, tid=7):
        return {"cat": "user_annotation", "name": "servebench." + name, "ts": ts,
                "dur": dur, "tid": tid}

    def launch(c, ts):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
                "tid": 7, "args": {"correlation": c}}

    def kern(c, name, ts, dur):
        return {"cat": "kernel", "name": name, "ts": ts, "dur": dur,
                "args": {"correlation": c}}

    events = [ann("slice_begin", 100, 1), ann("slice_end", 200, 1),
              ann("step_ragged", 105, 60), ann("ragged_attn", 110, 10),
              launch(1, 111), launch(2, 112), launch(3, 130),
              kern(1, "attn", 120, 10), kern(2, "attn", 130, 5), kern(3, "gemm", 140, 15),
              kern(9, "before", 50, 10)]
    s = trace.summarize(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["device_s"] == pytest.approx(30e-6)
    assert s["by_range"]["ragged_attn"] == pytest.approx(15e-6)
    assert s["range_counts"] == {"ragged_attn": 1, "decode_attn": 0, "moe_mlp": 0}
    assert s["by_op"] == {"attn": pytest.approx(15e-6), "gemm": pytest.approx(15e-6)}
    # idle gaps labelled at their start: 100-120 before step_ragged
    # (105-165) opened, 135-140 and 155-200 inside it
    assert s["idle_by_host"]["loop"] == pytest.approx(20e-6)
    assert s["idle_by_host"]["step_ragged"] == pytest.approx(50e-6)
    assert trace.summarize(events[2:]) is None
