"""model.mfu.prefill: the prompts' part of model.mfu: their FLOPs over
the window's seconds x the card's bf16 peak, in %. The share of the peak
that bounds kernel.ragged_attn_roofline, which moves the same metric
(ttft_p95_ms)."""

from servebench import readings


def read(run):
    return readings.share_of_peak(run, readings.window_flops(run)[0])
