"""model.mfu: the model forward (models/llama.py, models/moe.py): model
FLOPs of every token the window completed, prefill and decode, over the
window's seconds x the card's bf16 peak, in % (servebench/counts.py)."""

from servebench import readings


def read(run):
    return readings.share_of_peak(run, sum(readings.window_flops(run)))
