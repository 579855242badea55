"""tpot_p95_ms: the 95th percentile over requests of (last token - first
token) / (tokens - 1), over what each streamed by the window's close."""

from servebench import readings


def read(run):
    return readings.p95(readings.tpot_ms(run, run.requests))
