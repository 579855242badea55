"""ttft_p95_ms: the 95th percentile, over every request due in the
window, of due time to first streamed token (servebench/readings.py)."""

from servebench import readings


def read(run):
    return readings.p95(readings.ttft_ms(run, run.requests))
