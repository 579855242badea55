"""core.queue_wait_p95_ms: the fair-share core and admission
(core/mqcore.py, engine/scheduler.py): the 95th percentile over the
window's requests of RequestStats.prefill_started_at - enqueued_at."""

from servebench import readings


def read(run):
    return readings.p95(readings.queue_wait_ms(run))
