"""output_tps: output tokens streamed to the clients inside the window,
over the window's seconds (host clock, the clients' side)."""

from servebench import stats


def read(run):
    return stats.rate_in_window(
        (f for q in run.requests for f in q["frames"]), run.t0, run.t1)
