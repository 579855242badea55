"""engine.host_ms_per_step: the engine loop (engine/engine.py): the step
profiler's host phases (host_prep, dispatch, detok: everything but the
device wait in collect) summed over the window's dispatches outside the
profiled slice, over their count, in ms."""


def read(run):
    steps = run.steps
    if not steps:
        return None
    host = sum(s["host_prep_ms"] + s["dispatch_ms"] + s["detok_ms"] for s in steps)
    return host / len(steps)
