"""device.idle_share: the device: 1 - (the union of its kernel, copy and
set intervals / the profiled slice's wall time), in %."""


def read(run):
    tr = run.trace
    if not tr or tr["gpu_events"] == 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
