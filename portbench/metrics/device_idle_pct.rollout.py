"""device_idle_pct.rollout: the share of the traced slice in which no
operation ran on the device (the slice less the union of the device's
operations, from the profiler trace)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
