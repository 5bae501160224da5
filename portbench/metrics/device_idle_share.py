"""``device_idle_share``: the share of the traced slice's wall time in which
no kernel, copy or fill ran on the device (one minus the union of the
profiler's device intervals over the slice)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return (1.0 - run.trace.busy_s / run.trace.window_s) * 100.0
