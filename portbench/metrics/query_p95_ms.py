"""``query_p95_ms``: the 95th percentile, over every request scheduled in
the window, of the time from its scheduled arrival to its answers on the
host (host clock); requests still waiting at the window's end are served
after it and count their whole wait.  None where the cell serves none."""
import numpy as np


def read(run):
    if run.latencies_s is None or len(run.latencies_s) == 0:
        return None
    return float(np.percentile(run.latencies_s, 95)) * 1e3
