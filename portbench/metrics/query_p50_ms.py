"""``query_p50_ms``: the median latency (scheduled arrival to answers on
the host) of the requests served in the window before the profiled slice,
so that the profiler's cost stays out of it."""
import numpy as np


def read(run):
    if not run.unprofiled_served:
        return None
    idx = np.concatenate([np.arange(lo, hi)
                          for lo, hi, _ in run.unprofiled_served])
    return float(np.median(run.latencies_s[idx])) * 1e3
