"""``engine_execute_ms``: the mean host time of one ``QueryEngine.execute``
call in the window before the profiled slice (the benchmark's own span
around it; the answers are on the host when it returns)."""


def read(run):
    if not run.unprofiled_served:
        return None
    return (sum(s for _, _, s in run.unprofiled_served)
            / len(run.unprofiled_served) * 1e3)
