"""``engine_group_ms.edge_freq``: the mean host time of one edge-frequency
group of the engine in the window before the profiled slice: the change in
the program's hub histogram
``repro_engine_group_seconds{family="edge_freq"}``, sum over count."""


def read(run):
    seconds, count = run.unprofiled_groups.get("edge_freq", (0.0, 0))
    if count <= 0:
        return None
    return seconds / count * 1e3
