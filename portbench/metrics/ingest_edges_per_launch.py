"""``ingest_edges_per_launch``: edges handed to the ingest inside the traced
slice over the change in the program's ``matrix_ingest_edges.launches``
counter across it."""


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.launches.get("matrix_ingest_edges", 0)
    if launches <= 0:
        return None
    edges = sum(len(run.batches[i][0]) for i in run.slice_batches)
    return edges / launches
