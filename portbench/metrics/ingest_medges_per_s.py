"""``ingest_medges_per_s``: edges whose ingest completed in the window over
the window's seconds (host clock), in millions.  In a serving cell only
edges in an epoch published by the window's end count, over ``seconds``."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.edges_done / run.window_s / 1e6
