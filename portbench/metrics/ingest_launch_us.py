"""``ingest_launch_us``: the mean length of the program's
``repro.dispatch.matrix_ingest_edges`` spans in the traced slice (the
wrapper from its entry to the launch's return: argument checks, ctypes
arrays, scratch, launch), in microseconds."""
from portbench.program_spans import mean_seconds


def read(run):
    seconds = mean_seconds(run, "dispatch.matrix_ingest_edges")
    return None if seconds is None else seconds * 1e6
