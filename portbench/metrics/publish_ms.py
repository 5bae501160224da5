"""``publish_ms``: the mean length of the program's
``repro.snapshot.publish`` spans in the traced slice (the merge into a
fresh front, the pending count read on the host, a fresh delta), in
milliseconds."""
from portbench.program_spans import mean_seconds


def read(run):
    seconds = mean_seconds(run, "snapshot.publish")
    return None if seconds is None else seconds * 1e3
