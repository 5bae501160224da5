"""``from_numpy_us``: the mean length of the program's
``repro.dispatch.from_numpy`` spans in the traced slice
(``EdgeBatch.from_numpy``: the int32 views and the three pageable puts),
in microseconds."""
from portbench.program_spans import mean_seconds


def read(run):
    seconds = mean_seconds(run, "dispatch.from_numpy")
    return None if seconds is None else seconds * 1e6
