"""``query_core_ms``: for each ``repro.engine.execute`` span of the traced
slice, the union length of the program's ``repro.query.*`` spans inside it
(the sketch modules' point and node queries, closure builds, reachability
lookups, heavy-node sweeps); the mean over the executes, in
milliseconds."""
from portbench.program_spans import per_execute_seconds


def read(run):
    seconds = per_execute_seconds(run, "query.")
    return None if seconds is None else seconds * 1e3
