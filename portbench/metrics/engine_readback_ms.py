"""``engine_readback_ms``: for each ``repro.engine.execute`` span of the
traced slice, the union length of the program's ``repro.engine.readback``
spans inside it (the engine's results brought to the host); the mean over
the executes, in milliseconds."""
from portbench.program_spans import per_execute_seconds


def read(run):
    seconds = per_execute_seconds(run, "engine.readback")
    return None if seconds is None else seconds * 1e3
