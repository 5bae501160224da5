"""``ingest_kernel_roofline``: the least time the chip could take for the
work the batches handed inside the traced slice need
(``portbench.roofline.ingest_work``), as a share of the profiler's summed
device time of ``matrix_ingest_edges_kernel`` over the slice."""
from portbench.roofline import ingest_work, least_seconds

KERNEL = "matrix_ingest_edges_kernel"


def read(run):
    if run.trace is None or run.plan is None or not run.slice_batches:
        return None
    device_s = run.trace.kernel_seconds(KERNEL)
    if device_s <= 0:
        return None
    work = {}
    least = 0.0
    for i in run.slice_batches:
        if i not in work:
            work[i] = least_seconds(*ingest_work(run.plan, run.layout,
                                                 *run.batches[i]))
        least += work[i]
    return least / device_s * 100.0
