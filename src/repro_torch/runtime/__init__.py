"""repro_torch.runtime — background ingest behind the serving engine.

The JAX package's ``repro.runtime`` on the port (DESIGN.md §Runtime):
per-tenant ``IngestWorker`` threads pull stream batches from bounded
queues with explicit backpressure (block / drop-oldest / spill, all drops
accounted), fold them into the registry's delta sketch on the tenant's
device, and publish epochs under a pluggable ``PublishPolicy``; the
``Runtime`` supervisor owns worker lifecycle (start, health, graceful
drain-and-stop, crash-like kill), the per-tenant online reservoir sample,
crash-safe checkpointing through ``repro_torch.checkpoint.store`` (the JAX
on-disk layout), and live metrics (queue depth, ingest lag, edges/s,
publish latency, epoch age).

The worker's execution venue is an **execution backend**
(``runtime/backend.py``): ``backend="thread"`` runs in-process worker
threads; ``backend="process"`` runs each worker in a spawn child that owns
its sketch (with its own CUDA context on the card) and ships epoch-stamped
publications back into the parent's ``SnapshotBuffer``;
``backend="socket[:HOST:PORT,...]"`` runs the same worker across TCP
(``repro_torch.net``).

Entry points: ``repro_torch.launch.query_serve --background-ingest
[--shards K] [--runtime-backend process|socket[:HOST:PORT,...]]`` and
``repro_torch.launch.stream_ingest --runtime-backend ...``.
"""
from repro_torch.runtime.backend import (
    ExecutionBackend,
    ProcessBackend,
    ProcessWorker,
    ThreadBackend,
    WorkerFailure,
    resolve_backend,
)
from repro_torch.runtime.metrics import RateEWMA, WorkerMetrics
from repro_torch.runtime.policies import (
    EveryNBatches,
    PublishPolicy,
    QueueDrainWatermark,
    WallClockInterval,
    make_policy,
)
from repro_torch.runtime.queueing import (
    BACKPRESSURE_POLICIES,
    BLOCK,
    DROP_OLDEST,
    SPILL,
    BoundedEdgeQueue,
    QueueItem,
)
from repro_torch.runtime.supervisor import Runtime, StreamPump, TenantRuntime
from repro_torch.runtime.worker import (
    CREATED,
    DRAINING,
    FAILED,
    RUNNING,
    STOPPED,
    IngestWorker,
    restore_worker_state,
)

__all__ = [
    "ExecutionBackend",
    "ProcessBackend",
    "ProcessWorker",
    "ThreadBackend",
    "WorkerFailure",
    "resolve_backend",
    "RateEWMA",
    "WorkerMetrics",
    "EveryNBatches",
    "PublishPolicy",
    "QueueDrainWatermark",
    "WallClockInterval",
    "make_policy",
    "BACKPRESSURE_POLICIES",
    "BLOCK",
    "DROP_OLDEST",
    "SPILL",
    "BoundedEdgeQueue",
    "QueueItem",
    "Runtime",
    "StreamPump",
    "TenantRuntime",
    "IngestWorker",
    "restore_worker_state",
    "CREATED",
    "RUNNING",
    "DRAINING",
    "STOPPED",
    "FAILED",
]
