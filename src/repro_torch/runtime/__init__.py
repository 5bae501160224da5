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

Only the thread execution backend is ported; the process and socket
backends wait for the network tier (ROADMAP item 12).

Entry point: ``repro_torch.launch.query_serve --background-ingest
[--shards K]``.
"""
from repro_torch.runtime.backend import (
    ExecutionBackend,
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
