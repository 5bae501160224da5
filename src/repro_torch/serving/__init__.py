"""repro_torch.serving — the online query-serving layer over live sketches.

  registry  multi-tenant sketch registry; owns per-tenant ingest loops
  snapshot  double-buffered epoch-stamped read snapshots (snapshot isolation
            over in-place ingest)
  engine    batched query planner: heterogeneous requests -> batched calls
            on the snapshot's device, with per-(tenant, epoch) closure
            caching for reachability
  gates     exactness and conservation checks
  loadgen   open-loop load generator reporting QPS and p50/p99 latency,
            in process or over TCP connections (``NetLoadGen``)
  sharding  K hash-band shards per tenant: routed stream views, the
            scatter/gather engine, cross-shard conservation, manifests

Entry point: ``repro_torch.launch.query_serve`` (ingest + serving end to
end; ``--background-ingest`` and ``--shards K`` run the ingest in
``repro_torch.runtime`` workers).
"""
from repro_torch.serving.engine import (
    ClosureCache,
    QueryEngine,
    Request,
    Result,
    edge_freq,
    heavy_nodes,
    node_in,
    node_out,
    path_weight,
    reach,
    subgraph_weight,
)
from repro_torch.serving.loadgen import (
    LoadReport,
    OpenLoopLoadGen,
    WorkloadMix,
    mix_for_sketch,
    synth_requests,
    warm_bucket_ladder,
)
from repro_torch.serving.registry import SketchRegistry, Tenant, TenantKey
from repro_torch.serving.sharding import (
    ShardedQueryEngine,
    ShardedSnapshot,
    ShardedTenant,
    ShardKey,
    ShardStreamView,
    attach_shards,
    measure_sharded_ingest,
    read_shard_manifest,
    sharded_conservation,
    sharded_direct_answers,
    warm_ingest_shapes,
    write_shard_manifest,
)
from repro_torch.serving.snapshot import Snapshot, SnapshotBuffer

__all__ = [
    "ClosureCache",
    "QueryEngine",
    "Request",
    "Result",
    "edge_freq",
    "heavy_nodes",
    "node_in",
    "node_out",
    "path_weight",
    "reach",
    "subgraph_weight",
    "LoadReport",
    "OpenLoopLoadGen",
    "WorkloadMix",
    "mix_for_sketch",
    "synth_requests",
    "warm_bucket_ladder",
    "SketchRegistry",
    "Tenant",
    "TenantKey",
    "ShardedQueryEngine",
    "ShardedSnapshot",
    "ShardedTenant",
    "ShardKey",
    "ShardStreamView",
    "attach_shards",
    "measure_sharded_ingest",
    "read_shard_manifest",
    "sharded_conservation",
    "sharded_direct_answers",
    "warm_ingest_shapes",
    "write_shard_manifest",
    "Snapshot",
    "SnapshotBuffer",
]
