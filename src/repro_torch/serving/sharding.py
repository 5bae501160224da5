"""Sharded serving: hash-band edge routing over K independent sketch shards.

The JAX package's ``serving/sharding.py`` on the port.  The scale-out layer
(DESIGN.md §Sharding).  A ``ShardPlan``
(``core.partitioning``) deterministically owns every edge by a hash band of
its SOURCE vertex; each shard is a full ``Tenant`` — its own
``SnapshotBuffer`` over an ``empty_like`` clone of ONE master sketch (same
layout, partition plan and hash family), fed by a ``ShardStreamView`` that
filters the seekable base stream down to the shard's edges.  Because the
shards partition the stream and share a layout:

  * ingest parallelizes: one ``repro_torch.runtime`` queue + worker per shard
    (``attach_shards``), each publishing epochs independently;
  * the merge of all shard sketches is bit-identical to a single sketch
    that ingested the whole stream (counter additivity over a stream
    partition) — ``merged_snapshot`` is the gate sharded serving is held
    to;
  * queries scatter/gather (``ShardedQueryEngine``): edge-frequency and
    node-out route to the owning shard alone (all out-edges of a vertex
    live there), node-in / path / subgraph decompose per edge pair and sum,
    reachability builds ONE closure over the summed per-shard connectivity
    layers (bit-identical to the unsharded closure), and heavy-node sweeps
    keep each vertex's score from its owning shard.  Closures are cached
    under the per-shard epoch VECTOR — any shard publishing invalidates.

Checkpoints stay per-shard (each shard tenant has its own id, offset and
store directory); ``write_shard_manifest`` records the shard topology next
to them so a restore can rebuild — and validate — the same plan.

All shards of a tenant live on the registry's device, so K is logical: K
shards on one card are K delta sketches and K workers, and the sharded
closure sums their connectivity layers there.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.core import queries
from repro_torch.core.partitioning import ShardPlan
from repro_torch.core.types import EdgeBatch
from repro_torch.serving import engine as eng
from repro_torch.serving.registry import Tenant, TenantKey
from repro_torch.serving.snapshot import Snapshot, sketch_device


@dataclasses.dataclass(frozen=True)
class ShardKey:
    """Identity of one shard of a sharded tenant (quacks like TenantKey)."""

    base: TenantKey
    shard: int
    n_shards: int

    @property
    def tenant_id(self) -> str:
        return f"{self.base.tenant_id}/shard{self.shard}of{self.n_shards}"

    @property
    def dataset(self) -> str:
        return self.base.dataset

    @property
    def kind(self) -> str:
        return self.base.kind

    @property
    def budget_kb(self) -> int:
        return self.base.budget_kb

    @property
    def seed(self) -> int:
        # distinct per shard so per-shard reservoirs draw independent coins
        return self.base.seed ^ (self.shard * 0x9E3779B1)


class ShardStreamView:
    """Shard ``shard``'s deterministic slice of a seekable base stream.

    Batch ``i`` contains exactly the base batch's non-padding edges whose
    source routes to this shard (``plan.shard_of``), compacted and
    zero-padded up to a bucket from a coarse ladder: multiples of
    ``granule = max(min_bucket, base_batch // 4)`` (the JAX package's
    ladder, which keeps its per-shard jit cache to a handful of shapes;
    the port keeps it so the shard batches are the same arrays).  Same
    replayability contract as the base: batch ``i`` is a pure function of
    ``(base, plan, shard, i)``, so per-shard checkpoint/restore replays
    bit-exactly.  ``spec`` passes through — note its ``n_edges`` is the
    FULL stream count; cross-shard accounting sums per-shard totals
    against it.
    """

    def __init__(self, base, plan: ShardPlan, shard: int, *,
                 min_bucket: int = 256) -> None:
        if not (0 <= shard < plan.n_shards):
            raise ValueError(f"shard {shard} out of range for {plan}")
        self.base = base
        self.plan = plan
        self.shard = shard
        self.min_bucket = min_bucket
        self.granule = max(min_bucket,
                           getattr(base, "batch_size", min_bucket) // 4)

    @property
    def spec(self):
        return self.base.spec

    @property
    def num_batches(self) -> int:
        return self.base.num_batches

    def batch_numpy(self, i: int):
        src, dst, w = self.base.batch_numpy(i)
        own = (w > 0) & (self.plan.shard_of(src) == self.shard)
        n = int(own.sum())
        bucket = max(self.granule, -(-n // self.granule) * self.granule)
        s = np.zeros(bucket, np.int32)
        d = np.zeros(bucket, np.int32)
        ww = np.zeros(bucket, np.int32)
        s[:n], d[:n], ww[:n] = src[own], dst[own], w[own]
        return s, d, ww

    def batch(self, i: int, *, device="cuda") -> EdgeBatch:
        return EdgeBatch.from_numpy(*self.batch_numpy(i), device=device)

    def iter_from(self, offset: int, *, device="cuda"):
        for i in range(offset, self.num_batches):
            yield i, self.batch(i, device=device)


@dataclasses.dataclass(frozen=True)
class ShardedSnapshot:
    """Gather of one Snapshot reference per shard (nothing writes to them).

    Each part is individually consistent (snapshot isolation per shard);
    the gather is NOT a cross-shard atomic cut — shards publish
    independently, so ``epochs`` is a vector, and every result batch is
    stamped with the vector observed at planning time.
    """

    tenant_id: str
    plan: ShardPlan
    parts: tuple  # tuple[Snapshot, ...], len == plan.n_shards

    @property
    def epochs(self) -> tuple:
        return tuple(p.epoch for p in self.parts)

    @property
    def n_edges(self) -> int:
        return sum(p.n_edges for p in self.parts)

    @property
    def kind(self) -> str:
        return self.parts[0].kind

    def __repr__(self) -> str:
        return (f"ShardedSnapshot({self.tenant_id!r}, "
                f"epochs={self.epochs}, n_edges={self.n_edges})")


class ShardedTenant:
    """K shard ``Tenant``s sharing one layout, plus the routing plan."""

    def __init__(self, key: TenantKey, plan: ShardPlan,
                 shards: list[Tenant], mod) -> None:
        self.key = key
        self.plan = plan
        self.shards = shards
        self.mod = mod

    @property
    def n_shards(self) -> int:
        return self.plan.n_shards

    @property
    def stream(self):
        """The (unsharded) base stream; per-shard views live on the shards."""
        return self.shards[0].stream.base

    @property
    def snapshot(self) -> ShardedSnapshot:
        return ShardedSnapshot(
            tenant_id=self.key.tenant_id,
            plan=self.plan,
            parts=tuple(s.snapshot for s in self.shards),
        )

    @property
    def epochs(self) -> tuple:
        return tuple(s.epoch for s in self.shards)

    @property
    def exhausted(self) -> bool:
        return all(s.exhausted for s in self.shards)

    def step(self, n_batches: int = 1) -> int:
        """Cooperative ingest: advance every shard by up to ``n_batches``."""
        return sum(s.step(n_batches) for s in self.shards)

    def publish(self) -> ShardedSnapshot:
        for s in self.shards:
            s.publish()
        return self.snapshot

    def merged_snapshot(self) -> Snapshot:
        """One Snapshot holding the merge of all shard fronts.

        By the routing invariant this equals a single sketch that ingested
        the whole published prefix — the sharded-vs-unsharded exactness
        gate queries it through ``engine.direct_answers``.  Synthetic view:
        its scalar epoch cannot encode the epoch vector, so do NOT serve it
        through a closure-caching engine.
        """
        snap = self.snapshot
        sk = functools.reduce(self.mod.merge, [p.sketch for p in snap.parts])
        return Snapshot(
            tenant_id=f"{self.key.tenant_id}/merged",
            epoch=max(snap.epochs),
            sketch=sk,
            kind=snap.kind,
            n_edges=snap.n_edges,
        )


# ---------------------------------------------------------------- engine --

class ShardedQueryEngine:
    """Scatter/gather planner over a ``ShardedSnapshot``.

    Delegates every per-shard sub-batch to ONE inner ``QueryEngine`` (so
    padding, bucket ladders and the per-(shard, epoch) closure cache are
    all shared), and owns only the cross-shard composition:

      edge_freq / node_out  ->  owning shard (routing invariant)
      node_in               ->  sum of per-shard estimates (a vertex's
                                in-edges are scattered across shards)
      path / subgraph       ->  pairs grouped by owning shard of each
                                pair's source; per-shard masked sums added
      reach                 ->  one closure over the SUM of per-shard
                                connectivity layers — bit-identical to the
                                unsharded closure by counter additivity —
                                cached under the epoch VECTOR
      heavy_nodes           ->  per-shard sweeps; each vertex keeps its
                                owning shard's score; union, sorted by id

    Exact by construction: ``sharded_direct_answers`` computes the same
    composition through the module-level query functions, and the tests
    and the card's smoke gate equality.
    """

    def __init__(self, engine: eng.QueryEngine | None = None,
                 closure_capacity: int = 8) -> None:
        self.engine = engine or eng.QueryEngine()
        # separate instance from the inner engine's per-shard cache: keys
        # here are epoch VECTORS over all shards, and mixing them with
        # per-shard entries would let one evict the other prematurely
        self.closures = eng.ClosureCache(closure_capacity)

    # -------------------------------------------------------------- closure
    def _closure(self, ssnap: ShardedSnapshot, max_hops: int | None):
        key = (tuple(p.tenant_id for p in ssnap.parts), ssnap.epochs,
               max_hops)

        def build():
            layers = functools.reduce(
                torch.add,
                [queries.closure_layers(p.sketch) for p in ssnap.parts])
            return queries.build_closure(layers, max_hops)

        return self.closures.get_or_build(key, build)

    # -------------------------------------------------------------- execute
    def execute(self, ssnap: ShardedSnapshot,
                requests: list[eng.Request]) -> list[eng.Result]:
        """Answer ``requests`` against one sharded snapshot gather.

        Results are stamped with the epoch vector observed at planning time
        (one consistent stamp per batch, mirroring the unsharded engine's
        single-epoch stamp).
        """
        plan = ssnap.plan
        k = plan.n_shards
        epochs = ssnap.epochs
        values: list = [None] * len(requests)

        # scatter: per-shard sub-requests + how to fold each answer back
        shard_reqs: list[list[eng.Request]] = [[] for _ in range(k)]
        shard_fold: list[list[tuple[str, int]]] = [[] for _ in range(k)]
        reach_groups: dict[int | None, list[int]] = {}
        heavy_idxs: list[int] = []

        for i, r in enumerate(requests):
            if r.family == eng.EDGE_FREQ:
                s = plan.shard_of_one(r.src)
                shard_reqs[s].append(r)
                shard_fold[s].append(("set", i))
            elif r.family == eng.NODE_OUT:
                s = plan.shard_of_one(r.node)
                shard_reqs[s].append(r)
                shard_fold[s].append(("set", i))
            elif r.family == eng.NODE_IN:
                values[i] = 0
                for s in range(k):
                    shard_reqs[s].append(r)
                    shard_fold[s].append(("add", i))
            elif r.family in (eng.PATH_WEIGHT, eng.SUBGRAPH_WEIGHT):
                if r.family == eng.PATH_WEIGHT:
                    pairs = list(zip(r.nodes[:-1], r.nodes[1:]))
                else:
                    pairs = list(r.edges)
                values[i] = 0
                owners = plan.shard_of(
                    np.asarray([p[0] for p in pairs], np.int64))
                for s in sorted(set(int(o) for o in owners)):
                    sub = [p for p, o in zip(pairs, owners) if int(o) == s]
                    shard_reqs[s].append(eng.subgraph_weight(sub))
                    shard_fold[s].append(("add", i))
            elif r.family == eng.REACH:
                reach_groups.setdefault(r.max_hops, []).append(i)
            elif r.family == eng.HEAVY_NODES:
                heavy_idxs.append(i)
            else:
                raise ValueError(f"unknown family {r.family!r}")

        # gather: one inner-engine batch per shard
        for s in range(k):
            if not shard_reqs[s]:
                continue
            res = self.engine.execute(ssnap.parts[s], shard_reqs[s])
            for (op, i), r in zip(shard_fold[s], res):
                if op == "set":
                    values[i] = r.value
                else:
                    values[i] += r.value

        # reachability against the merged-connectivity closure
        for max_hops, group in reach_groups.items():
            closure = self._closure(ssnap, max_hops)
            sk0 = ssnap.parts[0].sketch
            dev = sketch_device(sk0)
            # split oversized groups like the inner engine's planner does
            for lo in range(0, len(group), self.engine.max_bucket):
                idxs = group[lo:lo + self.engine.max_bucket]
                n = len(idxs)
                b = eng._bucket(n, self.engine.min_bucket,
                                self.engine.max_bucket)
                src = self.engine._pad([requests[i].src for i in idxs], b,
                                       dev)
                dst = self.engine._pad([requests[i].dst for i in idxs], b,
                                       dev)
                hi = queries.reach_cells(sk0, src)
                hj = queries.reach_cells(sk0, dst)
                out = eng._host(queries.reachability_from_closure(
                    closure, hi, hj))[:n]
                for j, i in enumerate(idxs):
                    values[i] = bool(out[j])

        # heavy nodes: per-shard sweeps, each vertex scored by its owner
        unique: dict[tuple, tuple] = {}
        for i in heavy_idxs:
            r = requests[i]
            qkey = (r.universe, r.threshold)
            if qkey not in unique:
                ids_parts, freq_parts = [], []
                for s in range(k):
                    ids, freqs = self.engine.execute(
                        ssnap.parts[s], [r])[0].value
                    own = plan.shard_of(np.asarray(ids, np.int64)) == s
                    ids_parts.append(np.asarray(ids)[own])
                    freq_parts.append(np.asarray(freqs)[own])
                ids = np.concatenate(ids_parts)
                freqs = np.concatenate(freq_parts)
                order = np.argsort(ids, kind="stable")
                unique[qkey] = (ids[order], freqs[order])
            values[i] = unique[qkey]

        return [eng.Result(requests[i].family, epochs, values[i])
                for i in range(len(requests))]

    @property
    def stats(self) -> dict:
        return {
            **self.engine.stats,
            "sharded_closure_hits": self.closures.hits,
            "sharded_closure_misses": self.closures.misses,
        }


def sharded_direct_answers(ssnap: ShardedSnapshot,
                           requests: list[eng.Request]) -> list:
    """Reference oracle for sharded serving: the same scatter/gather
    composition as ``ShardedQueryEngine`` but answered request-by-request
    through the module-level query functions (no planner, no padding, no
    caches), on the shards' device.  The sharded engine must match this
    exactly."""
    plan = ssnap.plan
    parts = ssnap.parts
    mod = eng.sketch_module(parts[0].sketch)
    dev = sketch_device(parts[0].sketch)

    def ids(vals) -> torch.Tensor:
        return torch.as_tensor(np.asarray(vals, np.int32), device=dev)

    def pair_sum(pairs) -> int:
        total = 0
        for s, d in pairs:
            sk = parts[plan.shard_of_one(s)].sketch
            total += int(mod.edge_freq(sk, ids([s]), ids([d]))[0])
        return total

    merged_closure: dict = {}
    out: list = []
    for r in requests:
        if r.family == eng.EDGE_FREQ:
            sk = parts[plan.shard_of_one(r.src)].sketch
            out.append(int(mod.edge_freq(sk, ids([r.src]), ids([r.dst]))[0]))
        elif r.family == eng.NODE_OUT:
            sk = parts[plan.shard_of_one(r.node)].sketch
            out.append(int(mod.node_out_freq(sk, ids([r.node]))[0]))
        elif r.family == eng.NODE_IN:
            out.append(sum(int(mod.node_in_freq(p.sketch, ids([r.node]))[0])
                           for p in parts))
        elif r.family == eng.REACH:
            if r.max_hops not in merged_closure:
                layers = functools.reduce(
                    torch.add, [queries.closure_layers(p.sketch)
                                for p in parts])
                merged_closure[r.max_hops] = queries.build_closure(
                    layers, r.max_hops)
            sk0 = parts[0].sketch
            out.append(bool(queries.reachability_from_closure(
                merged_closure[r.max_hops],
                queries.reach_cells(sk0, ids([r.src])),
                queries.reach_cells(sk0, ids([r.dst])))[0]))
        elif r.family == eng.PATH_WEIGHT:
            out.append(pair_sum(list(zip(r.nodes[:-1], r.nodes[1:]))))
        elif r.family == eng.SUBGRAPH_WEIGHT:
            out.append(pair_sum(list(r.edges)))
        elif r.family == eng.HEAVY_NODES:
            ids_parts, freq_parts = [], []
            for s, p in enumerate(parts):
                hid, freqs = queries.heavy_nodes(
                    lambda v: mod.node_out_freq(p.sketch, v),
                    r.universe, r.threshold, device=dev)
                hid = eng._host(hid)
                keep = (hid >= 0) & (plan.shard_of(
                    np.asarray(hid, np.int64)) == s)
                ids_parts.append(hid[keep])
                freq_parts.append(eng._host(freqs)[keep])
            hid = np.concatenate(ids_parts)
            freqs = np.concatenate(freq_parts)
            order = np.argsort(hid, kind="stable")
            out.append((hid[order], freqs[order]))
        else:
            raise ValueError(f"unknown family {r.family!r}")
    return out


# --------------------------------------------------------------- runtime --

def attach_shards(runtime, tenant: ShardedTenant, *, restore: bool = False,
                  max_batches: int | None = None,
                  throttle_s=0.0, publish_policy: str | None = None,
                  on_publish=None) -> list:
    """Attach every shard of ``tenant`` to a ``repro_torch.runtime.Runtime``.

    One queue + worker (+ pump) per shard, via the standard
    ``Runtime.attach`` contract — shard tenants ARE tenants.  With a
    checkpoint dir, writes the shard manifest next to the per-shard stores
    on a fresh attach and validates it on ``restore=True`` (shard count or
    routing seed drift would silently re-route the stream mid-history).
    ``throttle_s`` may be a scalar or a per-shard sequence (used by tests
    to drive shards to different offsets).
    """
    if restore and runtime.checkpoint_dir:
        manifest = read_shard_manifest(runtime.checkpoint_dir)
        if (manifest["n_shards"] != tenant.n_shards
                or manifest["shard_seed"] != tenant.plan.seed):
            raise ValueError(
                f"shard manifest ({manifest['n_shards']} shards, seed "
                f"{manifest['shard_seed']}) does not match this tenant "
                f"({tenant.n_shards} shards, seed {tenant.plan.seed}); "
                "restoring under a different plan would re-route the stream")
    throttles = (list(throttle_s) if hasattr(throttle_s, "__len__")
                 else [throttle_s] * tenant.n_shards)
    handles = [
        runtime.attach(shard, restore=restore, max_batches=max_batches,
                       throttle_s=throttles[i],
                       publish_policy=publish_policy, on_publish=on_publish)
        for i, shard in enumerate(tenant.shards)
    ]
    if runtime.checkpoint_dir and not restore:
        write_shard_manifest(runtime.checkpoint_dir, tenant,
                             runtime_backend=runtime.backend.name)
    return handles


def sharded_conservation(handles, stream_total: int) -> dict:
    """Cross-shard edge-mass accounting over per-shard runtime handles.

    The hard gate of sharded serving: the shard views partition the
    stream, so after a graceful drain Σ per-shard published + Σ accounted
    drops must equal the base stream's total — and every shard must
    individually balance (zero unaccounted).
    """
    from repro_torch.serving.gates import conservation_verdict

    per_shard = [h.conservation() for h in handles]
    unaccounted = [c["unaccounted_edges"] for c in per_shard]
    verdict = conservation_verdict(
        sum(c["published_edges"] for c in per_shard),
        sum(c["dropped_edges"] for c in per_shard),
        stream_total, unaccounted)
    return {
        **verdict,
        "per_shard_published": [c["published_edges"] for c in per_shard],
        "per_shard_unaccounted": unaccounted,
    }


def warm_ingest_shapes(tenant: ShardedTenant) -> int:
    """Run every shard-ingest bucket shape once, off the clock.

    Ingests zero-weight batches (a counter no-op: additive sketches ignore
    weight-0 updates) of each ladder bucket through each shard's buffer,
    on the shards' device.  Covers up to 2x the base batch: worker
    coalescing may overshoot its target by one item, so coalesced
    dispatches can reach ~2B.  The port compiles nothing per shape, but
    the first launches (library load, allocator growth) stay off the
    measured wall, and the epochs advance as the JAX package's do.
    Returns the number of shapes touched.
    """
    shapes = 0
    for shard in tenant.shards:
        view = shard.stream
        base_b = getattr(view.base, "batch_size", view.granule * 4)
        for bucket in range(view.granule, 2 * base_b + view.granule,
                            view.granule):
            z = np.zeros(bucket, np.int32)
            shard.buffer.ingest(EdgeBatch.from_numpy(
                z, z, z, device=shard.buffer.device))
            shapes += 1
    # also run the publish (merge + fresh delta): publishing the still-zero
    # delta is a no-op on counters (it does bump each shard's epoch by one,
    # which is harmless — epoch numbers are arbitrary)
    for shard in tenant.shards:
        shard.publish()
    return shapes


def measure_sharded_ingest(tenant: ShardedTenant, *,
                           backend: str = "thread",
                           coalesce_batches: int = 16,
                           max_batches: int | None = None) -> dict:
    """Backlog-drain ingest throughput over K shard workers, any backend.

    Pre-fills each shard's parent-side queue with its (remaining) stream
    view, then drains through one ``Runtime`` worker per shard — no pumps,
    no query load: the pure concurrent-ingest capacity against K, for the
    thread backend (K worker threads in this interpreter) or a remote one
    (``"process"``: K spawn children, each with its own interpreter and,
    on the card, its own CUDA context).  The wall runs from each worker's
    first-ingest monotonic timestamp to its drain-publish timestamp (one
    system-wide clock, so valid across the process boundary): stream
    generation, spawn, warm-up and readiness handshakes are off the clock
    for every backend, while the publish end-point synchronizes on the
    device ingest chain (the pending-count read), so asynchronous launches
    cannot hide device work off the clock.  Conservation-checked: every
    queued edge must land in a published epoch.
    """
    from repro_torch.runtime import QueueItem, Runtime

    nb = tenant.stream.num_batches
    coalesce_target = getattr(tenant.stream, "batch_size", 8192)
    per_shard_items: list[list] = []
    queued_edges = 0
    for shard in tenant.shards:
        end = nb if max_batches is None else min(nb, shard.offset
                                                 + max_batches)
        items = []
        for i in range(shard.offset, end):
            src, dst, w = shard.stream.batch_numpy(i)
            item = QueueItem.from_arrays(i, src, dst, w)
            items.append(item)
            queued_edges += item.n_edges
        per_shard_items.append(items)
    capacity = max(max((len(x) for x in per_shard_items), default=0), 1) + 1
    # publish once at drain: per-epoch cadence is a serving concern and
    # would bill one full-sketch merge per epoch to the ingest wall
    runtime = Runtime(queue_capacity=capacity,
                      publish_policy="every:1000000000", reservoir_k=0,
                      poll_s=0.002, backend=backend,
                      coalesce_batches=coalesce_batches,
                      coalesce_target=coalesce_target)
    handles = [runtime.attach(shard, pump=False) for shard in tenant.shards]
    if not runtime.backend.remote:
        warm_ingest_shapes(tenant)  # remote workers warm on their side
    runtime.start()
    runtime.wait_ready()  # ALL workers up before the backlog lands: the
    #                       wall must measure the concurrent drain, not
    #                       K staggered child boots
    base_edges = sum(h.worker.base_edges for h in handles)
    for handle, items in zip(handles, per_shard_items):
        for item in items:
            handle.queue.put(item)  # capacity covers the whole backlog
    runtime.stop(drain=True, timeout=600)
    metrics = [h.worker.metrics_snapshot() for h in handles]
    starts = [m["first_ingest_at"] for m in metrics if m["first_ingest_at"]]
    ends = [m["last_publish_at"] for m in metrics if m["last_publish_at"]]
    wall = max((max(ends) - min(starts)) if starts and ends else 0.0, 1e-9)
    ingested = sum(h.worker.ingested_edges for h in handles)
    published = sum(s.snapshot.n_edges for s in tenant.shards)
    return {
        "n_shards": tenant.n_shards,
        "backend": runtime.backend.name,
        "queued_edges": queued_edges,
        "ingested_edges": ingested,
        "published_edges": published,
        "wall_s": round(wall, 4),
        "edges_per_s": round(ingested / wall, 1),
        "worker_states": [h.worker.state for h in handles],
        "conserved": bool(ingested == queued_edges
                          and published - base_edges == ingested),
    }


# -------------------------------------------------------------- manifest --

_MANIFEST = "shard_manifest.json"


def write_shard_manifest(directory: str, tenant: ShardedTenant, *,
                         runtime_backend: str = "thread") -> str:
    """Atomically record the shard topology next to the per-shard stores.

    ``runtime_backend`` records which execution backend wrote the
    checkpoints — informational only: every backend writes one format, so
    restore never rejects on it.  The JSON is the JAX package's, key for
    key, so either package restores a sharded checkpoint of the other.
    """
    os.makedirs(directory, exist_ok=True)
    payload = {
        "base_tenant_id": tenant.key.tenant_id,
        "dataset": tenant.key.dataset,
        "kind": tenant.key.kind,
        "budget_kb": tenant.key.budget_kb,
        "seed": tenant.key.seed,
        "n_shards": tenant.n_shards,
        "shard_seed": tenant.plan.seed,
        "shard_tenant_ids": [s.key.tenant_id for s in tenant.shards],
        "runtime_backend": runtime_backend,
    }
    path = os.path.join(directory, _MANIFEST)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tmp_manifest_")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=2)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return path


def read_shard_manifest(directory: str) -> dict:
    """Load and validate the shard manifest; fail LOUDLY on corruption.

    A truncated or torn manifest must never be treated as "no manifest"
    (which a restore could shrug off) or crash with a bare JSON error:
    restoring under an unverifiable shard plan could silently re-route the
    stream mid-history, so corruption is a hard, descriptive failure.
    """
    path = os.path.join(directory, _MANIFEST)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no shard manifest at {path} — was this checkpoint dir written "
            "by a sharded run (attach_shards with checkpointing enabled)?")
    with open(path) as f:
        try:
            manifest = json.load(f)
        except json.JSONDecodeError as exc:
            raise ValueError(
                f"shard manifest at {path} is truncated or corrupt ({exc}); "
                "refusing to restore — the shard plan cannot be verified, "
                "and resuming under a different plan would re-route the "
                "stream mid-history") from exc
    missing = [k for k in ("n_shards", "shard_seed", "shard_tenant_ids")
               if k not in manifest]
    if missing:
        raise ValueError(
            f"shard manifest at {path} is missing required keys {missing}; "
            "refusing to restore under an unverifiable shard plan")
    return manifest
