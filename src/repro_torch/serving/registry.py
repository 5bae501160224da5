"""Sketch construction from a byte budget, for every sketch kind of the
paper's comparison, and the multi-tenant registry of live sketches (the JAX
package's ``serving/registry.py``).

A *tenant* is one (dataset, sketch kind, budget, seed) combination — the unit
of isolation for the always-on query service.  The registry owns, per tenant:

  * the seekable stream (batch i is a pure function of (seed, i)),
  * the bootstrap sample -> VertexStats -> partition plan,
  * the ingest loop position (next unread batch), and
  * the ``SnapshotBuffer`` holding the live delta + published snapshot.

``launch/query_serve.py`` drives tenants by alternating ``tenant.step(n)``
(ingest) with engine query batches against ``tenant.snapshot``; the double
buffer keeps the queries epoch-consistent while ingest runs.  Tenants live
on the registry's device (``"cuda"`` unless the caller names the CPU), and
so do sharded tenants (``open_sharded``): K shards over one layout, fed by
hash-band views of the stream (``serving/sharding.py``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Iterator

from repro_torch.core import countmin, gsketch, kmatrix, kmatrix_accel, matrix_sketch
from repro_torch.core.countmin import CountMin
from repro_torch.core.gsketch import GSketch
from repro_torch.core.kmatrix import KMatrix
from repro_torch.core.kmatrix_accel import KMatrixAccel
from repro_torch.core.kmatrix_accel import sketch_backend as resolve_sketch_backend
from repro_torch.core.matrix_sketch import MatrixSketch
from repro_torch.core.types import vertex_stats_from_sample
from repro_torch.serving.snapshot import Snapshot, SnapshotBuffer
from repro_torch.streams import make_stream, sample_stream

SKETCHES = ("countmin", "gsketch", "tcm", "gmatrix", "kmatrix")


def build_sketch(name: str, budget: int, stats, depth: int, seed: int,
                 partitioner: str = "banded", backend: str | None = None, *,
                 device="cuda"):
    """Construct a sketch kind from a byte budget; returns (sketch, module).

    As in the JAX package: gSketch always takes the greedy plan at its
    default ``min_width`` (``partitioner`` applies to kMatrix only), and
    ``tcm`` and ``gmatrix`` differ only in their label, so the same seed
    gives them identical tables.  For ``kmatrix`` the layout is a backend
    choice (``resolve_sketch_backend``): ``width_class`` (the default) builds
    ``KMatrixAccel``, whose ingest runs the ``matrix_ingest`` kernel;
    ``flat`` the flat-pool ``KMatrix``.
    """
    if name not in SKETCHES:
        raise ValueError(f"unknown sketch {name!r} (expected one of {SKETCHES})")
    if name == "countmin":
        return CountMin.create(bytes_budget=budget, depth=depth, seed=seed,
                               device=device), countmin
    if name in ("tcm", "gmatrix"):
        return MatrixSketch.create(bytes_budget=budget, depth=depth, seed=seed,
                                   kind=name, device=device), matrix_sketch
    if name == "gsketch":
        return GSketch.create(bytes_budget=budget, stats=stats, depth=depth,
                              seed=seed, device=device), gsketch
    if resolve_sketch_backend(backend) == "width_class":
        return KMatrixAccel.create(
            bytes_budget=budget, stats=stats, depth=depth, seed=seed,
            partitioner=partitioner, device=device), kmatrix_accel
    return KMatrix.create(bytes_budget=budget, stats=stats, depth=depth,
                          seed=seed, partitioner=partitioner,
                          device=device), kmatrix


@dataclasses.dataclass(frozen=True)
class TenantKey:
    dataset: str
    kind: str
    budget_kb: int
    seed: int = 0

    @property
    def tenant_id(self) -> str:
        return f"{self.dataset}/{self.kind}/{self.budget_kb}kb/s{self.seed}"


@dataclasses.dataclass(frozen=True)
class TenantOrigin:  # wire-type
    """How to rebuild a registry-opened tenant from scratch, anywhere.

    Tenant construction is deterministic — stream, bootstrap sample,
    partition plan and hash family are all pure functions of the registry
    config + the open() arguments — so this small picklable spec is enough
    for another address space to rebuild a tenant with the *identical*
    sketch layout.
    """

    registry: dict  # SketchRegistry(**registry) reproduces the config
    dataset: str
    kind: str
    budget_kb: int
    seed: int = 0
    # set only for shard tenants (one shard of an open_sharded tenant)
    n_shards: int | None = None
    shard_seed: int | None = None
    shard_index: int | None = None

    def rebuild(self, device=None) -> "Tenant":
        """The tenant, built anew; on ``device`` if given (a worker chooses
        its own), else on the registry's device (the card when the
        registry names none, as the JAX package's never does)."""
        config = dict(self.registry)
        if config.get("sketch_backend") == "pallas":  # the JAX package's name
            config["sketch_backend"] = "width_class"
        if device is not None:
            config["device"] = str(device)
        reg = SketchRegistry(**config)
        if self.n_shards is None:
            return reg.open(self.dataset, self.kind, self.budget_kb,
                            seed=self.seed)
        sharded = reg.open_sharded(self.dataset, self.kind, self.budget_kb,
                                   seed=self.seed, n_shards=self.n_shards,
                                   shard_seed=self.shard_seed)
        return sharded.shards[self.shard_index]

    def for_wire(self) -> "TenantOrigin":
        """This origin in the JAX package's shape, as it crosses the wire:
        the registry without ``device`` (the JAX ``SketchRegistry`` takes
        no such argument, and the worker chooses its device itself) and the
        width-class kMatrix layout under the JAX name ``"pallas"``."""
        config = {k: v for k, v in self.registry.items() if k != "device"}
        if config.get("sketch_backend") == "width_class":
            config["sketch_backend"] = "pallas"
        return dataclasses.replace(self, registry=config)


class Tenant:
    """One registered sketch + its stream position + snapshot buffer.

    ``offset``/``step`` are owned by exactly one ingest driver at a time:
    either the cooperative caller of ``step()`` or (exclusively) a
    ``repro_torch.runtime`` worker thread.
    ``snapshot`` is safe to read from any thread at any time (a reference
    swap; nothing writes to a published sketch).
    """

    def __init__(self, key: TenantKey, stream, buffer: SnapshotBuffer,
                 mod) -> None:
        self.key = key
        self.stream = stream
        self.buffer = buffer
        self.mod = mod
        self.offset = 0  # next stream batch to ingest
        # rebuild spec stamped by the registry (None for hand-built tenants)
        self.origin: TenantOrigin | None = None

    @property
    def device(self):
        return self.buffer.device

    @property
    def snapshot(self) -> Snapshot:
        return self.buffer.snapshot

    @property
    def epoch(self) -> int:
        return self.buffer.epoch

    @property
    def exhausted(self) -> bool:
        return self.offset >= self.stream.num_batches

    def step(self, n_batches: int = 1) -> int:
        """Ingest up to ``n_batches`` more stream batches into the live delta
        (each made on the tenant's device).

        Returns the number actually consumed (0 once the stream is drained).
        """
        done = 0
        while done < n_batches and not self.exhausted:
            self.buffer.ingest(self.stream.batch(self.offset,
                                                 device=self.device))
            self.offset += 1
            done += 1
        return done

    def publish(self) -> Snapshot:
        return self.buffer.publish()


class SketchRegistry:
    """Registry of live tenants, keyed by (dataset, kind, budget, seed)."""

    def __init__(self, *, depth: int = 5, batch_size: int = 8192,
                 sample_size: int = 30_000, scale: float = 1.0,
                 partitioner: str = "banded",
                 sketch_backend: str | None = None, device="cuda") -> None:
        self.depth = depth
        self.batch_size = batch_size
        self.sample_size = sample_size
        self.scale = scale
        self.partitioner = partitioner
        # resolved once at registry build, not per tenant open: a registry
        # whose tenants straddle two layouts would break merge/restore
        # interchange assumptions downstream
        self.sketch_backend = resolve_sketch_backend(sketch_backend)
        self.device = str(device)
        self._tenants: dict[TenantKey, Tenant] = {}
        self._sharded: dict = {}  # (key, n_shards, shard_seed) -> ShardedTenant
        # get-or-create must be atomic once background workers can race
        # opens: two tenants for one key would double-ingest the stream
        self._lock = threading.Lock()

    def config(self) -> dict:
        """The constructor kwargs that reproduce this registry (all plain
        picklable values)."""
        return {
            "depth": self.depth,
            "batch_size": self.batch_size,
            "sample_size": self.sample_size,
            "scale": self.scale,
            "partitioner": self.partitioner,
            "sketch_backend": self.sketch_backend,
            "device": self.device,
        }

    def open(self, dataset: str, kind: str, budget_kb: int,
             seed: int = 0) -> Tenant:
        """Get-or-create the tenant for a key (idempotent, thread-safe)."""
        key = TenantKey(dataset, kind, budget_kb, seed)
        with self._lock:
            if key in self._tenants:
                return self._tenants[key]
        stream = make_stream(dataset, batch_size=self.batch_size, seed=seed,
                             scale=self.scale)
        # Paper §V-A: a reservoir sample of the stream bootstraps the
        # partitioner before any counter is allocated.
        n_sample = max(int(self.sample_size * self.scale), 1000)
        ssrc, sdst, sw = sample_stream(stream, n_sample, seed=seed + 1)
        stats = vertex_stats_from_sample(ssrc, sdst, sw)
        sketch, mod = build_sketch(kind, budget_kb * 1024, stats, self.depth,
                                   seed, self.partitioner,
                                   backend=self.sketch_backend,
                                   device=self.device)
        with self._lock:
            if key in self._tenants:  # lost the build race; first one wins
                return self._tenants[key]
            buffer = SnapshotBuffer(sketch, mod, tenant_id=key.tenant_id,
                                    kind=kind)
            tenant = Tenant(key, stream, buffer, mod)
            tenant.origin = TenantOrigin(self.config(), dataset, kind,
                                         budget_kb, seed)
            self._tenants[key] = tenant
            return tenant

    def open_sharded(self, dataset: str, kind: str, budget_kb: int,
                     seed: int = 0, *, n_shards: int, shard_seed: int = 0):
        """Get-or-create a ``ShardedTenant``: K shard tenants over ONE layout.

        The master sketch is built exactly like ``open`` would build it
        (same stream, same bootstrap sample, same partition plan and hash
        family) and every shard gets an ``empty_like`` clone on the
        registry's device — that shared layout is what makes the merge of
        the shards bit-identical to an unsharded ingest of the same stream
        (DESIGN.md §Sharding).  Each shard's stream is a ``ShardStreamView``
        filtering the base stream by the ``ShardPlan`` hash band of the
        source vertex.
        """
        from repro_torch.core.partitioning import ShardPlan
        from repro_torch.serving.sharding import (ShardKey, ShardStreamView,
                                                  ShardedTenant)

        key = TenantKey(dataset, kind, budget_kb, seed)
        skey = (key, n_shards, shard_seed)
        with self._lock:
            if skey in self._sharded:
                return self._sharded[skey]
        stream = make_stream(dataset, batch_size=self.batch_size, seed=seed,
                             scale=self.scale)
        n_sample = max(int(self.sample_size * self.scale), 1000)
        ssrc, sdst, sw = sample_stream(stream, n_sample, seed=seed + 1)
        stats = vertex_stats_from_sample(ssrc, sdst, sw)
        sketch, mod = build_sketch(kind, budget_kb * 1024, stats, self.depth,
                                   seed, self.partitioner,
                                   backend=self.sketch_backend,
                                   device=self.device)
        plan = ShardPlan(n_shards, seed=shard_seed)
        shards = []
        for s in range(n_shards):
            shard_key = ShardKey(key, s, n_shards)
            view = ShardStreamView(stream, plan, s)
            buffer = SnapshotBuffer(mod.empty_like(sketch), mod,
                                    tenant_id=shard_key.tenant_id, kind=kind)
            shard = Tenant(shard_key, view, buffer, mod)
            shard.origin = TenantOrigin(self.config(), dataset, kind,
                                        budget_kb, seed, n_shards=n_shards,
                                        shard_seed=shard_seed, shard_index=s)
            shards.append(shard)
        tenant = ShardedTenant(key, plan, shards, mod)
        with self._lock:
            if skey in self._sharded:  # lost the build race; first one wins
                return self._sharded[skey]
            self._sharded[skey] = tenant
            return tenant

    def get(self, key: TenantKey) -> Tenant:
        return self._tenants[key]

    def __contains__(self, key: TenantKey) -> bool:
        return key in self._tenants

    def __len__(self) -> int:
        return len(self._tenants)

    def tenants(self) -> Iterator[Tenant]:
        return iter(self._tenants.values())

    def step_all(self, n_batches: int = 1) -> int:
        """Advance every tenant's ingest loop; returns total batches consumed."""
        return sum(t.step(n_batches) for t in self.tenants())

    def publish_all(self) -> list[Snapshot]:
        return [t.publish() for t in self.tenants()]
