"""gSketch (Zhao, Aggarwal & Wang) — paper §III-B, Type I partitioned baseline.

A CountMin whose width budget is carved into per-partition segments by the
sample-driven partitioner; an edge ``(i, j)`` is routed to the partition of
its source vertex ``i`` and hashed within that partition's local width.
Unseen vertices go to the outlier partition.  Ingest is a plain
``scatter_add_`` into ``sk.pool`` in place (the JAX package has no Pallas
kernel for it and returns a new array).
"""
from __future__ import annotations

import torch

from repro_torch.common.hashing import (
    HashFamily,
    families_match,
    fastrange,
    hash_pair_mix,
)
from repro_torch.common.struct import static_field, tensor_dataclass
from repro_torch.core.kmatrix import layer_rows
from repro_torch.core.partitioning import plan_partitions, plan_partitions_banded
from repro_torch.core.routing import RouteTable, route_table_from_plan, routes_match
from repro_torch.core.types import EdgeBatch, VertexStats


@tensor_dataclass
class GSketch:
    pool: torch.Tensor  # int32[d, pool_size] concatenated partition rows
    hashes: HashFamily
    route: RouteTable
    pool_size: int = static_field()

    @property
    def depth(self) -> int:
        return self.pool.shape[0]

    @property
    def num_counters(self) -> int:
        return self.pool.numel()

    @staticmethod
    def create(
        *,
        bytes_budget: int,
        stats: VertexStats,
        depth: int = 7,
        seed: int = 0,
        max_partitions: int = 64,
        min_width: int = 64,
        outlier_frac: float | None = None,
        partitioner: str = "greedy",
        n_bands: int = 16,
        device="cuda",
    ) -> "GSketch":
        counters = bytes_budget // 4
        total_width = max(counters // depth, 1)
        if partitioner == "greedy":
            plan = plan_partitions(
                stats, total_width, square=False,
                max_partitions=max_partitions, min_width=min_width,
                outlier_frac=outlier_frac)
        elif partitioner == "banded":
            plan = plan_partitions_banded(
                stats, total_width, square=False, n_bands=n_bands,
                min_width=min_width, outlier_frac=outlier_frac)
        else:
            raise ValueError(f"unknown partitioner {partitioner!r}")
        route, pool_size = route_table_from_plan(plan, square=False,
                                                 device=device)
        return GSketch(
            pool=torch.zeros((depth, pool_size), dtype=torch.int32, device=device),
            hashes=HashFamily.create(seed, depth, device=device),
            route=route,
            pool_size=pool_size,
        )


def _edge_cells(sk: GSketch, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    p = sk.route.lookup(src)  # [*S]
    w = sk.route.widths[p]
    off = sk.route.offsets[p].to(torch.int64)
    key = hash_pair_mix(src, dst)
    local = fastrange(sk.hashes.mix(key), w)  # [d, *S] (w broadcasts)
    return off[None] + local


def ingest(sk: GSketch, batch: EdgeBatch) -> GSketch:  # writes: 0
    """Add ``batch`` into ``sk.pool`` in place; returns ``sk``."""
    idx = _edge_cells(sk, batch.src, batch.dst)  # [d, B]
    sk.pool.scatter_add_(1, idx, batch.weight.to(torch.int32).expand_as(idx))
    return sk


def edge_freq(sk: GSketch, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    idx = _edge_cells(sk, src, dst)
    rows = layer_rows(sk.depth, src.ndim, idx.device)
    return sk.pool[rows, idx].amin(dim=0)


def empty_like(sk: GSketch) -> GSketch:
    """A zero-counter sketch sharing layout, routing and hashes; fresh
    storage."""
    return sk.replace(pool=torch.zeros_like(sk.pool))


def merge(a: GSketch, b: GSketch) -> GSketch:
    """Counter-additivity into a fresh pool; operands must share layout AND
    hash seeds AND partition plan."""
    if a.pool_size != b.pool_size:
        raise ValueError("merge: operands have different layouts")
    if not families_match(a.hashes, b.hashes):
        raise ValueError(
            "merge: operands use different hash families (built with "
            "different seeds); merging them silently corrupts estimates")
    if not routes_match(a.route, b.route):
        raise ValueError(
            "merge: operands use different partition plans (built from "
            "different samples); edges route to different slabs, so summing "
            "the pools silently corrupts estimates")
    return a.replace(pool=a.pool + b.pool)
