"""kMatrix — the paper's contribution (§IV), flat-pool layout.

A gMatrix whose counter space is *partitioned* using a sample of the stream:
the partitioner (``repro_torch.core.partitioning``) assigns each sampled
vertex to a localized ``w_i x w_i`` sketch; the per-layer slabs are
concatenated into one flat pool so that ingest is one hash + scatter-add
however heterogeneous the partition widths are.

Layout (per layer r):

    pool[r] = [ slab_0 | slab_1 | ... | slab_{P-1} ]      slab_p has w_p^2 cells
    edge (i, j) with p = partition(i):
        cell = offset_p + fastrange(h_r(i), w_p) * w_p + fastrange(h_r(j), w_p)

The same cells also exist in the width-class arrangement
(``repro_torch.core.kmatrix_accel``); the two layouts are bit-exact
permutations of each other.  A small global connectivity matrix
(``conn_frac`` of the budget) ingests every edge under a global hash and
answers reachability; ``conn_frac=0`` gives a frequency-only kMatrix.

Unlike the JAX package, ``ingest`` adds into the sketch's ``pool`` and
``conn`` tensors in place and returns the same sketch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.hashing import HashFamily, families_match, fastrange
from repro_torch.common.struct import static_field, tensor_dataclass
from repro_torch.core.partitioning import plan_for
from repro_torch.core.routing import RouteTable, route_table_from_plan, routes_match
from repro_torch.core.types import EdgeBatch, VertexStats


@tensor_dataclass
class KMatrix:
    pool: torch.Tensor  # int32[d, pool_size]
    conn: torch.Tensor  # int32[d, cw, cw] global connectivity sketch (cw may be 0)
    # scatter-fallback tally carried over from the width-class layout; flat
    # ingest never overflows and leaves it untouched, so a relayout
    # round-trip keeps the diagnostic.  merge sums it.
    overflow: torch.Tensor  # int32[]
    hashes: HashFamily
    route: RouteTable
    pool_size: int = static_field()
    conn_w: int = static_field()

    @property
    def depth(self) -> int:
        return self.pool.shape[0]

    @property
    def num_counters(self) -> int:
        return self.pool.numel() + self.conn.numel()

    @staticmethod
    def create(
        *,
        bytes_budget: int,
        stats: VertexStats,
        depth: int = 7,
        seed: int = 0,
        max_partitions: int = 64,
        min_width: int = 8,
        outlier_frac: float | None = None,
        conn_frac: float = 0.1,
        partitioner: str = "auto",
        n_bands: int = 16,
        device="cuda",
    ) -> "KMatrix":
        counters = bytes_budget // 4
        per_layer = max(counters // depth, 4)
        conn_w = int(np.sqrt(per_layer * conn_frac)) if conn_frac > 0 else 0
        freq_budget = per_layer - conn_w * conn_w
        total_width = max(int(np.sqrt(freq_budget)), 2)
        plan = plan_for(
            partitioner, stats, total_width, square=True, min_width=min_width,
            outlier_frac=outlier_frac, max_partitions=max_partitions,
            n_bands=n_bands,
        )
        route, pool_size = route_table_from_plan(plan, square=True,
                                                 device=device)
        return KMatrix(
            pool=torch.zeros((depth, pool_size), dtype=torch.int32, device=device),
            conn=torch.zeros((depth, conn_w, conn_w), dtype=torch.int32,
                             device=device),
            overflow=torch.zeros((), dtype=torch.int32, device=device),
            hashes=HashFamily.create(seed, depth, device=device),
            route=route,
            pool_size=pool_size,
            conn_w=conn_w,
        )


def layer_rows(d: int, ndim: int, device) -> torch.Tensor:
    """Layer indices 0..d-1 shaped [d, 1, ...] to index a [d, *S] gather."""
    return torch.arange(d, device=device).view((d,) + (1,) * ndim)


def edge_cells(sk: KMatrix, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Flat pool index of edge (src, dst) in every layer -> int64[d, *S]."""
    p = sk.route.lookup(src)
    w = sk.route.widths[p].to(torch.int64)  # [*S]
    off = sk.route.offsets[p].to(torch.int64)
    hi = fastrange(sk.hashes.mix(src), w)  # [d, *S]
    hj = fastrange(sk.hashes.mix(dst), w)
    return off[None] + hi * w[None] + hj


def conn_cells(sk: KMatrix, v: torch.Tensor) -> torch.Tensor:
    """Per-layer slot of vertex ``v`` in the global connectivity matrix."""
    return fastrange(sk.hashes.mix(v), sk.conn_w)


def ingest(sk: KMatrix, batch: EdgeBatch) -> KMatrix:  # writes: 0
    """Add ``batch`` into ``sk.pool`` and ``sk.conn`` in place; returns ``sk``.

    int32 counters wrap in two's complement, as the JAX package's do.
    """
    idx = edge_cells(sk, batch.src, batch.dst)  # [d, B]
    rows = layer_rows(sk.depth, 1, idx.device).expand_as(idx)
    wts = batch.weight[None, :].to(sk.pool.dtype).expand(idx.shape)
    sk.pool.index_put_((rows, idx), wts, accumulate=True)
    if sk.conn_w > 0:
        ci = conn_cells(sk, batch.src)
        cj = conn_cells(sk, batch.dst)
        sk.conn.index_put_((rows, ci, cj), wts, accumulate=True)
    return sk


def edge_freq(sk: KMatrix, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    idx = edge_cells(sk, src, dst)
    rows = layer_rows(sk.depth, src.ndim, idx.device)
    return sk.pool[rows, idx].amin(dim=0)


def node_out_freq(sk: KMatrix, v: torch.Tensor) -> torch.Tensor:
    """Row-sum of v's row inside its partition slab, min over layers.

    Heterogeneous widths are handled with a masked gather over the max
    partition width.  Masked columns may point past the pool's end; they
    are clamped for the gather and zeroed by the mask.
    """
    p = sk.route.lookup(v)
    w = sk.route.widths[p].to(torch.int64)  # [*S]
    off = sk.route.offsets[p].to(torch.int64)
    hi = fastrange(sk.hashes.mix(v), w)  # [d, *S]
    cols = torch.arange(sk.route.max_width, device=v.device)  # [wmax]
    idx = off[None, ..., None] + hi[..., None] * w[None, ..., None] + cols
    mask = cols < w[None, ..., None]
    rows = layer_rows(sk.depth, v.ndim + 1, v.device)
    vals = sk.pool[rows, idx.clamp(max=sk.pool_size - 1)]
    vals = torch.where(mask, vals, 0)
    return vals.sum(dim=-1, dtype=torch.int32).amin(dim=0)


def empty_like(sk: KMatrix) -> KMatrix:
    """A zero-counter sketch sharing ``sk``'s layout, routing and hashes.

    The counters are fresh storage, never an alias of ``sk``'s: an in-place
    ingest into the result leaves ``sk`` unchanged.
    """
    return sk.replace(pool=torch.zeros_like(sk.pool),
                      conn=torch.zeros_like(sk.conn),
                      overflow=torch.zeros_like(sk.overflow))


def merge(a: KMatrix, b: KMatrix) -> KMatrix:
    """Counter-additivity: the sketch of a union stream is the elementwise sum.

    Both operands must share layout AND hash seeds AND partition plan —
    layouts can coincide across seeds or samples, so both are checked.
    """
    if a.pool_size != b.pool_size or a.conn_w != b.conn_w:
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
    return a.replace(pool=a.pool + b.pool, conn=a.conn + b.conn,
                     overflow=a.overflow + b.overflow)
