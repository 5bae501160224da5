"""gSketch-style sketch partitioning, generalized for kMatrix (paper §IV-A).

Given per-vertex sample statistics (estimated out-frequency ``f_v(m)`` and
out-degree ``deg(m)``), the expected relative error of a partition ``S`` with
width ``w`` follows paper Eq. (5):

    E(S, w) = (1/w) * [ sum_m deg(m)^2 * F(S) / f_v(m)  -  sum_m deg(m) ]
    F(S)    = sum_{m in S} f_v(m)

and the split criterion Eq. (8) reduces (for an equal split) to minimizing

    E'(S1, S2) = G(S1) + G(S2),
    G(S) = F(S) * sum_{m in S} deg(m)^2 / f_v(m)

The classical gSketch heuristic sorts vertices by average edge frequency
``f_v(m)/deg(m)`` (so each side stays frequency-uniform) and sweeps the cut
point; prefix sums make each sweep O(n).  We recurse greedily: always split
the leaf with the largest predicted error reduction, stopping at
``max_partitions`` / ``min_width`` / non-positive gain.

Width bookkeeping differs between the 1-D (gSketch: CountMin rows, memory
``d*w``) and 2-D (kMatrix: w x w matrices, memory ``d*w^2``) cases; splits
conserve *memory*, so the 2-D child width is ``w/sqrt(2)``, not ``w/2``.
This is host-side numpy — it runs once at sketch build time from the sample
(paper: 30k reservoir-sampled edges) and produces static Python ints that
fix the sketch's layout.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.core.types import VertexStats


@dataclasses.dataclass(frozen=True)
class Partition:
    """One leaf of the partition tree."""

    vertices: np.ndarray  # int32[k] vertex ids routed here
    width: int  # hash range of the localized sketch
    expected_error: float  # E(S, w) from Eq. (5)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Full output of the partitioner.

    ``route_keys``/``route_part`` give the sorted vertex -> partition map for
    sampled vertices; ``outlier`` is the partition index for unseen vertices.
    """

    partitions: tuple[Partition, ...]
    route_keys: np.ndarray  # int32[n] sorted
    route_part: np.ndarray  # int32[n]
    outlier: int

    @property
    def widths(self) -> tuple[int, ...]:
        return tuple(p.width for p in self.partitions)


def _partition_error(freq: np.ndarray, deg: np.ndarray, width: int) -> float:
    """Paper Eq. (5) for a vertex group with sketch width ``width``."""
    if len(freq) == 0 or width <= 0:
        return 0.0
    big_f = float(freq.sum())
    term = float((deg * deg / np.maximum(freq, 1e-9)).sum())
    return (big_f * term - float(deg.sum())) / float(width)


def _best_split(freq: np.ndarray, deg: np.ndarray):
    """Sweep the sorted-by-avg-frequency cut minimizing G(S1)+G(S2).

    Returns (cut_index, gprime) with vertices [0:cut] -> S1, [cut:] -> S2,
    in the *sorted* order (caller must apply the same order).
    """
    n = len(freq)
    if n < 2:
        return None
    f = np.maximum(freq, 1e-9)
    g_term = deg * deg / f
    pf = np.cumsum(f)
    pg = np.cumsum(g_term)
    tf, tg = pf[-1], pg[-1]
    cuts = np.arange(1, n)
    left = pf[:-1] * pg[:-1]
    right = (tf - pf[:-1]) * (tg - pg[:-1])
    scores = left + right
    k = int(np.argmin(scores))
    return cuts[k], float(scores[k])


def good_turing_outlier_share(freq: np.ndarray) -> float:
    """Estimate the stream share of *unsampled* sources (Good-Turing).

    P(next edge's source unseen) ~= N1 / N where N1 = #sources with exactly
    one sampled edge. Sizes the outlier sketch by its expected traffic rather
    than a fixed fraction — at low sample coverage most mass is unseen and a
    fixed 10% outlier would be catastrophically undersized.
    """
    n = float(freq.sum())
    if n <= 0:
        return 0.5
    n1 = float((freq <= 1.0).sum())
    return float(np.clip(n1 / n, 0.05, 0.6))


def plan_partitions(
    stats: VertexStats,
    total_width: int,
    *,
    square: bool,
    max_partitions: int = 64,
    min_width: int = 64,
    outlier_frac: float | None = None,
) -> PartitionPlan:
    """Run the greedy recursive partitioner.

    Args:
      stats: sample-derived vertex statistics.
      total_width: width budget W. 1-D (gSketch): memory is ``d*W`` counters
        and children split W additively. 2-D (kMatrix): memory is ``d*W^2``
        and children get ``W/sqrt(2)`` each (memory conserving).
      square: True for the 2-D matrix case.
      outlier_frac: fraction of the *memory* budget reserved for vertices
        that never appeared in the sample (gSketch's outlier sketch).
        None -> Good-Turing estimate of unseen-source traffic.
    """
    vertex = np.asarray(stats.vertex)
    freq = np.asarray(stats.freq, dtype=np.float64)
    deg = np.asarray(stats.deg, dtype=np.float64)

    if outlier_frac is None:
        outlier_frac = good_turing_outlier_share(freq)

    if square:
        outlier_w = max(min_width, int(total_width * np.sqrt(outlier_frac)))
        root_w = int(np.sqrt(max(total_width * total_width - outlier_w * outlier_w, 1)))
    else:
        outlier_w = max(min_width, int(total_width * outlier_frac))
        root_w = total_width - outlier_w

    # Sort by average edge frequency (f/deg): the gSketch uniformity ordering.
    order = np.argsort(freq / np.maximum(deg, 1.0), kind="stable")
    vertex, freq, deg = vertex[order], freq[order], deg[order]

    def child_width(w: int) -> int:
        return int(w / np.sqrt(2.0)) if square else w // 2

    # Leaf := (vertex index slice, width). Greedy best-first on error gain.
    heap: list[tuple[float, int, tuple]] = []
    counter = 0

    def push(lo: int, hi: int, w: int) -> None:
        nonlocal counter
        f, d_ = freq[lo:hi], deg[lo:hi]
        err_now = _partition_error(f, d_, w)
        cw = child_width(w)
        best = _best_split(f, d_) if (hi - lo >= 2 and cw >= min_width) else None
        if best is None:
            gain = -np.inf
            cut = -1
        else:
            cut, _ = best
            err_split = _partition_error(f[:cut], d_[:cut], cw) + _partition_error(
                f[cut:], d_[cut:], cw
            )
            gain = err_now - err_split
        heapq.heappush(heap, (-gain, counter, (lo, hi, w, cut, gain)))
        counter += 1

    push(0, len(vertex), root_w)
    leaves: list[tuple[int, int, int]] = []
    n_leaves = 1
    while heap:
        _, _, (lo, hi, w, cut, gain) = heapq.heappop(heap)
        if gain <= 0 or n_leaves >= max_partitions or cut < 0:
            leaves.append((lo, hi, w))
            continue
        cw = child_width(w)
        push(lo, lo + cut, cw)
        push(lo + cut, hi, cw)
        n_leaves += 1

    leaves.sort()

    # --- Budget-filling rescale -------------------------------------------
    # The sqrt(2) child widths + integer floors typically strand 10-15% of
    # the counter budget; rescale every width so the final layout consumes
    # (almost) exactly the budgeted area, then spend any remainder one
    # column at a time on the leaves with the largest expected error.
    widths = np.array([w for (_, _, w) in leaves] + [outlier_w], dtype=np.int64)
    if square:
        budget_area = int(total_width) ** 2
        used = int((widths**2).sum())
        scale = np.sqrt(budget_area / max(used, 1))
        widths = np.maximum((widths * scale).astype(np.int64), 2)
        while int((widths**2).sum()) > budget_area:
            widths[int(np.argmax(widths))] -= 1
        # Greedy remainder spend: +1 width costs 2w+1 area.
        improved = True
        while improved:
            improved = False
            order = np.argsort(widths)
            for i in order:
                cost = 2 * int(widths[i]) + 1
                if int((widths**2).sum()) + cost <= budget_area:
                    widths[i] += 1
                    improved = True
    else:
        budget_area = int(total_width)
        used = int(widths.sum())
        widths = np.maximum((widths * (budget_area / max(used, 1))).astype(np.int64), 2)
        while int(widths.sum()) > budget_area:
            widths[int(np.argmax(widths))] -= 1
        rem = budget_area - int(widths.sum())
        if rem > 0:
            widths[np.argsort(widths)[:rem]] += 1

    partitions = [
        Partition(
            vertices=vertex[lo:hi].astype(np.int32),
            width=int(widths[k]),
            expected_error=_partition_error(freq[lo:hi], deg[lo:hi], int(widths[k])),
        )
        for k, (lo, hi, _) in enumerate(leaves)
    ]
    # Outlier partition is appended last and owns no sampled vertices.
    partitions.append(
        Partition(vertices=np.empty(0, np.int32), width=int(widths[-1]), expected_error=0.0)
    )

    keys = np.concatenate([p.vertices for p in partitions[:-1]]) if partitions[:-1] else np.empty(0, np.int32)
    parts = np.concatenate(
        [np.full(len(p.vertices), i, np.int32) for i, p in enumerate(partitions[:-1])]
    ) if len(keys) else np.empty(0, np.int32)
    order = np.argsort(keys, kind="stable")
    return PartitionPlan(
        partitions=tuple(partitions),
        route_keys=keys[order].astype(np.int32),
        route_part=parts[order].astype(np.int32),
        outlier=len(partitions) - 1,
    )


def plan_partitions_banded(
    stats: VertexStats,
    total_width: int,
    *,
    square: bool,
    n_bands: int = 16,
    min_width: int = 8,
    outlier_frac: float | None = None,
) -> PartitionPlan:
    """Beyond-paper partitioner: frequency bands + continuous-optimal areas.

    Instead of recursive equal binary splits (paper Eq. 8), observe that the
    split objective  E = sum_S F(S) * H(S) / a(S)  (H = sum deg^2/f) has the
    closed-form optimal allocation  a(S) ~ sqrt(F(S) * H(S)) = sqrt(G(S))
    for a *fixed* grouping.  We group vertices into ``n_bands`` equal-count
    bands of the average-edge-frequency ordering (maximal uniformity per
    band) and allocate areas by the sqrt-G rule.

    It is the default partitioner of the ingest driver.
    """
    vertex = np.asarray(stats.vertex)
    freq = np.asarray(stats.freq, dtype=np.float64)
    deg = np.asarray(stats.deg, dtype=np.float64)
    if outlier_frac is None:
        outlier_frac = good_turing_outlier_share(freq)

    avg = freq / np.maximum(deg, 1.0)
    order = np.argsort(avg, kind="stable")
    v, f, d_ = vertex[order], freq[order], deg[order]

    bounds = np.linspace(0, len(v), n_bands + 1).astype(int)
    groups, gs = [], []
    for i in range(n_bands):
        lo, hi = bounds[i], bounds[i + 1]
        if hi <= lo:
            continue
        g_val = f[lo:hi].sum() * float(
            (d_[lo:hi] ** 2 / np.maximum(f[lo:hi], 1e-9)).sum()
        )
        groups.append((lo, hi))
        gs.append(max(g_val, 1e-9))
    gs_arr = np.asarray(gs)

    if square:
        area = float(total_width) ** 2
        out_area = area * outlier_frac
        alloc = (area - out_area) * np.sqrt(gs_arr) / np.sqrt(gs_arr).sum()
        widths = np.maximum(np.sqrt(alloc).astype(np.int64), min_width)
        out_w = max(int(np.sqrt(out_area)), min_width)
        # Budget fill: spend the integer-floor remainder widening leaves.
        all_w = np.concatenate([widths, [out_w]])
        improved = True
        while improved:
            improved = False
            for i in np.argsort(all_w):
                if int((all_w**2).sum()) + 2 * int(all_w[i]) + 1 <= area:
                    all_w[i] += 1
                    improved = True
        widths, out_w = all_w[:-1], int(all_w[-1])
    else:
        budget = float(total_width)
        out_w = max(int(budget * outlier_frac), min_width)
        alloc = (budget - out_w) * np.sqrt(gs_arr) / np.sqrt(gs_arr).sum()
        widths = np.maximum(alloc.astype(np.int64), min_width)
        rem = int(budget) - out_w - int(widths.sum())
        if rem > 0:
            widths[np.argsort(widths)[:rem]] += 1

    partitions = [
        Partition(
            vertices=v[lo:hi].astype(np.int32),
            width=int(w),
            expected_error=_partition_error(f[lo:hi], d_[lo:hi], int(w)),
        )
        for (lo, hi), w in zip(groups, widths)
    ]
    partitions.append(
        Partition(vertices=np.empty(0, np.int32), width=out_w, expected_error=0.0)
    )
    keys = np.concatenate([p.vertices for p in partitions[:-1]])
    parts = np.concatenate(
        [np.full(len(p.vertices), i, np.int32) for i, p in enumerate(partitions[:-1])]
    )
    o = np.argsort(keys, kind="stable")
    return PartitionPlan(
        partitions=tuple(partitions),
        route_keys=keys[o].astype(np.int32),
        route_part=parts[o].astype(np.int32),
        outlier=len(partitions) - 1,
    )


def _two_term_score(plan: PartitionPlan, stats: VertexStats) -> float:
    """Expected-error model with BOTH collision terms (beyond paper Eq. 5):

        E(S, w) = R(S)/w + X(S)/w^2
        R(S) = sum_m d(m)(d(m)-1)          row-mates: same source, 1/w
        X(S) = F(S) * sum_m d(m)^2/f(m)    strangers: both hashes, 1/w^2

    The paper's model keeps only a 1/w term; the two-term model correctly
    prefers NOT splitting when frequencies are uniform (splitting shrinks
    widths without any homogeneity gain)."""
    vert = np.asarray(stats.vertex)
    freq = np.asarray(stats.freq, np.float64)
    deg = np.asarray(stats.deg, np.float64)
    by_id = {int(v): i for i, v in enumerate(vert)}
    total = 0.0
    for p in plan.partitions:
        if len(p.vertices) == 0 or p.width <= 0:
            continue
        idx = np.asarray([by_id[int(v)] for v in p.vertices])
        f, d_ = freq[idx], deg[idx]
        r_term = float((d_ * (d_ - 1.0)).sum())
        x_term = float(f.sum() * (d_ * d_ / np.maximum(f, 1e-9)).sum())
        total += r_term / p.width + x_term / (p.width**2)
    return total


def plan_partitions_auto(
    stats: VertexStats,
    total_width: int,
    *,
    square: bool = True,
    min_width: int = 8,
    outlier_frac: float | None = None,
    candidates: tuple[int, ...] = (1, 2, 4, 8, 16),
) -> PartitionPlan:
    """Adaptive partitioner: build banded plans for several band counts
    (1 band ~= a global sketch + outlier) and keep the plan with the best
    two-term modeled error. On frequency-uniform streams this collapses to
    no-split (matching gMatrix instead of losing to it); on skewed streams
    it keeps the banded win."""
    best, best_score = None, np.inf
    for k in candidates:
        plan = plan_partitions_banded(
            stats, total_width, square=square, n_bands=k,
            min_width=min_width, outlier_frac=outlier_frac,
        )
        score = _two_term_score(plan, stats)
        if score < best_score:
            best, best_score = plan, score
    return best


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Deterministic hash-band routing of edges to ``n_shards`` sketch shards.

    The scale-out layer ABOVE the intra-sketch partition plan: a whole edge
    (not a counter) is owned by exactly one shard, chosen by a
    multiply-shift hash band of its SOURCE vertex.  Routing by source is the
    invariant every sharded query leans on (DESIGN.md §Sharding): all
    out-edges of a vertex land in one shard, so edge-frequency and
    node-out-degree queries are answerable by the owning shard alone, and
    because the shards partition the stream, the merge of all shard sketches
    (same layout, same hash family) is bit-identical to a single sketch that
    ingested the whole stream.

    The hash constants derive only from ``(seed, n_shards)``, independent of
    any sketch's hash family, so re-seeding a sketch never re-routes the
    stream.  Host-side numpy, line for line the JAX package's, so both
    packages route every id (negative ones wrap as uint32) to one shard.
    """

    n_shards: int
    seed: int = 0

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        rng = np.random.default_rng((self.seed << 8) ^ 0x5A17D)
        object.__setattr__(
            self, "_a", np.uint32(int(rng.integers(0, 1 << 32)) | 1))
        object.__setattr__(
            self, "_b", np.uint32(int(rng.integers(0, 1 << 32))))

    def shard_of(self, src) -> np.ndarray:
        """Owning shard for each source vertex (scalar or any-shape array)."""
        x = np.asarray(src, dtype=np.uint32)
        with np.errstate(over="ignore"):
            h = self._a * x + self._b
            h ^= h >> np.uint32(16)
            h *= np.uint32(0x7FEB352D)
            h ^= h >> np.uint32(15)
        # fastrange: (h * K) >> 32 maps uniformly onto [0, n_shards)
        band = (h.astype(np.uint64) * np.uint64(self.n_shards)) >> np.uint64(32)
        return band.astype(np.int32)

    def shard_of_one(self, src: int) -> int:
        return int(self.shard_of(np.asarray([src], dtype=np.int64))[0])


def plan_for(
    partitioner: str,
    stats: VertexStats,
    total_width: int,
    *,
    square: bool,
    min_width: int = 8,
    outlier_frac: float | None = None,
    max_partitions: int = 64,
    n_bands: int = 16,
) -> PartitionPlan:
    """Dispatch to a named partitioner with its mode-specific knobs.

    Shared by both kMatrix backends (``core.kmatrix`` flat pool,
    ``core.kmatrix_accel`` width classes) so a backend switch never changes
    which plan a given configuration produces.  The greedy recursion floors
    ``min_width`` at 16: below that its equal binary splits produce slabs
    too small to be worth the routing entry.
    """
    if partitioner == "greedy":
        return plan_partitions(
            stats, total_width, square=square, max_partitions=max_partitions,
            min_width=max(min_width, 16), outlier_frac=outlier_frac)
    if partitioner == "banded":
        return plan_partitions_banded(
            stats, total_width, square=square, n_bands=n_bands,
            min_width=min_width, outlier_frac=outlier_frac)
    if partitioner == "auto":
        return plan_partitions_auto(
            stats, total_width, square=square, min_width=min_width,
            outlier_frac=outlier_frac)
    raise ValueError(f"unknown partitioner {partitioner!r}")
