"""kMatrix width-class layout — the sketch whose ingest runs the
hand-written ``matrix_ingest_edges`` kernel and whose edge and node-out
queries run ``kmatrix_lookup_edges`` and ``kmatrix_node_out``.

``KMatrixAccel`` stores the same counters as the flat-pool ``KMatrix``
(``repro_torch.core.kmatrix``) in a different arrangement: partition widths
are quantized down to power-of-two *width classes*, and every partition of
width ``w_c`` lives as one row of a rectangular pool int32[d, P_c, w_c, w_c].
Ingest is one kernel launch per batch that routes, hashes and adds each
edge (``repro_torch.kernels.ops.kmatrix_accel_ingest``); the JAX package's
per-class ``(P_c, capacity)`` rectangles survive as
``kernels.ops.rectangle_ingest``, on no path.  A point query is one launch
that routes, hashes, gathers from the query's class pool and takes the min
over layers (``kernels/matrix_lookup.py``); the JAX package's per-class
gathers are those kernels' plain versions, which a CPU sketch runs.

Layout equivalence: cell ``(hi, hj)`` of partition ``p`` is
``pools[class(p)][d, index(p), hi, hj]`` here and
``pool[d, offset(p) + hi*w_p + hj]`` in the flat layout;
``to_flat_layout`` / ``to_class_layout`` apply that permutation bit-exactly.

``ingest`` adds into the sketch's tensors in place (the JAX package returns
new arrays); ``empty_like`` and ``merge`` return fresh storage.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.hashing import HashFamily, families_match, fastrange
from repro_torch.common.struct import static_field, tensor_dataclass
from repro_torch.core.kmatrix import KMatrix
from repro_torch.core.matrix_sketch import _int32
from repro_torch.core.partitioning import good_turing_outlier_share, plan_for
from repro_torch.core.routing import RouteTable, routes_match
from repro_torch.core.types import EdgeBatch, VertexStats
from repro_torch.kernels.matrix_lookup import kmatrix_lookup_edges, kmatrix_node_out
from repro_torch.obs.profile import profile_span

BACKENDS = ("width_class", "flat")


def sketch_backend(backend: str | None = None) -> str:
    """Resolve the kMatrix layout: the width-class layout unless the caller
    names ``"flat"``.  There is no per-device default."""
    backend = backend or "width_class"
    if backend not in BACKENDS:
        raise ValueError(f"unknown sketch backend {backend!r} "
                         f"(expected one of {BACKENDS})")
    return backend


@tensor_dataclass
class KMatrixAccel:
    """kMatrix with power-of-two width classes.

    ``pools[c]`` holds every partition of width ``class_widths[c]`` as one
    rectangular tensor int32[d, P_c, w_c, w_c].  ``part_class``/``part_index``
    map a global partition id to (class, row-within-class).  ``overflow``
    counts ingest updates beyond the per-partition dispatch capacity (those
    that take the exact scatter fallback of the JAX package's rectangle
    dispatch) — a diagnostic, never a correctness term: every edge is
    counted exactly either way.
    """

    pools: tuple  # tuple[int32[d, P_c, w_c, w_c], ...]
    conn: torch.Tensor  # int32[d, cw, cw]
    overflow: torch.Tensor  # int32[] scatter-fallback updates (diagnostic)
    hashes: HashFamily
    route: RouteTable  # offsets/widths are the flat-twin layout (see create)
    part_class: torch.Tensor  # int32[P]
    part_index: torch.Tensor  # int32[P]
    part_width: torch.Tensor  # int32[P]
    class_widths: tuple = static_field()
    class_counts: tuple = static_field()
    conn_w: int = static_field()
    # Expected per-partition share of stream edges, from the partition plan
    # (sampled frequency mass per partition, Good-Turing share for the
    # outlier).  Sizes the ingest dispatch capacity.  None on sketches
    # relayouted from a flat pool (no sample): those use the uniform 2B/P.
    load_shares: tuple | None = static_field(default=None)

    @property
    def depth(self) -> int:
        return self.conn.shape[0] if self.conn.ndim == 3 else self.pools[0].shape[0]

    @property
    def num_counters(self) -> int:
        return sum(p.numel() for p in self.pools) + self.conn.numel()

    @staticmethod
    def create(
        *,
        bytes_budget: int,
        stats: VertexStats,
        depth: int = 7,
        seed: int = 0,
        partitioner: str = "auto",
        n_bands: int = 16,
        max_partitions: int = 64,
        min_width: int = 8,
        conn_frac: float = 0.1,
        outlier_frac: float | None = None,
        device="cuda",
    ) -> "KMatrixAccel":
        counters = bytes_budget // 4
        per_layer = max(counters // depth, 4)
        conn_w = int(np.sqrt(per_layer * conn_frac)) if conn_frac > 0 else 0
        total_width = max(int(np.sqrt(per_layer - conn_w * conn_w)), 2)
        plan = plan_for(
            partitioner, stats, total_width, square=True, n_bands=n_bands,
            max_partitions=max_partitions, min_width=min_width,
            outlier_frac=outlier_frac,
        )
        # Quantize each width DOWN to a power of two (keeps the budget).
        widths = np.asarray([1 << (int(p.width).bit_length() - 1)
                             for p in plan.partitions], dtype=np.int32)
        part_class, part_index, classes, counts = _class_structure(widths)
        # offsets are the FLAT layout's (cumsum of w_p^2 slabs) even though
        # the class layout never reads them: one route table serves both
        # layouts, so to_flat_layout places every slab where kmatrix expects.
        slab = widths.astype(np.int64) ** 2
        offsets = np.concatenate([[0], np.cumsum(slab)[:-1]]).astype(np.int32)

        def put(x):
            return torch.as_tensor(x, device=device)

        route = RouteTable(
            keys=put(plan.route_keys),
            part=put(plan.route_part),
            offsets=put(offsets),
            widths=put(widths),
            outlier=plan.outlier,
            n_partitions=len(widths),
            max_width=int(widths.max()),
        )
        pools = tuple(
            torch.zeros((depth, counts[c], classes[c], classes[c]),
                        dtype=torch.int32, device=device)
            for c in range(len(classes)))
        return KMatrixAccel(
            pools=pools,
            conn=torch.zeros((depth, conn_w, conn_w), dtype=torch.int32,
                             device=device),
            overflow=torch.zeros((), dtype=torch.int32, device=device),
            hashes=HashFamily.create(seed, depth, device=device),
            route=route,
            part_class=put(part_class),
            part_index=put(part_index),
            part_width=put(widths),
            class_widths=tuple(classes),
            class_counts=tuple(counts),
            conn_w=conn_w,
            load_shares=_plan_load_shares(plan, stats),
        )


def _plan_load_shares(plan, stats: VertexStats) -> tuple:
    """Expected stream-edge share per partition, from the sample.

    Sampled partitions split the SEEN share of the stream proportionally to
    their sampled frequency mass; the outlier partition's share is the
    Good-Turing estimate of unseen-source traffic.  Static Python floats.
    """
    vert = np.asarray(stats.vertex)  # sorted unique
    freq = np.asarray(stats.freq, np.float64)
    total = max(float(freq.sum()), 1e-9)
    unseen = good_turing_outlier_share(freq)
    shares = []
    for p in plan.partitions[:-1]:
        pos = np.searchsorted(vert, np.asarray(p.vertices))
        shares.append(float(freq[pos].sum()) / total * (1.0 - unseen))
    shares.append(float(unseen))  # outlier partition (appended last)
    return tuple(round(s, 6) for s in shares)


def dispatch_capacity(sk: KMatrixAccel, batch_size: int,
                      block_b: int = 128) -> int:
    """Per-partition ingest dispatch capacity for one batch of ``batch_size``.

    The hottest partition's expected share (``load_shares``) with 2x
    headroom, capped at the batch size (capacity == B guarantees no overflow
    tail); the uniform ``2B/P`` only for sketches without a sample.  Rounded
    up to ``block_b`` as the JAX package's kernel grid requires, so both
    packages dispatch the same rectangles.
    """
    if sk.load_shares:
        cap = int(np.ceil(2.0 * max(sk.load_shares) * batch_size))
        cap = min(cap, batch_size)
    else:
        cap = (2 * batch_size) // max(sk.route.n_partitions, 1)
    cap = max(cap, min(block_b, batch_size))
    return -(-cap // block_b) * block_b


def _class_structure(widths: np.ndarray):
    """Group partition widths into sorted classes.

    Returns (part_class, part_index, class_widths, class_counts): classes
    ascend by width; within a class, rows follow global partition order.
    """
    classes = sorted(set(int(w) for w in widths))
    part_class = np.asarray([classes.index(int(w)) for w in widths], np.int32)
    part_index = np.zeros(len(widths), np.int32)
    counts = []
    for c in range(len(classes)):
        members = np.nonzero(part_class == c)[0]
        part_index[members] = np.arange(len(members))
        counts.append(len(members))
    return part_class, part_index, classes, counts


# --------------------------------------------------------------- protocol --

def ingest(sk: KMatrixAccel, batch: EdgeBatch, *,
           capacity: int | None = None,
           block_b: int = 128) -> KMatrixAccel:  # writes: 0
    """Exact batched ingest through one ``matrix_ingest_edges`` launch, in
    place; returns ``sk``.  See ``kernels.ops.kmatrix_accel_ingest``."""
    from repro_torch.kernels.ops import kmatrix_accel_ingest

    with profile_span("sketch.ingest"):
        return kmatrix_accel_ingest(sk, batch, capacity=capacity,
                                    block_b=block_b)


def edge_freq(sk: KMatrixAccel, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Point queries on the class layout, ``src`` and ``dst`` of one shape;
    shape-preserving.  One ``kmatrix_lookup_edges`` launch on a CUDA sketch
    (routing, hashing, the class table's gather and the min over layers);
    the plain per-class gathers on the CPU."""
    with profile_span("query.edge_freq"):
        est = kmatrix_lookup_edges(
            sk.pools, sk.hashes.a, sk.hashes.b, _int32(src), _int32(dst),
            route=sk.route, part_class=sk.part_class,
            part_index=sk.part_index)
        return est.view(src.shape)


def node_out_freq(sk: KMatrixAccel, v: torch.Tensor) -> torch.Tensor:
    """Row-sum of v's row inside its class block, min over layers;
    bit-identical to ``kmatrix.node_out_freq`` on the flat twin.  One
    ``kmatrix_node_out`` launch on a CUDA sketch, the plain per-class
    gathers on the CPU; shape-preserving."""
    with profile_span("query.node_freq"):
        est = kmatrix_node_out(
            sk.pools, sk.hashes.a, sk.hashes.b, _int32(v), route=sk.route,
            part_class=sk.part_class, part_index=sk.part_index)
        return est.view(v.shape)


def conn_cells(sk: KMatrixAccel, v: torch.Tensor) -> torch.Tensor:
    """Per-layer slot of vertex ``v`` in the global connectivity matrix."""
    return fastrange(sk.hashes.mix(v), sk.conn_w)


def empty_like(sk: KMatrixAccel) -> KMatrixAccel:
    """A zero-counter sketch sharing ``sk``'s layout, routing and hashes.

    The counters are fresh storage, never an alias of ``sk``'s: an in-place
    ingest into the result leaves ``sk`` unchanged.
    """
    with profile_span("sketch.empty_like"):
        return sk.replace(
            pools=tuple(torch.zeros_like(p) for p in sk.pools),
            conn=torch.zeros_like(sk.conn),
            overflow=torch.zeros_like(sk.overflow),
        )


def merge(a: KMatrixAccel, b: KMatrixAccel) -> KMatrixAccel:
    """Counter-additivity over class pools, into fresh tensors.  Same
    rejection rules as ``kmatrix.merge``."""
    if (a.class_widths != b.class_widths or a.class_counts != b.class_counts
            or a.conn_w != b.conn_w):
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
    with profile_span("sketch.merge"):
        return a.replace(
            pools=tuple(pa + pb for pa, pb in zip(a.pools, b.pools)),
            conn=a.conn + b.conn,
            overflow=a.overflow + b.overflow,
        )


# ------------------------------------------------------------- relayout ----

def to_flat_layout(sk: KMatrixAccel) -> KMatrix:
    """Bit-exact relayout: class pools -> the flat-pool ``KMatrix`` twin.

    Cell ``(hi, hj)`` of partition ``p`` moves from
    ``pools[class(p)][:, index(p)]`` to ``pool[:, offset(p) + hi*w_p + hj]``.
    The route table, hashes and the ``overflow`` tally carry over; the
    counters (pool and conn) are fresh storage.
    """
    d = sk.depth
    widths = sk.part_width.cpu().numpy()
    offsets = sk.route.offsets.cpu().numpy()
    part_class = sk.part_class.cpu().numpy()
    part_index = sk.part_index.cpu().numpy()
    pool_size = int((widths.astype(np.int64) ** 2).sum())
    pool = torch.zeros((d, pool_size), dtype=torch.int32, device=sk.conn.device)
    for p in range(sk.route.n_partitions):
        w = int(widths[p])
        off = int(offsets[p])
        block = sk.pools[int(part_class[p])][:, int(part_index[p])]
        pool[:, off:off + w * w] = block.reshape(d, w * w)
    return KMatrix(
        pool=pool,
        conn=sk.conn.clone(),
        overflow=sk.overflow.clone(),
        hashes=sk.hashes,
        route=sk.route,
        pool_size=pool_size,
        conn_w=sk.conn_w,
    )


def to_class_layout(sk: KMatrix, *, overflow: int | None = None) -> KMatrixAccel:
    """Bit-exact relayout: flat pool -> width-class pools (inverse of
    ``to_flat_layout``).

    The flat sketch must be a *class-layout twin*: every partition width a
    power of two and offsets the standard ``cumsum(w^2)`` slabs.  The
    overflow tally defaults to the flat sketch's own; ``overflow`` overrides.
    """
    widths = sk.route.widths.cpu().numpy()
    if len(widths) == 0:
        raise ValueError("to_class_layout: empty partition plan")
    if np.any((widths & (widths - 1)) != 0) or np.any(widths < 1):
        raise ValueError(
            f"to_class_layout: widths {widths.tolist()} are not all powers "
            "of two — this flat sketch was not built from a width-class "
            "plan; rebuild it with the width-class layout instead")
    slab = widths.astype(np.int64) ** 2
    expect_off = np.concatenate([[0], np.cumsum(slab)[:-1]])
    if not np.array_equal(sk.route.offsets.cpu().numpy(), expect_off):
        raise ValueError(
            "to_class_layout: route offsets are not the standard cumsum "
            "slab layout; refusing a lossy relayout")
    part_class, part_index, classes, counts = _class_structure(widths)
    d = sk.depth
    device = sk.pool.device
    pools = []
    for c, w_c in enumerate(classes):
        members = np.nonzero(part_class == c)[0]
        blocks = [sk.pool[:, int(expect_off[p]):int(expect_off[p]) + w_c * w_c]
                  .reshape(d, w_c, w_c) for p in members]
        pools.append(torch.stack(blocks, dim=1))
    if overflow is None:
        overflow_t = sk.overflow.clone()
    else:
        overflow_t = torch.tensor(overflow, dtype=torch.int32, device=device)
    return KMatrixAccel(
        pools=tuple(pools),
        conn=sk.conn.clone(),
        overflow=overflow_t,
        hashes=sk.hashes,
        route=sk.route,
        part_class=torch.as_tensor(part_class, device=device),
        part_index=torch.as_tensor(part_index, device=device),
        part_width=torch.as_tensor(widths.astype(np.int32), device=device),
        class_widths=tuple(classes),
        class_counts=tuple(counts),
        conn_w=sk.conn_w,
    )
