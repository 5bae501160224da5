"""Plain NumPy reference of a sketch's plan: the sample, the vertex
statistics, the banded partition plan, the width classes, the hash family
and the routing.

Frozen copies (commit cbdfd1d8e666db7c6b1c59ee99c9e22d4d3a7c8d) of
``src/repro_torch/streams/reservoir.py`` (``Reservoir.offer_batch``,
``sample_stream``), ``core/types.py`` (``vertex_stats_from_sample``),
``core/partitioning.py`` (``good_turing_outlier_share``,
``plan_partitions_banded``), ``core/kmatrix_accel.py`` (``KMatrixAccel.create``'s
sizing and ``_class_structure``), ``core/matrix_sketch.py``
(``MatrixSketch.create``'s width) and ``common/hashing.py``
(``sample_hash_params`` and the uint32 mix), written over NumPy alone.  It
imports nothing of the program and takes nothing the program made: only the
benchmark's stream and the configuration.
"""
from __future__ import annotations

import dataclasses

import numpy as np

XS_MUL = np.uint32(0x7FEB352D)


# ---------------------------------------------------------------- sample --

def reservoir_sample(batches, k: int, seed: int):
    """Vectorized Algorithm R over ``batches`` of (src, dst, weight), one
    ``offer`` per batch in order, the RNG keyed with ``seed ^ 0x5EED``:
    (src, dst, weight) of the ``min(seen, k)`` kept edges."""
    rng = np.random.default_rng(np.random.Philox(key=seed ^ 0x5EED))
    keep_src = np.zeros(k, np.int32)
    keep_dst = np.zeros(k, np.int32)
    keep_w = np.zeros(k, np.int32)
    seen = 0
    for src, dst, w in batches:
        live = w > 0
        src, dst, w = src[live], dst[live], w[live]
        if seen < k:
            take = min(k - seen, len(src))
            keep_src[seen:seen + take] = src[:take]
            keep_dst[seen:seen + take] = dst[:take]
            keep_w[seen:seen + take] = w[:take]
            seen += take
            src, dst, w = src[take:], dst[take:], w[take:]
        n = len(src)
        if n == 0:
            continue
        t = seen + np.arange(1, n + 1, dtype=np.float64)
        accept = rng.random(n) < (k / t)
        slots = rng.integers(0, k, size=n)
        idx = np.nonzero(accept)[0]
        if idx.size:
            # the last accepted item aiming at a slot wins
            uniq, last_rev = np.unique(slots[idx][::-1], return_index=True)
            winners = idx[idx.size - 1 - last_rev]
            keep_src[uniq] = src[winners]
            keep_dst[uniq] = dst[winners]
            keep_w[uniq] = w[winners]
        seen += n
    m = min(seen, k)
    return keep_src[:m], keep_dst[:m], keep_w[:m]


def vertex_stats(src, dst, weight):
    """(vertex, freq, deg): sorted unique sources, their summed sampled
    weight and their number of distinct sampled destinations (float32)."""
    order = np.argsort(src, kind="stable")
    s, d, w = src[order], dst[order], weight[order]
    verts, starts = np.unique(s, return_index=True)
    ends = np.append(starts[1:], len(s))
    freq = np.add.reduceat(w.astype(np.int64), starts).astype(np.float32)
    deg = np.asarray([len(np.unique(d[lo:hi])) for lo, hi in zip(starts, ends)],
                     np.float32)
    return verts.astype(np.int32), freq, deg


# ----------------------------------------------------------------- plan ---

def good_turing_share(freq: np.ndarray) -> float:
    n = float(freq.sum())
    if n <= 0:
        return 0.5
    n1 = float((freq <= 1.0).sum())
    return float(np.clip(n1 / n, 0.05, 0.6))


def banded_plan(vertex, freq, deg, total_width: int, *, n_bands: int,
                min_width: int):
    """The banded partitioner for square (w x w) partitions: equal-count
    bands of the average-frequency order, areas by the sqrt-G rule, the
    outlier partition last.  Returns (route_keys, route_part, widths,
    outlier) with route_keys sorted."""
    freq = np.asarray(freq, np.float64)
    deg = np.asarray(deg, np.float64)
    outlier_frac = good_turing_share(freq)
    order = np.argsort(freq / np.maximum(deg, 1.0), kind="stable")
    v, f, d = vertex[order], freq[order], deg[order]
    bounds = np.linspace(0, len(v), n_bands + 1).astype(int)
    groups, gs = [], []
    for i in range(n_bands):
        lo, hi = bounds[i], bounds[i + 1]
        if hi <= lo:
            continue
        g = f[lo:hi].sum() * float((d[lo:hi] ** 2
                                    / np.maximum(f[lo:hi], 1e-9)).sum())
        groups.append((lo, hi))
        gs.append(max(g, 1e-9))
    gs = np.asarray(gs)
    area = float(total_width) ** 2
    out_area = area * outlier_frac
    alloc = (area - out_area) * np.sqrt(gs) / np.sqrt(gs).sum()
    widths = np.maximum(np.sqrt(alloc).astype(np.int64), min_width)
    out_w = max(int(np.sqrt(out_area)), min_width)
    all_w = np.concatenate([widths, [out_w]])
    improved = True
    while improved:  # spend the floors' remainder widening leaves
        improved = False
        for i in np.argsort(all_w):
            if int((all_w ** 2).sum()) + 2 * int(all_w[i]) + 1 <= area:
                all_w[i] += 1
                improved = True
    keys = np.concatenate([v[lo:hi] for lo, hi in groups]).astype(np.int32)
    parts = np.concatenate([np.full(hi - lo, p, np.int32)
                            for p, (lo, hi) in enumerate(groups)])
    o = np.argsort(keys, kind="stable")
    return keys[o], parts[o], all_w.astype(np.int64), len(groups)


# --------------------------------------------------------------- hashing --

def hash_params(seed: int, depth: int):
    """(a, b) uint32[depth] of the multiply-shift family; ``a`` odd."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, size=depth, dtype=np.uint32) | np.uint32(1)
    b = rng.integers(0, 1 << 32, size=depth, dtype=np.uint32)
    return a, b


def mix(a, b, x) -> np.ndarray:
    """uint32[d, *S]: h = a*x + b; h ^= h >> 16; h *= 0x7FEB352D;
    h ^= h >> 15, for each of the d functions."""
    x = np.asarray(x).astype(np.uint32)
    shape = (-1,) + (1,) * x.ndim
    with np.errstate(over="ignore"):
        h = a.reshape(shape) * x[None] + b.reshape(shape)
        h = h ^ (h >> np.uint32(16))
        h = h * XS_MUL
        h = h ^ (h >> np.uint32(15))
    return h


def fastrange(h: np.ndarray, w) -> np.ndarray:
    """(h * w) >> 32 in int64 (h uint32, w < 2^31, int or array)."""
    return (h.astype(np.int64) * np.asarray(w, np.int64)) >> 32


# ----------------------------------------------------------------- plans --

@dataclasses.dataclass
class Plan:
    """What a configuration's sketch is, worked out from the inputs.

    ``kind`` "kmatrix": ``widths[p]`` (powers of two) of the P partitions,
    ``route_keys``/``route_part`` the sorted vertex -> partition map (others
    go to ``outlier``), ``class_widths``/``class_counts``/``part_class``/
    ``part_index`` the width-class arrangement, ``conn_w`` the
    connectivity matrix.  ``kind`` "gmatrix": one ``w`` x ``w`` table.
    """

    kind: str
    depth: int
    a: np.ndarray
    b: np.ndarray
    w: int = 0
    route_keys: np.ndarray | None = None
    route_part: np.ndarray | None = None
    outlier: int = 0
    widths: np.ndarray | None = None
    class_widths: tuple = ()
    class_counts: tuple = ()
    part_class: np.ndarray | None = None
    part_index: np.ndarray | None = None
    conn_w: int = 0

    def route(self, v) -> np.ndarray:
        """Partition of each vertex in ``v`` (int64)."""
        v = np.asarray(v, np.int64)
        keys = self.route_keys.astype(np.int64)
        if len(keys) == 0:
            return np.full(v.shape, self.outlier, np.int64)
        pos = np.clip(np.searchsorted(keys, v), 0, len(keys) - 1)
        return np.where(keys[pos] == v, self.route_part[pos].astype(np.int64),
                        self.outlier)


def class_structure(widths: np.ndarray):
    """Classes ascend by width; within a class, rows follow partition
    order.  Returns (part_class, part_index, class_widths, class_counts)."""
    classes = sorted(set(int(w) for w in widths))
    part_class = np.asarray([classes.index(int(w)) for w in widths], np.int64)
    part_index = np.zeros(len(widths), np.int64)
    counts = []
    for c in range(len(classes)):
        members = np.nonzero(part_class == c)[0]
        part_index[members] = np.arange(len(members))
        counts.append(len(members))
    return part_class, part_index, tuple(classes), tuple(counts)


def make_plan(config: dict, sample_batches, seed: int) -> Plan:
    """The plan of ``config``'s sketch for ``seed``: the hash family from
    ``seed``; for the kMatrix, the plan from a reservoir sample (keyed
    ``seed + 1``) of ``sample_batches``, the stream as the program's
    sampler reads it."""
    kind = config["sketch"]
    depth = int(config["depth"])
    a, b = hash_params(seed, depth)
    counters = int(config["budget_kb"]) * 1024 // 4
    if kind == "gmatrix":
        w = max(int((counters // depth) ** 0.5), 2)
        return Plan("gmatrix", depth, a, b, w=w)
    if kind != "kmatrix" or config.get("sketch_backend") != "width_class":
        raise ValueError(f"no reference for sketch {kind!r} "
                         f"({config.get('sketch_backend')!r})")
    if config.get("partitioner") != "banded":
        raise ValueError(f"no reference for partitioner "
                         f"{config.get('partitioner')!r}")
    per_layer = max(counters // depth, 4)
    conn_frac = float(config.get("conn_frac", 0.1))
    conn_w = int(np.sqrt(per_layer * conn_frac)) if conn_frac > 0 else 0
    total_width = max(int(np.sqrt(per_layer - conn_w * conn_w)), 2)
    from portbench.traffic.stream import sample_size
    vert, freq, deg = vertex_stats(*reservoir_sample(
        sample_batches, sample_size(config), seed + 1))
    keys, parts, widths, outlier = banded_plan(
        vert, freq, deg, total_width, n_bands=int(config.get("n_bands", 16)),
        min_width=int(config.get("min_width", 8)))
    # each width quantized down to a power of two
    widths = np.asarray([1 << (int(w).bit_length() - 1) for w in widths],
                        np.int64)
    part_class, part_index, classes, counts = class_structure(widths)
    return Plan("kmatrix", depth, a, b, route_keys=keys, route_part=parts,
                outlier=outlier, widths=widths, class_widths=classes,
                class_counts=counts, part_class=part_class,
                part_index=part_index, conn_w=conn_w)
