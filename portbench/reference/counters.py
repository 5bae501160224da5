"""Plain NumPy reference of the counters and of every query family.

Counters live in one flat int64 vector per sketch, in a layout of the
reference's own: for the kMatrix each partition's [d, w_p, w_p] block in
partition order, then the [d, cw, cw] connectivity matrix; for the gMatrix
the [d, w, w] table.  Sums are exact in int64, so a program that wraps an
int32 counter or sum reads differently here.

The semantics are the paper's (and the program's, ``core/kmatrix_accel.py``,
``core/matrix_sketch.py``, ``core/queries.py`` at commit
cbdfd1d8e666db7c6b1c59ee99c9e22d4d3a7c8d): an edge (s, t) of weight w > 0
adds w at (hi, hj) = (fastrange(h_r(s), w_p), fastrange(h_r(t), w_p)) of
layer r of its source's partition p, and every nonzero weight adds at
(fastrange(h_r(s), cw), fastrange(h_r(t), cw)) of the connectivity matrix;
a gMatrix adds every nonzero weight at (fastrange(h_r(s), w), ...).  A
point query is the minimum over layers; a node's out-weight the minimum
over layers of its row sum; reachability holds where the transitive closure
of every layer's (counters > 0) + I joins the two cells.
"""
from __future__ import annotations

import numpy as np

from portbench.reference.plan import Plan, fastrange, mix


class Layout:
    """Offsets of a plan's blocks in the flat vector."""

    def __init__(self, plan: Plan):
        self.plan = plan
        d = plan.depth
        if plan.kind == "kmatrix":
            sizes = d * plan.widths.astype(np.int64) ** 2
            self.part_off = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            self.conn_off = int(sizes.sum())
            self.size = self.conn_off + d * plan.conn_w ** 2
        else:
            self.size = d * plan.w ** 2

    def partition_block(self, flat: np.ndarray, p: int) -> np.ndarray:
        w = int(self.plan.widths[p])
        off = int(self.part_off[p])
        return flat[off:off + self.plan.depth * w * w].reshape(
            self.plan.depth, w, w)

    def conn_block(self, flat: np.ndarray) -> np.ndarray:
        cw = self.plan.conn_w
        return flat[self.conn_off:].reshape(self.plan.depth, cw, cw)

    def table(self, flat: np.ndarray) -> np.ndarray:
        w = self.plan.w
        return flat.reshape(self.plan.depth, w, w)


def batch_counters(layout: Layout, src, dst, weight) -> np.ndarray:
    """The flat int64 counters one batch adds."""
    plan = layout.plan
    d = plan.depth
    rows = np.arange(d, dtype=np.int64)[:, None]
    weight = np.asarray(weight, np.int64)
    hs, ht = mix(plan.a, plan.b, src), mix(plan.a, plan.b, dst)  # [d, n]
    nz = weight != 0
    if plan.kind == "gmatrix":
        w = plan.w
        idx = rows * w * w + fastrange(hs, w) * w + fastrange(ht, w)
        return np.bincount(idx[:, nz].ravel(),
                           np.broadcast_to(weight[nz], idx[:, nz].shape).ravel(),
                           minlength=layout.size).astype(np.int64)
    live = weight > 0
    p = plan.route(src)
    wp = plan.widths[p]  # [n]
    idx = (layout.part_off[p] + rows * wp * wp + fastrange(hs, wp) * wp
           + fastrange(ht, wp))
    cw = plan.conn_w
    cidx = (layout.conn_off + rows * cw * cw + fastrange(hs, cw) * cw
            + fastrange(ht, cw))
    out = np.bincount(idx[:, live].ravel(),
                      np.broadcast_to(weight[live], idx[:, live].shape).ravel(),
                      minlength=layout.size)
    if cw > 0:
        out = out + np.bincount(
            cidx[:, nz].ravel(),
            np.broadcast_to(weight[nz], cidx[:, nz].shape).ravel(),
            minlength=layout.size)
    # bincount sums weights in float64: exact below 2^53
    return np.rint(out).astype(np.int64)


def transitive_closure(layers: np.ndarray) -> np.ndarray:
    """bool[d, w, w]: the closure of each layer's (counters > 0) + I."""
    w = layers.shape[-1]
    reach = (layers > 0) | np.eye(w, dtype=bool)[None]
    while True:
        nxt = np.matmul(reach.astype(np.float32), reach.astype(np.float32)) > 0
        if np.array_equal(nxt, reach):
            return reach
        reach = nxt


class Answers:
    """Every query family over one flat counter vector."""

    def __init__(self, layout: Layout, flat: np.ndarray):
        self.layout = layout
        self.plan = layout.plan
        self.flat = flat
        self._cumsum = np.concatenate([[0], np.cumsum(flat)])
        self._closure = None

    def _cells(self, src, dst):
        """Flat indices [d, n] of the point-query cells of (src, dst)."""
        plan, lay = self.plan, self.layout
        rows = np.arange(plan.depth, dtype=np.int64)[:, None]
        hs, ht = mix(plan.a, plan.b, src), mix(plan.a, plan.b, dst)
        if plan.kind == "gmatrix":
            w = plan.w
            return rows * w * w + fastrange(hs, w) * w + fastrange(ht, w)
        p = plan.route(src)
        wp = plan.widths[p]
        return (lay.part_off[p] + rows * wp * wp + fastrange(hs, wp) * wp
                + fastrange(ht, wp))

    def edge_freq(self, src, dst) -> np.ndarray:
        src = np.asarray(src, np.int64).ravel()
        dst = np.asarray(dst, np.int64).ravel()
        return self.flat[self._cells(src, dst)].min(axis=0)

    def node_out(self, v) -> np.ndarray:
        plan, lay = self.plan, self.layout
        v = np.asarray(v, np.int64).ravel()
        rows = np.arange(plan.depth, dtype=np.int64)[:, None]
        hv = mix(plan.a, plan.b, v)
        if plan.kind == "gmatrix":
            w = np.int64(plan.w)
            start = rows * w * w + fastrange(hv, w) * w
        else:
            p = plan.route(v)
            w = plan.widths[p]
            start = lay.part_off[p] + rows * w * w + fastrange(hv, w) * w
        return (self._cumsum[start + w] - self._cumsum[start]).min(axis=0)

    def reach(self, src, dst) -> np.ndarray:
        plan = self.plan
        if self._closure is None:
            layers = (self.layout.table(self.flat) if plan.kind == "gmatrix"
                      else self.layout.conn_block(self.flat))
            self._closure = transitive_closure(layers)
        w = plan.w if plan.kind == "gmatrix" else plan.conn_w
        hs = fastrange(mix(plan.a, plan.b, np.asarray(src, np.int64)), w)
        ht = fastrange(mix(plan.a, plan.b, np.asarray(dst, np.int64)), w)
        rows = np.arange(plan.depth)[:, None]
        return self._closure[rows, hs, ht].all(axis=0)

    def heavy_nodes(self, universe: int, threshold: float):
        ids = np.arange(universe, dtype=np.int64)
        freq = self.node_out(ids)
        keep = freq >= threshold
        return ids[keep], freq[keep]
