"""Bindings of the port's kernels to sketch state.

* ``accel_matrix_ingest`` / ``accel_matrix_edge_freq``: the global
  (d, w, w) matrix sketches (TCM / gMatrix), one ``matrix_ingest_edges``
  (P = 1) or ``matrix_lookup_edges`` launch, hashing in the kernel.  They
  are the sketch's own ``matrix_sketch.ingest`` / ``edge_freq``, named as
  the JAX package names them; the port takes any batch or query count, so
  there is no padding to a block.
* ``kmatrix_accel_ingest``: the width-class kMatrix ingest, one
  ``matrix_ingest_edges`` launch per batch that routes, hashes and adds
  every edge, updates ``conn`` and counts the ``overflow`` tally of the
  JAX package's dispatch.
* ``dispatch_rectangles`` / ``rectangle_ingest``: that dispatch as the
  TPU runs it (``repro/kernels/ops.py``): edges bucketed into per-class
  ``(P_c, capacity)`` rectangles, one ``matrix_ingest`` launch per class,
  an exact scatter for the edges beyond a partition's capacity, tallied in
  ``overflow``.  Bit-identical to the JAX package and to
  ``kmatrix_accel_ingest``; on no path of the port, it holds
  ``matrix_ingest`` and the edge ingest to the reference's rectangles.
* ``accel_reach_closure``: boolean closure of every layer: one
  ``reach_closure`` launch where a layer fits one block's shared memory,
  else one ``reach_step`` launch per squaring.
* ``embedding_bag`` and ``kmatrix_accel_edge_freq`` (the width-class
  kMatrix's edge queries, one ``kmatrix_lookup_edges`` launch on the card;
  gathers outside any kernel in the JAX package): re-exported, as the JAX
  package's ``ops`` does; the FM (``models/recsys/fm.py``) calls the bag.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.common.hashing import fastrange
from repro_torch.core.kmatrix_accel import KMatrixAccel, dispatch_capacity
from repro_torch.core.kmatrix_accel import edge_freq as kmatrix_accel_edge_freq
from repro_torch.core.matrix_sketch import edge_freq as accel_matrix_edge_freq
from repro_torch.core.matrix_sketch import ingest as accel_matrix_ingest
from repro_torch.core.types import EdgeBatch
from repro_torch.kernels.embedding_bag import embedding_bag
from repro_torch.kernels.matrix_ingest import matrix_ingest, matrix_ingest_edges
from repro_torch.kernels.reach_closure import (
    closure_cascade,
    closure_fits,
    reach_closure,
    reach_step,
)

__all__ = ["accel_matrix_edge_freq", "accel_matrix_ingest",
           "accel_reach_closure", "dispatch_rectangles", "embedding_bag",
           "kmatrix_accel_edge_freq", "kmatrix_accel_ingest",
           "rectangle_ingest"]


def accel_reach_closure(table: torch.Tensor, *, n_steps: int | None = None,
                        step=reach_step) -> torch.Tensor:
    """Boolean closure of every layer of int32[d, w, w] -> bool[d, w, w].

    ``step`` squares all layers once: the ``reach_step`` kernel wrapper, or
    ``reach_step_plain`` for the plain PyTorch cascade.  With the kernel, a
    table whose layers fit one block (``closure_fits``) is closed by one
    ``reach_closure`` launch instead of the cascade.
    """
    w = table.shape[-1]
    steps = n_steps if n_steps is not None else max(1, (w - 1).bit_length())
    if step is reach_step and closure_fits(w):
        return reach_closure(table, steps)
    return closure_cascade(table, steps, step)


def _capacity(sk: KMatrixAccel, b: int, capacity: int | None,
              block_b: int) -> int:
    """The dispatch capacity of a batch of ``b``, rounded up to ``block_b``
    as the JAX package's kernel grid requires."""
    if capacity is None:
        capacity = dispatch_capacity(sk, b, block_b)
    return -(-capacity // block_b) * block_b


def kmatrix_accel_ingest(sk: KMatrixAccel, batch: EdgeBatch, *,
                         capacity: int | None = None,
                         block_b: int = 128) -> KMatrixAccel:  # writes: 0
    """Exact batched ingest, in place, in one ``matrix_ingest_edges``
    launch; returns ``sk``.

    Only edges with positive weight reach the pools (as in the JAX
    package, whose dispatch parks weight <= 0 as padding); ``conn`` takes
    every weight.  ``capacity`` sets only the ``overflow`` tally, which
    gains what ``rectangle_ingest`` at that capacity counts.
    """
    matrix_ingest_edges(
        sk.pools, sk.hashes.a, sk.hashes.b, batch.src, batch.dst,
        batch.weight, route=sk.route, part_class=sk.part_class,
        part_index=sk.part_index, conn=sk.conn, overflow=sk.overflow,
        capacity=_capacity(sk, batch.size, capacity, block_b))
    return sk


class Rectangles(NamedTuple):
    """One batch bucketed as the TPU's dispatch buckets it."""

    rects: list  # per class (hi, hj, wt) for matrix_ingest, None if empty
    over: torch.Tensor  # bool[B]: live edges beyond their partition's capacity
    part: torch.Tensor  # int32[B]: each edge's partition (padding clamped)
    mix: torch.Tensor  # int64[d, 2, B]: mix of src and dst


def dispatch_rectangles(sk: KMatrixAccel, batch: EdgeBatch,
                        capacity: int) -> Rectangles:
    """Bucket edges into per-class ``(P_c, capacity)`` rectangles.

    Each edge's stable rank within its partition comes from one stable
    argsort and a running max of group starts; class ``c``'s rectangles
    are hi/hj int32[d, P_c, capacity] and wt int32[P_c, capacity] (0 in
    empty slots).  Padding (weight <= 0) is parked at partition P.
    """
    p = sk.route.lookup(batch.src)  # [B]
    live = batch.weight > 0
    p = torch.where(live, p, sk.route.n_partitions)
    order = torch.argsort(p, stable=True)
    p_sorted = p[order]
    b = p.shape[0]
    pos = torch.arange(b, dtype=torch.int32, device=p.device)
    is_start = torch.ones(b, dtype=torch.bool, device=p.device)
    is_start[1:] = p_sorted[1:] != p_sorted[:-1]
    start_of_group = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start_of_group
    in_cap = (rank < capacity) & live

    d = sk.depth
    dev = batch.src.device
    mix = sk.hashes.mix(torch.stack([batch.src, batch.dst]))  # [d, 2, B]
    # parked padding has p == P; clamp for the per-partition gathers (their
    # results are masked off, as JAX's clamping gathers are)
    p_c = p.clamp(max=sk.route.n_partitions - 1)
    cls = sk.part_class[p_c]
    # slot of each edge in its class's (P_c, capacity) rectangle
    slot = sk.part_index[p_c].long() * capacity + rank
    layer = torch.arange(d, device=dev)[:, None]
    rects = []
    for c, (w_c, n_c) in enumerate(zip(sk.class_widths, sk.class_counts)):
        if n_c == 0:
            rects.append(None)
            continue
        sel = in_cap & (cls == c)
        # Fill the rectangles through one spill cell past their end: every
        # unselected edge lands there and is cut off, and selected slots are
        # unique, so a plain scatter (no accumulation) is exact.
        n = n_c * capacity
        spill = d * n
        hij = fastrange(mix, w_c).permute(1, 0, 2)  # [2, d, B]: hi, hj
        cell = torch.where(sel, layer * n + slot, spill)  # [d, B]
        rect = torch.zeros((2, spill + 1), dtype=torch.int32, device=dev)
        rect.scatter_(1, cell.view(1, -1).expand(2, -1), hij.reshape(2, -1))
        wt = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        wt.scatter_(0, torch.where(sel, slot, n), batch.weight)
        rects.append((rect[0, :spill].view(d, n_c, capacity),
                      rect[1, :spill].view(d, n_c, capacity),
                      wt[:n].view(n_c, capacity)))
    return Rectangles(rects, (~in_cap) & live, p_c, mix)


def rectangle_ingest(sk: KMatrixAccel, batch: EdgeBatch, *,
                     capacity: int | None = None,
                     block_b: int = 128) -> KMatrixAccel:  # writes: 0
    """The ingest as the TPU runs it, in place; returns ``sk``:
    ``dispatch_rectangles``, one ``matrix_ingest`` per non-empty class, an
    exact scatter for the overflow tail, a ``scatter_add`` into ``conn``.
    Same result as ``kmatrix_accel_ingest``."""
    b = batch.size
    capacity = _capacity(sk, b, capacity, block_b)
    rect = dispatch_rectangles(sk, batch, capacity)
    for pool, args in zip(sk.pools, rect.rects):
        if args is not None:
            matrix_ingest(pool, *args)
    d = sk.depth
    if capacity < b:
        # Overflow tail: exact scatter (only when a partition exceeds
        # capacity; with capacity >= B no edge can).  The tally is
        # sk.overflow, so capacity regressions stay visible.
        sk.overflow.add_(rect.over.sum(dtype=torch.int32))
        hij = fastrange(rect.mix, sk.part_width[rect.part])  # [d, 2, B]
        idx = sk.part_index[rect.part]
        cls = sk.part_class[rect.part]
        for c, (w_c, n_c) in enumerate(zip(sk.class_widths, sk.class_counts)):
            if n_c == 0:
                continue
            # unselected edges add 0 at cell (0, 0, 0) of every layer
            sel = rect.over & (cls == c)
            cell = (torch.where(sel, idx, 0).long() * w_c
                    + torch.where(sel, hij[:, 0], 0)) * w_c \
                + torch.where(sel, hij[:, 1], 0)
            sk.pools[c].view(d, -1).scatter_add_(
                1, cell, torch.where(sel, batch.weight, 0).expand(d, b))

    if sk.conn_w > 0:
        cij = fastrange(rect.mix, sk.conn_w).long()
        sk.conn.view(d, -1).scatter_add_(
            1, cij[:, 0] * sk.conn_w + cij[:, 1], batch.weight.expand(d, b))
    return sk
