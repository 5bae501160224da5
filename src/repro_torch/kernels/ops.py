"""Bindings of the port's kernels to sketch state.

* ``kmatrix_accel_ingest``: the width-class kMatrix ingest.  Edges are
  bucketed into per-class ``(P_c, capacity)`` rectangles and each non-empty
  class is one ``matrix_ingest`` launch; a sketch must count EVERY edge, so
  edges beyond a partition's capacity take an exact scatter fallback and
  are tallied in ``overflow``.  The dispatch is the JAX package's
  (``repro/kernels/ops.py``), so the rectangles and the tally are
  bit-identical to it.
* ``accel_reach_closure``: boolean closure of every layer, one
  ``reach_step`` launch per squaring.
"""
from __future__ import annotations

import torch

from repro_torch.common.hashing import fastrange
from repro_torch.core.kmatrix_accel import KMatrixAccel, dispatch_capacity
from repro_torch.core.types import EdgeBatch
from repro_torch.kernels.matrix_ingest import matrix_ingest
from repro_torch.kernels.reach_closure import reach_step


def accel_reach_closure(table: torch.Tensor, *, n_steps: int | None = None,
                        step=reach_step) -> torch.Tensor:
    """Boolean closure of every layer of int32[d, w, w] -> bool[d, w, w].

    ``step`` squares all layers once: the ``reach_step`` kernel wrapper, or
    ``reach_step_plain`` for the plain PyTorch cascade.
    """
    d, w, _ = table.shape
    eye = torch.eye(w, dtype=torch.float32, device=table.device)
    reach = torch.clamp((table > 0).to(torch.float32) + eye, max=1.0)
    steps = n_steps if n_steps is not None else max(1, (w - 1).bit_length())
    for _ in range(steps):
        reach = step(reach)
    return reach > 0.5


def _dispatch(sk: KMatrixAccel, batch: EdgeBatch, capacity: int):
    """Bucket edges into per-partition rectangles + overflow mask.

    Returns (part, rank, in_capacity): rank[e] is the edge's stable rank
    within its partition, computed with one stable argsort and a running
    max of group starts.  Padding (weight <= 0) is parked at partition P.
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
    return p, rank, in_cap


def kmatrix_accel_ingest(sk: KMatrixAccel, batch: EdgeBatch, *,
                         capacity: int | None = None,
                         block_b: int = 128) -> KMatrixAccel:
    """Exact batched ingest, in place: ``matrix_ingest`` for edges within
    capacity, a scatter for the overflow tail; returns ``sk``.

    Only edges with positive weight reach the pools (as in the JAX
    package, whose dispatch parks weight <= 0 as padding); ``conn`` takes
    every weight.
    """
    b = batch.size
    if capacity is None:
        capacity = dispatch_capacity(sk, b, block_b)
    capacity = -(-capacity // block_b) * block_b

    p, rank, in_cap = _dispatch(sk, batch, capacity)
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

    for c, (w_c, n_c) in enumerate(zip(sk.class_widths, sk.class_counts)):
        if n_c == 0:
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
        matrix_ingest(sk.pools[c], rect[0, :spill].view(d, n_c, capacity),
                      rect[1, :spill].view(d, n_c, capacity),
                      wt[:n].view(n_c, capacity))

    if capacity < b:
        # Overflow tail: exact scatter (only when a partition exceeds
        # capacity; with capacity >= B no edge can).  The tally is
        # sk.overflow, so capacity regressions stay visible.
        over = (~in_cap) & (batch.weight > 0)
        sk.overflow.add_(over.sum(dtype=torch.int32))
        hij = fastrange(mix, sk.part_width[p_c])  # [d, 2, B]
        idx = sk.part_index[p_c]
        for c, (w_c, n_c) in enumerate(zip(sk.class_widths, sk.class_counts)):
            if n_c == 0:
                continue
            # unselected edges add 0 at cell (0, 0, 0) of every layer
            sel = over & (cls == c)
            cell = (torch.where(sel, idx, 0).long() * w_c
                    + torch.where(sel, hij[:, 0], 0)) * w_c \
                + torch.where(sel, hij[:, 1], 0)
            sk.pools[c].view(d, -1).scatter_add_(
                1, cell, torch.where(sel, batch.weight, 0).expand(d, b))

    if sk.conn_w > 0:
        cij = fastrange(mix, sk.conn_w).long()
        sk.conn.view(d, -1).scatter_add_(
            1, cij[:, 0] * sk.conn_w + cij[:, 1], batch.weight.expand(d, b))
    return sk
