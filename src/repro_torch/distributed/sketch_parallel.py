"""Distributed kMatrix: the paper's technique scaled out (paper §VI lists
"data partitioning across machines" as future work — this implements it).

The JAX package's ``distributed/sketch_parallel.py`` on ``torch.distributed``.
Each function it returns runs in every rank of a ``run_ranks`` group, on the
rank's own state, where the reference's runs under ``shard_map``: it takes
the same arguments (the rank's rows of the state and the GLOBAL batch) and
takes its shard of the batch by its mesh coordinate, as ``P(axis)`` does.
State stays on the mesh's device; ingest adds into the caller's ``pool``
and ``conn`` in place and returns them.

Two orthogonal distribution modes, composable on a ("data", "model") mesh:

  DATA-PARALLEL (exact): counters are additive, so each data shard sketches
  its sub-stream into its own [d, pool] / [d, cw, cw] rows and queries
  all_reduce the pools over the data axis.

  PARTITION-PARALLEL: partitions are sharded over the "model" axis like MoE
  experts (``build_owner_map``); edges route by source vertex -> partition
  -> owner rank.  Every (data, model) rank holds its own rows; queries
  all_reduce pool and conn over both axes.  Two dispatch strategies:

    * "allgather" — every rank gathers its model peers' batch slices and
      ingests only the edges it owns.  EXACT.
    * "a2a" — bucket edges per owner with a static capacity and exchange
      them with one all_to_all.  Edges past capacity are dropped and
      counted.

One deliberate divergence: the a2a ``dropped`` is the TRUE number of
dropped edges, summed over the model and data axes.  The reference divides
that sum by ``n_model`` on the claim that the model ranks of a row count
the same drops; they count disjoint slices, so it under-reports by a factor
of ``n_model``.  Pools and conns are bit-equal to the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import kmatrix
from repro_torch.core.kmatrix import KMatrix
from repro_torch.core.types import EdgeBatch
from repro_torch.distributed import group


def _device(mesh, sk_template: KMatrix) -> torch.device:
    device = group.rank_device()
    if device.type != mesh.device_type:
        raise ValueError(f"mesh on {mesh.device_type}, ranks on {device}")
    if sk_template.pool.device != device:
        raise ValueError(f"sk_template lives on {sk_template.pool.device}; "
                         f"this rank runs on {device}")
    return device


def _axes(axis) -> tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _shard(mesh, axes: tuple[str, ...], *xs: torch.Tensor):
    """This rank's block of each 1-D global array under ``P(axes)``: the
    axes flattened row-major, the array split in equal blocks."""
    names, coord = mesh.mesh_dim_names, mesh.get_coordinate()
    n, i = 1, 0
    for ax in axes:
        k = mesh.shape[names.index(ax)]
        n, i = n * k, i * k + coord[names.index(ax)]
    b = xs[0].shape[0]
    if b % n:
        raise ValueError(f"batch of {b} does not split over {axes} ({n} shards)")
    return tuple(x[i * (b // n):(i + 1) * (b // n)] for x in xs)


def _pool_only(sk: KMatrix, pool: torch.Tensor) -> KMatrix:
    """``sk`` over ``pool`` with no connectivity matrix: the reference
    ingests these edges with a zeroed conn that it discards."""
    return sk.replace(pool=pool, conn=pool.new_zeros((sk.depth, 0, 0)),
                      conn_w=0)


# ----------------------------------------------------------- data parallel

def make_dp_ingest(sk_template: KMatrix, mesh, axis: str = "data"):
    """Returns ingest(pool, conn, src, dst, wt) -> (pool, conn): this rank's
    [d, pool] and [d, cw, cw] replica rows, the global batch."""
    _device(mesh, sk_template)

    def ingest(pool, conn, src, dst, wt):
        src, dst, wt = _shard(mesh, (axis,), src, dst, wt)
        kmatrix.ingest(sk_template.replace(pool=pool, conn=conn),
                       EdgeBatch(src=src, dst=dst, weight=wt))
        return pool, conn

    return ingest


def make_dp_edge_freq(sk_template: KMatrix, mesh, axis: str = "data"):
    """Query across data-parallel replicas: all_reduce the pools, then min."""
    _device(mesh, sk_template)

    def query(pool, conn, src, dst):
        pool = group.all_reduce(pool.clone(), mesh.get_group(axis))
        return kmatrix.edge_freq(sk_template.replace(pool=pool, conn=conn),
                                 src, dst)

    return query


# ------------------------------------------------------ partition parallel

def build_owner_map(sk: KMatrix, n_model: int) -> np.ndarray:
    """Assign partitions to model-axis ranks, balancing total slab area."""
    widths = sk.route.widths.cpu().numpy()
    areas = widths.astype(np.int64) ** 2
    order = np.argsort(-areas)  # biggest first, greedy bin pack
    owner = np.zeros(len(widths), np.int32)
    load = np.zeros(n_model, np.int64)
    for p in order:
        dev = int(np.argmin(load))
        owner[p] = dev
        load[dev] += areas[p]
    return owner


def _data_axes(mesh, data_axis, model_axis: str) -> tuple[str, ...]:
    if data_axis is None:
        return tuple(a for a in mesh.mesh_dim_names if a != model_axis)
    return _axes(data_axis)


def make_pp_ingest(
    sk_template: KMatrix,
    mesh,
    *,
    mode: str = "a2a",
    capacity_factor: float = 2.0,
    data_axis=None,  # str or tuple; default: every non-model axis
    model_axis: str = "model",
):
    """Partition-parallel ingest.

    Every (data, model) rank holds its own [d, pool] and [d, cw, cw] rows;
    it writes only the slabs it owns, and conn only on model rank 0 (each
    edge counts once: every model rank of a data row sees the same edge
    shard).  Returns (ingest_fn, owner_map); ingest_fn(pool, conn, src,
    dst, wt) -> (pool, conn, dropped), dropped the whole mesh's count of
    this batch's edges dropped past capacity (0 in allgather mode).
    """
    if mode not in ("a2a", "allgather"):
        raise ValueError(f"mode must be 'a2a' or 'allgather', got {mode!r}")
    device = _device(mesh, sk_template)
    data_axes = _data_axes(mesh, data_axis, model_axis)
    names = mesh.mesh_dim_names
    n_model = mesh.shape[names.index(model_axis)]
    owner_np = build_owner_map(sk_template, n_model)
    owner_map = torch.as_tensor(owner_np, device=device)
    d = sk_template.depth
    my_dev = mesh.get_coordinate()[names.index(model_axis)]
    model_group = mesh.get_group(model_axis)
    data_groups = [mesh.get_group(ax) for ax in data_axes]
    rows = torch.arange(d, device=device)[:, None]

    def conn_update(conn, src, dst, wt):
        if sk_template.conn_w == 0 or my_dev != 0:
            return conn
        ci = kmatrix.conn_cells(sk_template, src)
        cj = kmatrix.conn_cells(sk_template, dst)
        wts = wt[None].to(conn.dtype).expand(ci.shape)
        conn.index_put_((rows.expand_as(ci), ci, cj), wts, accumulate=True)
        return conn

    def ingest(pool, conn, src, dst, wt):
        src, dst, wt = _shard(mesh, data_axes, src, dst, wt)
        # each model rank claims its own 1/n_model slice of the data shard
        b = src.shape[0]
        b_m = b // n_model
        sl = slice(my_dev * b_m, (my_dev + 1) * b_m)
        src_m, dst_m, wt_m = src[sl], dst[sl], wt[sl]

        if mode == "allgather":
            # classic dispatch: gather every rank's slice, keep owned edges
            edges = group.all_gather(torch.stack([src_m, dst_m, wt_m]),
                                     model_group)  # [n_model, 3, b_m]
            src_all, dst_all, wt_all = edges.transpose(0, 1).reshape(3, -1)
            p = sk_template.route.lookup(src_all)
            mine = owner_map[p] == my_dev
            wt_mine = torch.where(mine, wt_all, 0)
            kmatrix.ingest(_pool_only(sk_template, pool),
                           EdgeBatch(src=src_all, dst=dst_all, weight=wt_mine))
            dropped = torch.zeros((), dtype=torch.int32, device=device)
            return pool, conn_update(conn, src, dst, wt), dropped

        # ---- a2a: bucket my slice by owner, exchange, ingest local -------
        cap = int(b_m * capacity_factor / n_model)
        cap = max(cap, 8)
        p = sk_template.route.lookup(src_m)
        own = torch.where(wt_m > 0, owner_map[p], n_model)  # park padding
        # a stable sort, so the edges past capacity are the reference's
        order = torch.argsort(own, stable=True)
        own_s = own[order]
        pos = torch.arange(b_m, device=device)
        is_start = torch.ones(b_m, dtype=torch.bool, device=device)
        is_start[1:] = own_s[1:] != own_s[:-1]
        start = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
        rank = torch.empty_like(pos)
        rank[order] = pos - start
        keep = (rank < cap) & (own < n_model)
        # slot == cap is the reference's dropped write: a spare bucket row
        # and slot take the dropped and parked edges and are cut off, so
        # every shape is known before the data
        buckets = torch.zeros((n_model + 1, 3, cap + 1), dtype=torch.int32,
                              device=device)
        buckets[torch.where(keep, own, n_model).long(), :,
                torch.where(keep, rank, cap)] = torch.stack(
            [src_m, dst_m, wt_m], dim=1).to(torch.int32)
        buckets = buckets[:n_model, :, :cap].contiguous()
        # exchange: rank m receives bucket m from every model peer, in
        # peer order
        recv = group.all_to_all(buckets, model_group)
        src_r, dst_r, wt_r = recv.transpose(0, 1).reshape(3, -1)
        kmatrix.ingest(_pool_only(sk_template, pool),
                       EdgeBatch(src=src_r, dst=dst_r, weight=wt_r))
        dropped = (~keep & (own < n_model)).sum(dtype=torch.int32)
        group.all_reduce(dropped, model_group)
        for g in data_groups:
            group.all_reduce(dropped, g)
        return pool, conn_update(conn, src, dst, wt), dropped

    return ingest, owner_np


def make_pp_edge_freq(sk_template: KMatrix, mesh, *,
                      data_axis=None, model_axis: str = "model"):
    """Query on partition-parallel state: all_reduce the slab-disjoint pools
    and the conns over both axes (model shards are slab-disjoint, data
    shards are additive)."""
    _device(mesh, sk_template)
    data_axes = _data_axes(mesh, data_axis, model_axis)
    groups = [mesh.get_group(ax) for ax in (model_axis, *data_axes)]
    n_pool = sk_template.pool.numel()

    def query(pool, conn, src, dst):
        state = torch.cat([pool.reshape(-1), conn.reshape(-1)])
        for g in groups:
            group.all_reduce(state, g)
        sk = sk_template.replace(pool=state[:n_pool].view(pool.shape),
                                 conn=state[n_pool:].view(conn.shape))
        return kmatrix.edge_freq(sk, src, dst)

    return query


# ------------------------------------------------------------ stacked view

def stacked_state(pool: torch.Tensor, conn: torch.Tensor, mesh,
                  axes=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rank's rows in the reference's stacked layout, on every rank:
    rows ordered row-major by the coordinates over ``axes`` (default: all
    of the mesh's), ``[n · d, pool]`` and ``[n · d, cw, cw]``.  Ranks that
    differ only on the other axes hold replicas (DP over "data" replicates
    over "model"); the one at coordinate 0 on those axes is taken."""
    names = mesh.mesh_dim_names
    axes = names if axes is None else _axes(axes)
    pick = tuple(slice(None) if ax in axes else 0 for ax in names)
    kept = [ax for ax in names if ax in axes]
    ranks = mesh.mesh[pick].permute(*[kept.index(ax) for ax in axes])
    pools = group.all_gather(pool, None)  # [world, d, pool]
    conns = group.all_gather(conn, None)
    ranks = ranks.flatten().to(pools.device)
    return (pools[ranks].reshape(-1, *pool.shape[1:]),
            conns[ranks].reshape(-1, *conn.shape[1:]))
