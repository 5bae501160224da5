"""Batched sketch ingest: the hand-written CUDA kernels, their wrappers and
their plain versions.  Two entry points:

``matrix_ingest`` (the rectangles; the Pallas function's counterpart)::

    pool[r, p, hi[r,p,c], hj[r,p,c]] += wt[p, c]    for all (r, p, c)

pool int32[d, P, w, w], hi/hj int32[d, P, C], wt int32[P, C]; ``wt == 0``
marks padding, and slots whose hi or hj lies outside ``[0, w)`` are dropped.

``matrix_ingest_edges`` (the raw edges; the whole ``kmatrix_accel_ingest``
or ``accel_matrix_ingest`` in one launch): routes, hashes and adds each
edge ``(src, dst, weight)`` itself.  With a route (the width-class kMatrix)
an edge of positive weight adds into
``pools[class(p)][r, index(p), fastrange(mix_r(src), w_c),
fastrange(mix_r(dst), w_c)]`` for its partition ``p``, every edge adds
into ``conn`` likewise, and ``overflow`` gains the tally of the rectangle
dispatch, ``sum_p max(0, n_live(p) - capacity)``.  Without one (TCM,
gMatrix) every nonzero weight adds into the single pool [d, 1, w, w].

Pools, conn and overflow are updated in place (the JAX package returns new
arrays).  The kernels (``csrc/matrix_ingest.cu``) replace the Pallas
one-hot product ``repro/kernels/matrix_ingest.py:matrix_ingest`` and the
dispatch around it with int32 atomic scatter-adds; see the source for
their design.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.common.hashing import fastrange, mix
from repro_torch.kernels import build
from repro_torch.obs.profile import profile_span

MAX_CLASSES = 16  # class pools the edge kernel's parameter block holds
# Layers one thread of the edge kernel adds (grid y = ceil(d / this)): 1 is
# a thread per (edge, layer), so a batch of 8,192 edges at d = 7 runs 224
# blocks of 256 rather than 32.
LAYERS_PER_THREAD = 1


def _check(pool: torch.Tensor, hi: torch.Tensor, hj: torch.Tensor,
           wt: torch.Tensor) -> None:
    if pool.dim() != 4 or pool.shape[2] != pool.shape[3]:
        raise ValueError(f"pool must be [d, P, w, w], got {tuple(pool.shape)}")
    d, p = pool.shape[:2]
    if hi.dim() != 3 or hi.shape[:2] != (d, p) or hj.shape != hi.shape:
        raise ValueError(f"hi/hj must be [{d}, {p}, C], got "
                         f"{tuple(hi.shape)} / {tuple(hj.shape)}")
    if wt.shape != (p, hi.shape[2]):
        raise ValueError(f"wt must be [{p}, {hi.shape[2]}], got {tuple(wt.shape)}")
    for name, t in (("pool", pool), ("hi", hi), ("hj", hj), ("wt", wt)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != pool.device:
            raise ValueError(f"{name} is on {t.device}, pool on {pool.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d * p > 65535 or hi.shape[2] >= 2**30:
        raise ValueError(f"d * P = {d * p} must be <= 65535 and C = "
                         f"{hi.shape[2]} below 2^30")


def matrix_ingest_plain(pool: torch.Tensor, hi: torch.Tensor, hj: torch.Tensor,
                        wt: torch.Tensor) -> torch.Tensor:  # writes: 0
    """Plain PyTorch version: masked ``index_put_`` with accumulation."""
    d, p, w, _ = pool.shape
    ok = (hi >= 0) & (hi < w) & (hj >= 0) & (hj < w) & (wt != 0)[None]
    r, q, c = ok.nonzero(as_tuple=True)
    pool.index_put_((r, q, hi[r, q, c].long(), hj[r, q, c].long()), wt[q, c],
                    accumulate=True)
    return pool


@functools.cache
def _launcher():
    lib = build.load("matrix_ingest")
    fn = lib.matrix_ingest_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib, fn


def matrix_ingest(pool: torch.Tensor, hi: torch.Tensor, hj: torch.Tensor,
                  wt: torch.Tensor) -> torch.Tensor:  # writes: 0
    """Add every live slot into ``pool`` in place; returns ``pool``.

    A CUDA pool launches the kernel; a CPU pool takes the plain version.
    """
    _check(pool, hi, hj, wt)
    if pool.device.type == "cpu":
        return matrix_ingest_plain(pool, hi, hj, wt)
    if pool.device.type != "cuda":
        raise ValueError(f"matrix_ingest runs on cuda or cpu, not {pool.device}")
    d, p, w, _ = pool.shape
    lib, fn = _launcher()
    with build.on_device(pool.device) as stream:
        code = fn(pool.data_ptr(), hi.data_ptr(), hj.data_ptr(), wt.data_ptr(),
                  d, p, w, hi.shape[2], stream)
    build.check(lib, "matrix_ingest", code)
    build.count_launch(matrix_ingest)
    return pool


matrix_ingest.launches = 0


def _check_edges(pools, a, b, src, dst, weight, route, part_class,
                 part_index, conn, overflow, capacity) -> None:
    if not 1 <= len(pools) <= MAX_CLASSES:
        raise ValueError(f"matrix_ingest_edges takes 1 to {MAX_CLASSES} "
                         f"class pools, got {len(pools)}")
    if a.dim() != 1 or a.shape[0] < 1 or b.shape != a.shape:
        raise ValueError(f"a, b must be [d >= 1], got {tuple(a.shape)} / "
                         f"{tuple(b.shape)}")
    d = a.shape[0]
    for pool in pools:
        if pool.dim() != 4 or pool.shape[0] != d or pool.shape[2] != pool.shape[3]:
            raise ValueError(f"pools must be [{d}, P_c, w_c, w_c], got "
                             f"{tuple(pool.shape)}")
    if src.dim() != 1 or dst.shape != src.shape or weight.shape != src.shape:
        raise ValueError(f"src, dst, weight must be [B], got {tuple(src.shape)}"
                         f" / {tuple(dst.shape)} / {tuple(weight.shape)}")
    if src.shape[0] >= 2**31:
        raise ValueError(f"B = {src.shape[0]} must be below 2^31")
    tensors = [("a", a, torch.int64), ("b", b, torch.int64),
               ("src", src, torch.int32), ("dst", dst, torch.int32),
               ("weight", weight, torch.int32),
               *((f"pools[{c}]", p, torch.int32) for c, p in enumerate(pools))]
    routed = (part_class, part_index, conn, overflow, capacity)
    if route is None:
        if len(pools) != 1 or pools[0].shape[1] != 1:
            raise ValueError("without a route, matrix_ingest_edges takes one "
                             "pool [d, 1, w, w]")
        if any(x is not None for x in routed):
            raise ValueError("part_class, part_index, conn, overflow and "
                             "capacity belong to a routed ingest")
    else:
        if any(x is None for x in routed):
            raise ValueError("a routed ingest needs part_class, part_index, "
                             "conn, overflow and capacity")
        for pool in pools:
            w = pool.shape[-1]
            if w < 1 or w & (w - 1):
                raise ValueError(f"class widths must be powers of two, got {w}")
        n_parts = part_class.shape[0]
        if part_class.dim() != 1 or part_index.shape != part_class.shape:
            raise ValueError(f"part_class, part_index must be [P], got "
                             f"{tuple(part_class.shape)} / "
                             f"{tuple(part_index.shape)}")
        if not 0 <= route.outlier < n_parts:
            raise ValueError(f"outlier {route.outlier} is not a partition "
                             f"of {n_parts}")
        if route.keys.dim() != 1 or route.part.shape != route.keys.shape:
            raise ValueError("route keys and part must be [n]")
        if conn.dim() != 3 or conn.shape[0] != d or conn.shape[1] != conn.shape[2]:
            raise ValueError(f"conn must be [{d}, cw, cw], got {tuple(conn.shape)}")
        if overflow.shape != ():
            raise ValueError(f"overflow must be a scalar, got {tuple(overflow.shape)}")
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        tensors += [("route.keys", route.keys, torch.int32),
                    ("route.part", route.part, torch.int32),
                    ("part_class", part_class, torch.int32),
                    ("part_index", part_index, torch.int32),
                    ("conn", conn, torch.int32),
                    ("overflow", overflow, torch.int32)]
    device = pools[0].device
    for name, t, dtype in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, pools on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def matrix_ingest_edges_plain(pools, a, b, src, dst, weight, *, route=None,
                              part_class=None, part_index=None, conn=None,
                              overflow=None,
                              capacity=None) -> None:  # writes: 0
    """Plain PyTorch version: ``route.lookup``, ``mix``, ``fastrange``, one
    accumulating ``index_put_`` per class and one for ``conn``; the tally
    from ``torch.bincount`` of the live partitions."""
    d = a.shape[0]
    rows = torch.arange(d, device=src.device)[:, None]
    hs, ht = mix(a, b, src), mix(a, b, dst)  # int64[d, B]
    if route is None:
        (pool,) = pools
        w = pool.shape[-1]
        pool.index_put_((rows, torch.zeros_like(rows), fastrange(hs, w).long(),
                         fastrange(ht, w).long()), weight.expand(d, -1),
                        accumulate=True)
        return
    p = route.lookup(src).long()
    live = weight > 0
    cls, row = part_class[p], part_index[p]
    for c, pool in enumerate(pools):
        sel = (live & (cls == c)).nonzero().squeeze(1)
        w = pool.shape[-1]
        pool.index_put_((rows, row[sel].long()[None],
                         fastrange(hs[:, sel], w).long(),
                         fastrange(ht[:, sel], w).long()),
                        weight[sel].expand(d, -1), accumulate=True)
    cw = conn.shape[-1]
    if cw > 0:
        conn.index_put_((rows, fastrange(hs, cw).long(), fastrange(ht, cw).long()),
                        weight.expand(d, -1), accumulate=True)
    n_live = torch.bincount(p[live], minlength=part_class.shape[0])
    overflow.add_((n_live - capacity).clamp_(min=0).sum().to(overflow.dtype))


@functools.cache
def _edges_launcher():
    lib = build.load("matrix_ingest")
    fn = lib.matrix_ingest_edges_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    return lib, fn


def matrix_ingest_edges(pools, a, b, src, dst, weight, *, route=None,
                        part_class=None, part_index=None, conn=None,
                        overflow=None, capacity=None) -> None:  # writes: 0
    """Ingest one batch of raw edges in place, in one launch on the card.

    Args:
      pools: the class pools, int32[d, P_c, w_c, w_c] each (at most 16;
        widths powers of two when routed), or one int32[d, 1, w, w].
      a, b: int64[d], the hash family's parameters (uint32 values).
      src, dst, weight: int32[B], the batch.
      route: the ``RouteTable`` (``keys``, ``part``, ``outlier``,
        ``lookup``) for the width-class kMatrix, or None for P = 1.
      part_class, part_index: int32[P], each partition's class and row.
      conn: int32[d, cw, cw], every weight (cw may be 0).
      overflow: int32[], gains the rectangle dispatch's overflow tally.
      capacity: the dispatch's per-partition capacity (sets only the tally).

    A CUDA batch launches the kernel (no host synchronisation); a CPU batch
    takes the plain version.  Precondition of the routed mode: route parts
    lie in ``[0, P)`` and part_class / part_index address the pools, as a
    sketch's own tables do.
    """
    with profile_span("dispatch.matrix_ingest_edges"):
        pools = tuple(pools)
        with profile_span("dispatch.check"):
            _check_edges(pools, a, b, src, dst, weight, route, part_class,
                         part_index, conn, overflow, capacity)
        device = pools[0].device
        kw = dict(route=route, part_class=part_class, part_index=part_index,
                  conn=conn, overflow=overflow, capacity=capacity)
        if device.type == "cpu":
            return matrix_ingest_edges_plain(pools, a, b, src, dst, weight,
                                             **kw)
        if device.type != "cuda":
            raise ValueError(f"matrix_ingest_edges runs on cuda or cpu, "
                             f"not {device}")
        n, n_edges, d = len(pools), src.shape[0], a.shape[0]
        base = (ctypes.c_void_p * n)(*(p.data_ptr() for p in pools))
        parts = (ctypes.c_int * n)(*(p.shape[1] for p in pools))
        widths = (ctypes.c_int * n)(*(p.shape[-1] for p in pools))
        if route is None:
            routed = (0, None, None, 0, 0, None, None, 0, None, 0, None, 0,
                      None)
        else:
            n_parts = part_class.shape[0]
            # the tally's scratch, zeroed by the launch; none when no
            # partition can overflow (stream-ordered, so freeing it here is
            # safe)
            count = (torch.empty(n_parts, dtype=torch.int32, device=device)
                     if capacity < n_edges else None)
            routed = (1, route.keys.data_ptr(), route.part.data_ptr(),
                      route.keys.shape[0], route.outlier,
                      part_class.data_ptr(), part_index.data_ptr(), n_parts,
                      conn.data_ptr(), conn.shape[-1],
                      count.data_ptr() if count is not None else None,
                      min(capacity, n_edges), overflow.data_ptr())
        lib, fn = _edges_launcher()
        with build.on_device(device) as stream:
            code = fn(base, parts, widths, n, src.data_ptr(),
                      dst.data_ptr(), weight.data_ptr(), a.data_ptr(),
                      b.data_ptr(), n_edges, d, *routed,
                      -(-d // LAYERS_PER_THREAD), stream)
        build.check(lib, "matrix_ingest", code)
        build.count_launch(matrix_ingest_edges)


matrix_ingest_edges.launches = 0
