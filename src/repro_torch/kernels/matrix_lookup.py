"""Batched sketch point queries: the hand-written CUDA kernels, their
wrappers and their plain versions.  Four entry points:

    matrix_lookup(pool, hi, hj)            out[p, c] = min_r pool[r, p, hi[r,p,c], hj[r,p,c]]
    matrix_lookup_edges(table, a, b, src, dst)
        out[q] = min_r table[r, fastrange(mix_r(src[q]), w), fastrange(mix_r(dst[q]), w)]
    kmatrix_lookup_edges(pools, a, b, src, dst, route=, part_class=, part_index=)
        out[q] = min_r pools[c][r, index(p), fastrange(mix_r(src[q]), w_c),
                                             fastrange(mix_r(dst[q]), w_c)]
    kmatrix_node_out(pools, a, b, v, route=, part_class=, part_index=)
        out[q] = min_r sum_j pools[c][r, index(p), fastrange(mix_r(v[q]), w_c), j]

``matrix_lookup``: pool int32[d, P, w, w], hi/hj int32[d, P, C] ->
int32[P, C], for any C (the JAX package pads C to its block and slices;
here the kernel masks the ragged edge); the Pallas function's counterpart.
``matrix_lookup_edges``: table int32[d, w, w], the hash parameters a/b
int64[d], src/dst int32[n] -> int32[n]; the whole TCM / gMatrix query
(``accel_matrix_edge_freq``), hashing included, in one launch.
``kmatrix_lookup_edges`` / ``kmatrix_node_out``: the width-class kMatrix's
edge and node-out queries (``kmatrix_accel.edge_freq`` /
``node_out_freq``), each in one launch: ``p = route(src[q])`` (or
``v[q]``), its class ``c`` and row ``index(p)``, ``w_c`` the class width;
pools int32[d, P_c, w_c, w_c] (at most 16, widths powers of two), ids
int32[n] -> int32[n].  Row sums are int32 and wrap, as
``sum(dtype=torch.int32)`` does.

The kernels (``csrc/matrix_lookup.cu``) replace the Pallas one-hot product
``repro/kernels/matrix_lookup.py:matrix_lookup`` with a gather and an int32
running min over the layers, and the width-class kMatrix's per-class
gathers, which the JAX package runs outside any kernel, with one routed
launch; see the source for their design.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.common.hashing import fastrange, mix
from repro_torch.kernels import build


def _check(pool: torch.Tensor, hi: torch.Tensor, hj: torch.Tensor) -> None:
    if pool.dim() != 4 or pool.shape[2] != pool.shape[3] or pool.shape[0] < 1:
        raise ValueError(f"pool must be [d >= 1, P, w, w], got {tuple(pool.shape)}")
    d, p = pool.shape[:2]
    if hi.dim() != 3 or hi.shape[:2] != (d, p) or hj.shape != hi.shape:
        raise ValueError(f"hi/hj must be [{d}, {p}, C], got "
                         f"{tuple(hi.shape)} / {tuple(hj.shape)}")
    for name, t in (("pool", pool), ("hi", hi), ("hj", hj)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != pool.device:
            raise ValueError(f"{name} is on {t.device}, pool on {pool.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if p > 65535 or hi.shape[2] >= 2**30:
        raise ValueError(f"P = {p} must be <= 65535 and C = {hi.shape[2]} "
                         "below 2^30")


def _check_range(w: int, hi: torch.Tensor, hj: torch.Tensor) -> None:
    if hi.numel() == 0:
        return
    lo_hi, lo_hj, top_hi, top_hj = torch.stack(
        [hi.min(), hj.min(), hi.max(), hj.max()]).tolist()  # one read-back
    lo, top = min(lo_hi, lo_hj), max(top_hi, top_hj)
    if lo < 0 or top >= w:
        raise ValueError(f"hi/hj must lie in [0, {w}); found [{lo}, {top}]")


def matrix_lookup_plain(pool: torch.Tensor, hi: torch.Tensor,
                        hj: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``amin(pool[rows, parts, hi, hj], 0)``."""
    d, p = pool.shape[:2]
    rows = torch.arange(d, device=pool.device).view(d, 1, 1)
    parts = torch.arange(p, device=pool.device).view(1, p, 1)
    return torch.amin(pool[rows, parts, hi.long(), hj.long()], 0)


@functools.cache
def _launcher():
    lib = build.load("matrix_lookup")
    fn = lib.matrix_lookup_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib, fn


def matrix_lookup(pool: torch.Tensor, hi: torch.Tensor,
                  hj: torch.Tensor) -> torch.Tensor:
    """Point queries ``min_r pool[r, p, hi, hj]`` -> a new int32[P, C].

    A CUDA pool launches the kernel; a CPU pool takes the plain version.
    Precondition: hi and hj lie in ``[0, w)``, as ``fastrange`` into ``w``
    gives them (``matrix_sketch.edge_freq``).  Outside it the reference has
    no defined answer (the Pallas kernel reads 0, ``ref.matrix_lookup_ref``
    clamps).  On the CPU the range is checked and a breach raises
    ``ValueError``; on the card only shapes and types are checked, since a
    range check there would wait for the device.
    """
    _check(pool, hi, hj)
    if pool.device.type == "cpu":
        _check_range(pool.shape[-1], hi, hj)
        return matrix_lookup_plain(pool, hi, hj)
    if pool.device.type != "cuda":
        raise ValueError(f"matrix_lookup runs on cuda or cpu, not {pool.device}")
    d, p, w, _ = pool.shape
    out = torch.empty((p, hi.shape[2]), dtype=torch.int32, device=pool.device)
    lib, fn = _launcher()
    with build.on_device(pool.device) as stream:
        code = fn(pool.data_ptr(), hi.data_ptr(), hj.data_ptr(), out.data_ptr(),
                  d, p, w, hi.shape[2], stream)
    build.check(lib, "matrix_lookup", code)
    build.count_launch(matrix_lookup)
    return out


matrix_lookup.launches = 0


def _check_edges(table, a, b, src, dst) -> None:
    if table.dim() != 3 or table.shape[1] != table.shape[2] or table.shape[0] < 1:
        raise ValueError(f"table must be [d >= 1, w, w], got {tuple(table.shape)}")
    d = table.shape[0]
    if a.shape != (d,) or b.shape != (d,):
        raise ValueError(f"a, b must be [{d}], got {tuple(a.shape)} / "
                         f"{tuple(b.shape)}")
    if src.dim() != 1 or dst.shape != src.shape:
        raise ValueError(f"src, dst must be [n], got {tuple(src.shape)} / "
                         f"{tuple(dst.shape)}")
    if src.shape[0] >= 2**31:
        raise ValueError(f"n = {src.shape[0]} must be below 2^31")
    for name, t, dtype in (("table", table, torch.int32), ("a", a, torch.int64),
                           ("b", b, torch.int64), ("src", src, torch.int32),
                           ("dst", dst, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on {table.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def matrix_lookup_edges_plain(table: torch.Tensor, a: torch.Tensor,
                              b: torch.Tensor, src: torch.Tensor,
                              dst: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``mix``, ``fastrange``, a gather, ``amin``."""
    d, w, _ = table.shape
    rows = torch.arange(d, device=table.device)[:, None]
    hi = fastrange(mix(a, b, src), w).long()
    hj = fastrange(mix(a, b, dst), w).long()
    return torch.amin(table[rows, hi, hj], 0)


@functools.cache
def _edges_launcher():
    lib = build.load("matrix_lookup")
    fn = lib.matrix_lookup_edges_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib, fn


def matrix_lookup_edges(table: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                        src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Point queries of the edges ``(src[q], dst[q])`` -> a new int32[n].

    A CUDA table launches the kernel, which hashes each endpoint itself;
    a CPU table takes the plain version.  Any query ids: the cells are
    hashed into ``[0, w)``, so there is no range precondition.
    """
    _check_edges(table, a, b, src, dst)
    if table.device.type == "cpu":
        return matrix_lookup_edges_plain(table, a, b, src, dst)
    if table.device.type != "cuda":
        raise ValueError(f"matrix_lookup_edges runs on cuda or cpu, not "
                         f"{table.device}")
    d, w, _ = table.shape
    n = src.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=table.device)
    lib, fn = _edges_launcher()
    with build.on_device(table.device) as stream:
        code = fn(table.data_ptr(), a.data_ptr(), b.data_ptr(), src.data_ptr(),
                  dst.data_ptr(), out.data_ptr(), d, w, n, stream)
    build.check(lib, "matrix_lookup", code)
    build.count_launch(matrix_lookup_edges)
    return out


matrix_lookup_edges.launches = 0


MAX_CLASSES = 16  # class pools the kMatrix kernels' class table holds
_INT32_MAX = torch.iinfo(torch.int32).max


class _ClassTable(ctypes.Structure):
    """The kMatrix kernels' class table, ``LookupClasses`` in the source."""

    _fields_ = [("base", ctypes.c_void_p * MAX_CLASSES),
                ("parts", ctypes.c_int * MAX_CLASSES),
                ("width", ctypes.c_int * MAX_CLASSES)]


@functools.lru_cache(maxsize=64)
def _class_table(classes: tuple) -> _ClassTable:
    """The table of the pools ``((data_ptr, parts, width), ...)``, built
    once per set of pointers: a sketch's pools keep theirs until a publish
    replaces them.  It holds plain integers and no tensor."""
    table = _ClassTable()
    for c, (ptr, parts, width) in enumerate(classes):
        table.base[c], table.parts[c], table.width[c] = ptr, parts, width
    return table


def _check_routed(pools, a, b, ids, route, part_class, part_index) -> None:
    if not 1 <= len(pools) <= MAX_CLASSES:
        raise ValueError(f"the kMatrix lookups take 1 to {MAX_CLASSES} class "
                         f"pools, got {len(pools)}")
    if a.dim() != 1 or a.shape[0] < 1 or b.shape != a.shape:
        raise ValueError(f"a, b must be [d >= 1], got {tuple(a.shape)} / "
                         f"{tuple(b.shape)}")
    d = a.shape[0]
    for pool in pools:
        w = pool.shape[-1]
        if (pool.dim() != 4 or pool.shape[0] != d or pool.shape[2] != w
                or w < 1 or w & (w - 1)):
            raise ValueError(f"pools must be [{d}, P_c, w_c, w_c] with w_c a "
                             f"power of two, got {tuple(pool.shape)}")
    if ids[0].dim() != 1 or any(t.shape != ids[0].shape for t in ids):
        raise ValueError(f"ids must be [n], got "
                         f"{' / '.join(str(tuple(t.shape)) for t in ids)}")
    if ids[0].shape[0] >= 2**31:
        raise ValueError(f"n = {ids[0].shape[0]} must be below 2^31")
    if route.keys.dim() != 1 or route.part.shape != route.keys.shape:
        raise ValueError("route keys and part must be [n_keys]")
    if part_class.dim() != 1 or part_index.shape != part_class.shape:
        raise ValueError(f"part_class, part_index must be [P], got "
                         f"{tuple(part_class.shape)} / "
                         f"{tuple(part_index.shape)}")
    if not 0 <= route.outlier < part_class.shape[0]:
        raise ValueError(f"outlier {route.outlier} is not a partition of "
                         f"{part_class.shape[0]}")
    device = pools[0].device
    for name, t, dtype in (
            ("a", a, torch.int64), ("b", b, torch.int64),
            *(("ids", t, torch.int32) for t in ids),
            ("route.keys", route.keys, torch.int32),
            ("route.part", route.part, torch.int32),
            ("part_class", part_class, torch.int32),
            ("part_index", part_index, torch.int32),
            *((f"pools[{c}]", p, torch.int32) for c, p in enumerate(pools))):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, pools on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def kmatrix_lookup_edges_plain(pools, a, b, src, dst, *, route, part_class,
                               part_index) -> torch.Tensor:
    """Plain PyTorch version: ``route.lookup``, ``mix``, then per class a
    masked gather at the class width and ``amin`` over the layers."""
    rows = torch.arange(a.shape[0], device=src.device)[:, None]
    p = route.lookup(src)
    hs, ht = mix(a, b, src), mix(a, b, dst)  # [d, n]
    est = torch.full(src.shape, _INT32_MAX, dtype=torch.int32,
                     device=src.device)
    for c, pool in enumerate(pools):
        w_c = pool.shape[-1]
        if pool.shape[1] == 0:
            continue
        sel = part_class[p] == c
        q = torch.where(sel, part_index[p], 0)
        vals = pool[rows, q[None], fastrange(hs, w_c),
                    fastrange(ht, w_c)].amin(dim=0)
        est = torch.where(sel, vals, est)
    return est


def kmatrix_node_out_plain(pools, a, b, v, *, route, part_class,
                           part_index) -> torch.Tensor:
    """Plain PyTorch version: ``route.lookup``, ``mix``, then per class a
    masked row gather at the class width, an int32 row sum and ``amin``
    over the layers."""
    rows = torch.arange(a.shape[0], device=v.device)[:, None]
    p = route.lookup(v)
    hv = mix(a, b, v)  # [d, n]
    est = torch.full(v.shape, _INT32_MAX, dtype=torch.int32, device=v.device)
    for c, pool in enumerate(pools):
        w_c = pool.shape[-1]
        if pool.shape[1] == 0:
            continue
        sel = part_class[p] == c
        q = torch.where(sel, part_index[p], 0)
        vals = pool[rows, q[None], fastrange(hv, w_c), :].sum(
            dim=-1, dtype=torch.int32)
        est = torch.where(sel, vals.amin(dim=0), est)
    return est


@functools.cache
def _routed_launcher(name: str):
    lib = build.load("matrix_lookup")
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    n_ids = 2 if name == "kmatrix_lookup_edges" else 1
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]  # class table, classes
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]  # a, b, d
                   # route keys and parts, n_keys, outlier
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   # part_class, part_index, the ids, out
                   + [ctypes.c_void_p] * (3 + n_ids)
                   + [ctypes.c_int, ctypes.c_void_p])  # n, stream
    return lib, fn


def _routed(wrapper, plain, pools, a, b, ids, route, part_class, part_index):
    """Check, then the plain version on the CPU or one launch on the card."""
    pools = tuple(pools)
    _check_routed(pools, a, b, ids, route, part_class, part_index)
    device = pools[0].device
    if device.type == "cpu":
        return plain(pools, a, b, *ids, route=route, part_class=part_class,
                     part_index=part_index)
    if device.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cuda or cpu, not {device}")
    n = ids[0].shape[0]
    out = torch.empty(n, dtype=torch.int32, device=device)
    table = _class_table(tuple((p.data_ptr(), p.shape[1], p.shape[-1])
                               for p in pools))
    lib, fn = _routed_launcher(wrapper.__name__)
    with build.on_device(device) as stream:
        code = fn(ctypes.byref(table), len(pools), a.data_ptr(), b.data_ptr(),
                  a.shape[0], route.keys.data_ptr(), route.part.data_ptr(),
                  route.keys.shape[0], route.outlier, part_class.data_ptr(),
                  part_index.data_ptr(), *(t.data_ptr() for t in ids),
                  out.data_ptr(), n, stream)
    build.check(lib, "matrix_lookup", code)
    build.count_launch(wrapper)
    return out


def kmatrix_lookup_edges(pools, a, b, src, dst, *, route, part_class,
                         part_index) -> torch.Tensor:
    """Point queries of the edges ``(src[q], dst[q])`` on the width-class
    kMatrix -> a new int32[n].

    Args:
      pools: the class pools, int32[d, P_c, w_c, w_c] each (at most 16,
        widths powers of two).
      a, b: int64[d], the hash family's parameters (uint32 values).
      src, dst: int32[n], the query endpoints (any values).
      route: the ``RouteTable`` (``keys``, ``part``, ``outlier``, ``lookup``).
      part_class, part_index: int32[P], each partition's class and row.

    A CUDA sketch launches the kernel (no host synchronisation, no range
    check); a CPU sketch takes the plain version.  Precondition: route parts
    lie in ``[0, P)`` and part_class / part_index address the pools, as a
    sketch's own tables do.
    """
    return _routed(kmatrix_lookup_edges, kmatrix_lookup_edges_plain, pools, a,
                   b, (src, dst), route, part_class, part_index)


kmatrix_lookup_edges.launches = 0


def kmatrix_node_out(pools, a, b, v, *, route, part_class,
                     part_index) -> torch.Tensor:
    """Aggregate out-weight of the vertices ``v`` on the width-class kMatrix
    -> a new int32[n]: the min over layers of the int32 sum of each
    vertex's row in its partition.  Arguments and dispatch as
    ``kmatrix_lookup_edges``, with ``v`` int32[n]."""
    return _routed(kmatrix_node_out, kmatrix_node_out_plain, pools, a, b,
                   (v,), route, part_class, part_index)


kmatrix_node_out.launches = 0
