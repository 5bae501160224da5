"""Batched sketch point queries: the hand-written CUDA kernels, their
wrappers and their plain versions.  Two entry points:

    matrix_lookup(pool, hi, hj)            out[p, c] = min_r pool[r, p, hi[r,p,c], hj[r,p,c]]
    matrix_lookup_edges(table, a, b, src, dst)
        out[q] = min_r table[r, fastrange(mix_r(src[q]), w), fastrange(mix_r(dst[q]), w)]

``matrix_lookup``: pool int32[d, P, w, w], hi/hj int32[d, P, C] ->
int32[P, C], for any C (the JAX package pads C to its block and slices;
here the kernel masks the ragged edge); the Pallas function's counterpart.
``matrix_lookup_edges``: table int32[d, w, w], the hash parameters a/b
int64[d], src/dst int32[n] -> int32[n]; the whole TCM / gMatrix query
(``accel_matrix_edge_freq``), hashing included, in one launch.

The kernels (``csrc/matrix_lookup.cu``) replace the Pallas one-hot product
``repro/kernels/matrix_lookup.py:matrix_lookup`` with a gather and an int32
running min over the layers; see the source for their design.
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
