"""Batched sketch ingest: the hand-written CUDA kernel, its wrapper and its
plain version.

    pool[r, p, hi[r,p,c], hj[r,p,c]] += wt[p, c]    for all (r, p, c)

pool int32[d, P, w, w], hi/hj int32[d, P, C], wt int32[P, C]; ``wt == 0``
marks padding, and slots whose hi or hj lies outside ``[0, w)`` are dropped.
The pool is updated in place (the JAX package returns a new array).

The kernel (``csrc/matrix_ingest.cu``) replaces the Pallas one-hot product
``repro/kernels/matrix_ingest.py:matrix_ingest`` with an int32 atomic
scatter-add; see the source for its design.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


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
                        wt: torch.Tensor) -> torch.Tensor:
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
                  wt: torch.Tensor) -> torch.Tensor:
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
    matrix_ingest.launches += 1
    return pool


matrix_ingest.launches = 0
