"""Fixed-arity embedding bag: the hand-written CUDA kernel, its wrapper and
its plain version.

    out[b] = sum_f w[b, f] * table[idx[b, f]]

table f32[V, D] with any D >= 1, idx int32[B, F], w f32[B, F] or None ->
a new f32[B, D].  The JAX package's TPU kernel needs D lane-aligned and
the FM pads its tables to 128 columns; here a bag runs at the table's own
width.

The kernel (``csrc/embedding_bag.cu``) replaces the Pallas scalar-prefetch
row gather ``repro/kernels/embedding_bag.py:embedding_bag``; see the source
for its design; ``bag_plan`` picks its vector width, bags per block and
staging from the shapes and the table's alignment.  Kernel, plain version
and the Pallas kernel sum in the same order with one rounding per step, so
the three agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

THREADS = 256  # most threads per block
STAGE_WORDS = 12_000  # staged indices and weights per block: 48,000 bytes


def _check(table: torch.Tensor, idx: torch.Tensor,
           weights: torch.Tensor | None) -> None:
    if table.dim() != 2 or table.shape[1] < 1:
        raise ValueError(f"table must be [V, D >= 1], got {tuple(table.shape)}")
    if idx.dim() != 2:
        raise ValueError(f"idx must be [B, F], got {tuple(idx.shape)}")
    if table.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    named = [("table", table), ("idx", idx)]
    if weights is not None:
        if weights.shape != idx.shape:
            raise ValueError(f"weights must be {tuple(idx.shape)}, got "
                             f"{tuple(weights.shape)}")
        if weights.dtype != torch.float32:
            raise TypeError(f"weights must be float32, got {weights.dtype}")
        named.append(("weights", weights))
    for name, t in named:
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on {table.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if idx.shape[0] * table.shape[1] >= 2**31:
        raise ValueError(f"B * D = {idx.shape[0]} * {table.shape[1]} must be "
                         "below 2^31")
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in named):
        raise NotImplementedError(
            "embedding_bag has no backward yet (FM training is a later "
            "slice); call it under torch.no_grad() or on tensors that do "
            "not require grad")


def _check_range(v: int, idx: torch.Tensor) -> None:
    if idx.numel() == 0:
        return
    lo, top = torch.stack([idx.min(), idx.max()]).tolist()  # one read-back
    if lo < 0 or top >= v:
        raise ValueError(f"idx must lie in [0, {v}); found [{lo}, {top}]")


def _fma(row: torch.Tensor, w: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``row * w + acc`` rounded once to float32, as ``fmaf`` rounds it.

    The product of two floats is exact in float64; the float64 sum is not,
    and rounding it to float32 a second time can differ from a single
    rounding.  So the sum is rounded to odd first (TwoSum gives the exact
    error; a float64 result with an even last bit and a nonzero error
    moves one ulp towards the exact value), and a float64 rounded to odd
    rounds to float32 exactly as the exact value would.
    """
    p = row.double() * w.double()
    a = acc.double()
    s = p + a
    bb = s - p
    err = (p - (s - bb)) + (a - bb)
    even = (s.view(torch.int64) & 1) == 0
    inexact = (err != 0) & torch.isfinite(err)
    towards = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(inexact & even, torch.nextafter(s, towards), s)
    return s.float()


def embedding_bag_plain(table: torch.Tensor, idx: torch.Tensor,
                        weights: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version: gather field f of every bag and add it, f in
    order from zero, one rounding per step (the kernel's order)."""
    b, f = idx.shape
    acc = torch.zeros((b, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for j in range(f):
        row = table[idx[:, j].long()]
        if weights is None:
            acc = acc + row
        else:
            acc = _fma(row, weights[:, j, None], acc)
    return acc


def bag_plan(b: int, f: int, d: int, table_ptr: int,
             weighted: bool) -> tuple[int, int, int, int, int]:
    """The kernel's launch plan for B bags of F fields over a D-wide table
    at address ``table_ptr``:
    ``(vec, bags_per_block, threads, fields_per_chunk, chunk_stride)``.

    vec: floats per thread and load, the widest of 4, 2, 1 that divides D
    and the table's alignment.  Bags per block: enough for ``THREADS``
    threads, but few enough that a small batch still spreads over the SMs.
    The block stages its bags' fields (and weights) at an odd stride, all
    at once where they fit ``STAGE_WORDS``, else in chunks.
    """
    vec = next(v for v in (4, 2, 1) if d % v == 0 and table_ptr % (4 * v) == 0)
    per_bag = d // vec
    nb = max(1, min(THREADS // per_bag, -(-b // build.SMS)))
    threads = min(THREADS, -(-nb * per_bag // 32) * 32)
    words = 2 if weighted else 1
    if nb * (f | 1) * words <= STAGE_WORDS:
        fc = max(f, 1)
    else:
        fc = max(1, STAGE_WORDS // (nb * words) - 1)
    return vec, nb, threads, fc, fc | 1


@functools.cache
def _launcher():
    lib = build.load("embedding_bag")
    fn = lib.embedding_bag_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return lib, fn


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """``out[b] = sum_f weights[b, f] * table[idx[b, f]]`` -> a new f32[B, D].

    A CUDA table launches the kernel; a CPU table takes the plain version.
    Precondition: idx lies in ``[0, V)``, as the FM's ``_flat_ids`` gives
    it.  On the CPU the range is checked and a breach raises
    ``ValueError``; on the card only shapes and types are checked, since a
    range check there would wait for the device.  No tensor may require
    grad while grad mode is on: there is no backward kernel yet.
    """
    _check(table, idx, weights)
    if table.device.type == "cpu":
        _check_range(table.shape[0], idx)
        return embedding_bag_plain(table, idx, weights)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag runs on cuda or cpu, not {table.device}")
    b, f = idx.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    plan = bag_plan(b, f, d, table.data_ptr(), weights is not None)
    lib, fn = _launcher()
    with build.on_device(table.device) as stream:
        code = fn(table.data_ptr(), idx.data_ptr(),
                  None if weights is None else weights.data_ptr(),
                  out.data_ptr(), b, f, d, *plan, stream)
    build.check(lib, "embedding_bag", code)
    build.count_launch(embedding_bag)
    return out


embedding_bag.launches = 0
