"""Fixed-arity embedding bag and its gradient: the hand-written CUDA
kernels, their wrappers and their plain versions.

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

The gradient.  ``embedding_bag_backward`` scatters a bag's output gradient
back over its rows, ``grad[idx[b, f]] += grad_out[b]``, optionally with
the FM's squared term ``2 table[idx[b, f]] grad_sq[b]``; it has kernels
of their own in the same source (the pairs bucketed by row tile, each tile
written once; ``backward_plan`` sizes them) and a plain version that sums
in float64 in field order.  The kernels sum in that order too, so the two
agree bit for bit.  The
autograd path: ``embedding_bag`` on a table that requires grad (grad mode
on) returns a bag whose backward is that kernel, and
``sum_and_square_bags`` gives the FM's Σv and Σv² bags with one backward
launch for the table's whole gradient.  A weighted bag is
differentiable in its table through the same kernel: pair (b, f) becomes
a bag of its own, whose output gradient is ``w[b, f]`` times bag b's
(``_pair_grads``), so the kernel adds ``w g + 2 t (w g_sq)`` to row
``idx[b, f]``.  The weights' gradient has no caller: weights that require
grad are refused (ROADMAP.md, §B, "the weighted bag's backward").
"""
from __future__ import annotations

import ctypes
import dataclasses
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
    if (weights is not None and torch.is_grad_enabled()
            and weights.requires_grad):
        raise NotImplementedError(
            "a weighted embedding_bag has no backward in its weights "
            "(ROADMAP.md, §B, \"the weighted bag's backward\"); give "
            "weights that do not require grad")


def _check_range(v: int, idx: torch.Tensor) -> None:
    from torch._subclasses.fake_tensor import is_fake

    if idx.numel() == 0 or is_fake(idx):  # a planning trace holds no ids
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


def _bag(table: torch.Tensor, idx: torch.Tensor,
         weights: torch.Tensor | None) -> torch.Tensor:
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


def _tracks_grad(table: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and table.requires_grad


def _pair_grads(grad: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """A weighted bag's output gradient [B, D] as the gradient of B * F
    bags of one field each, pair (b, f)'s scaled by ``weights[b, f]``."""
    b, f = weights.shape
    return (weights[:, :, None] * grad[:, None, :]).reshape(b * f, -1)


def _bag_grads(idx, weights, *grads):
    """(idx, grads) for ``embedding_bag_backward``: as given for an
    unweighted bag, one bag per pair for a weighted one."""
    if weights is None:
        return idx, [g.contiguous() for g in grads]
    return idx.reshape(-1, 1), [_pair_grads(g, weights) for g in grads]


class _Bag(torch.autograd.Function):
    """A bag whose backward is ``embedding_bag_backward``."""

    @staticmethod
    def forward(ctx, table, idx, weights):
        ctx.save_for_backward(idx, weights)
        ctx.rows = table.shape[0]
        return _bag(table, idx, weights)

    @staticmethod
    def backward(ctx, grad_out):
        idx, weights = ctx.saved_tensors
        idx, (grad_out,) = _bag_grads(idx, weights, grad_out)
        return embedding_bag_backward(grad_out, idx, ctx.rows), None, None


class _SumAndSquareBags(torch.autograd.Function):
    """The bags of ``table`` and of ``squared`` (= table * table, given, no
    grad); one ``embedding_bag_backward`` launch gives ``table``'s gradient
    through both."""

    @staticmethod
    def forward(ctx, table, squared, idx, weights):
        ctx.save_for_backward(table, idx, weights)
        return _bag(table, idx, weights), _bag(squared, idx, weights)

    @staticmethod
    def backward(ctx, grad_sum, grad_sq):
        table, idx, weights = ctx.saved_tensors
        b, d = idx.shape[0], table.shape[1]
        zero = torch.zeros((b, d), dtype=torch.float32, device=table.device)
        idx, (grad_sum, grad_sq) = _bag_grads(
            idx, weights, zero if grad_sum is None else grad_sum,
            zero if grad_sq is None else grad_sq)
        return embedding_bag_backward(grad_sum, idx, table.shape[0], table,
                                      grad_sq), None, None, None


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """``out[b] = sum_f weights[b, f] * table[idx[b, f]]`` -> a new f32[B, D].

    A CUDA table launches the kernel; a CPU table takes the plain version.
    Precondition: idx lies in ``[0, V)``, as the FM's ``_flat_ids`` gives
    it.  On the CPU the range is checked and a breach raises
    ``ValueError``; on the card only shapes and types are checked, since a
    range check there would wait for the device.  A bag of a table that
    requires grad (grad mode on) is differentiable in the table: its
    backward is ``embedding_bag_backward``.  Weights that require grad
    are refused.
    """
    _check(table, idx, weights)
    if _tracks_grad(table):
        return _Bag.apply(table, idx, weights)
    return _bag(table, idx, weights)


embedding_bag.launches = 0


def sum_and_square_bags(table: torch.Tensor, squared: torch.Tensor,
                        idx: torch.Tensor, weights: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σ w table rows, Σ w squared rows) per bag, two ``embedding_bag``
    launches; ``squared`` must hold ``table * table`` (the FM keeps it as
    a buffer).  When ``table`` requires grad (grad mode on), the pair's
    backward is one ``embedding_bag_backward`` launch with the squared
    term, ``squared`` taking no gradient."""
    _check(table, idx, weights)
    _check(squared, idx, weights)
    if squared.shape != table.shape:
        raise ValueError(f"squared must be {tuple(table.shape)}, got "
                         f"{tuple(squared.shape)}")
    if _tracks_grad(table):
        return _SumAndSquareBags.apply(table, squared, idx, weights)
    return _bag(table, idx, weights), _bag(squared, idx, weights)


# ---------------------------------------------------------------- backward --

BACKWARD_THREADS = 256  # threads per block of every backward kernel
SORT_CAP = 8_192  # K: bucket entries a reduce block sorts at once (the
# kernel's SORT_MAX, 256 threads x 32 keys)
SORT_WORDS = SORT_CAP * 33 // 32  # the sort's storage: K keys and CUB's
# padding of a word per 32
CBUF = 8_192  # floats of contributions a reduce block gathers at once
TILE_ROWS = 4_096  # most rows per tile: about K / 2, so a tile of the FM's
# densest fields (1.7 pairs a row) stays within one sort
TILE_ELEMS = 65_536  # most elements a reduce block writes (R D)
CHUNK = 4_096  # pairs a count or scatter block takes (the kernel's CHUNK,
# 256 threads x 16, sorted at once by tile)
COUNT_TILES = 12_288  # tiles a count block histograms at once (48 KB)
MAX_TILES = (1 << 20) - 1  # a scatter key packs (tile, place in chunk) in
# 20 + 12 bits


@dataclasses.dataclass(frozen=True)
class BackwardPlan:
    """``embedding_bag_backward``'s launch plan and scratch, from the
    shapes alone (``backward_plan``)."""

    rlog: int  # tiles of R = 2^rlog rows
    tiles: int  # T = ceil(num_rows / R): reduce blocks
    bbits: int  # bits of b in a bucket entry, (row in tile) << bbits | b
    pairs: int  # N = B F
    chunks: int  # C = ceil(N / CHUNK): count and scatter blocks
    count_tiles: int  # tiles a count block histograms at once

    @property
    def rows_per_tile(self) -> int:
        return 1 << self.rlog

    @property
    def scratch_words(self) -> dict[str, int]:
        """int32 words of each scratch array: key and bucket hold one word
        per pair, cnt one per (chunk, tile), tot and base one per tile, the
        ticket one."""
        return {"key": self.pairs, "bucket": self.pairs,
                "cnt": self.chunks * self.tiles, "tot": self.tiles,
                "base": self.tiles + 1, "ticket": 1}

    @property
    def smem_bytes(self) -> dict[str, int]:
        """Dynamic shared memory of the two kernels that take it: the count
        histogram; the reduce's sort storage (an estimate of CUB's), row
        runs (R + 1 words, rounded to 16 bytes) and contribution buffer."""
        runs = -(-(self.rows_per_tile + 1) // 4) * 4
        return {"count": 4 * self.count_tiles,
                "reduce": 4 * (SORT_WORDS + runs + CBUF)}


def backward_plan(b: int, f: int, d: int, num_rows: int) -> BackwardPlan:
    """The plan for B bags of F fields into a [num_rows, D] gradient.

    R: the largest power of two with R <= ``TILE_ROWS``, R D <=
    ``TILE_ELEMS``, R no more than num_rows needs, and R B <= 2^32 so that
    a bucket entry packs (row in tile, b) into 32 bits.  Chunks of
    ``CHUNK`` pairs.
    """
    pairs = b * f
    bbits = max(b - 1, 0).bit_length()
    rlog = min(TILE_ROWS.bit_length() - 1,
               max(TILE_ELEMS // max(d, 1), 1).bit_length() - 1,
               (num_rows - 1).bit_length(), 32 - bbits)
    tiles = -(-num_rows // (1 << rlog))
    chunks = max(1, -(-pairs // CHUNK))
    return BackwardPlan(rlog, tiles, bbits, pairs, chunks,
                        min(COUNT_TILES, tiles))


def _check_backward(grad_out, idx, num_rows, table, grad_sq) -> None:
    if grad_out.dim() != 2 or idx.dim() != 2 or grad_out.shape[0] != idx.shape[0]:
        raise ValueError(f"grad_out must be [B, D] and idx [B, F], got "
                         f"{tuple(grad_out.shape)} and {tuple(idx.shape)}")
    if num_rows < 1:
        raise ValueError(f"num_rows must be positive, got {num_rows}")
    if (table is None) != (grad_sq is None):
        raise ValueError("table and grad_sq come together or not at all")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    named = [("grad_out", grad_out), ("idx", idx)]
    if table is not None:
        d = grad_out.shape[1]
        if tuple(table.shape) != (num_rows, d):
            raise ValueError(f"table must be {[num_rows, d]}, got "
                             f"{list(table.shape)}")
        if tuple(grad_sq.shape) != tuple(grad_out.shape):
            raise ValueError(f"grad_sq must be {tuple(grad_out.shape)}, got "
                             f"{tuple(grad_sq.shape)}")
        named += [("table", table), ("grad_sq", grad_sq)]
    for name, t in named:
        if name != "idx" and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != grad_out.device:
            raise ValueError(f"{name} is on {t.device}, grad_out on "
                             f"{grad_out.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def embedding_bag_backward_plain(grad_out: torch.Tensor, idx: torch.Tensor,
                                 num_rows: int, table: torch.Tensor | None = None,
                                 grad_sq: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Plain PyTorch version: field f of every bag in order from zero, each
    contribution rounded once as the kernel rounds it (``fmaf(2 t, g_sq,
    g)``), summed in float64 and rounded to float32 once at the end."""
    acc = torch.zeros((num_rows, grad_out.shape[1]), dtype=torch.float64,
                      device=grad_out.device)
    for j in range(idx.shape[1]):
        rows = idx[:, j].long()
        c = grad_out if table is None else _fma(2 * table[rows], grad_sq,
                                                 grad_out)
        acc.index_add_(0, rows, c.double())
    return acc.float()


@functools.cache
def _backward_launcher():
    lib = build.load("embedding_bag")
    fn = lib.embedding_bag_backward_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    return lib, fn


def embedding_bag_backward(grad_out: torch.Tensor, idx: torch.Tensor,
                           num_rows: int, table: torch.Tensor | None = None,
                           grad_sq: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """The table gradient of an unweighted bag -> a new f32[num_rows, D]:
    ``grad[idx[b, f]] += grad_out[b] (+ 2 table[idx[b, f]] grad_sq[b])``.

    A CUDA ``grad_out`` launches the kernel, which writes every element of
    the gradient once, bit-equal to the plain version; a CPU one takes the
    plain version.  idx must lie in ``[0, num_rows)`` (checked on the CPU
    only, as for the bag).
    """
    _check_backward(grad_out, idx, num_rows, table, grad_sq)
    if grad_out.device.type == "cpu":
        _check_range(num_rows, idx)
        return embedding_bag_backward_plain(grad_out, idx, num_rows, table,
                                            grad_sq)
    if grad_out.device.type != "cuda":
        raise ValueError("embedding_bag_backward runs on cuda or cpu, not "
                         f"{grad_out.device}")
    b, f = idx.shape
    d = grad_out.shape[1]
    if b * f >= 2**31 or num_rows >= 2**31 or f > 65_535 * 32:
        raise ValueError(f"B * F = {b} * {f} and num_rows = {num_rows} must "
                         "be below 2^31, F at most 2,097,120")
    grad = torch.empty((num_rows, d), dtype=torch.float32,
                       device=grad_out.device)
    if grad.numel() == 0:
        return grad
    plan = backward_plan(b, f, d, num_rows)
    if plan.tiles > MAX_TILES:
        raise ValueError(f"{plan.tiles} tiles of {plan.rows_per_tile} rows: "
                         f"the kernels take at most {MAX_TILES}")
    words = plan.scratch_words
    scratch = torch.empty(sum(words.values()), dtype=torch.int32,
                          device=grad_out.device)
    parts, at = {}, 0
    for name, n in words.items():
        parts[name] = scratch.data_ptr() + 4 * at
        at += n
    lib, fn = _backward_launcher()
    with build.on_device(grad_out.device) as stream:
        code = fn(grad_out.data_ptr(), idx.data_ptr(),
                  None if table is None else table.data_ptr(),
                  None if grad_sq is None else grad_sq.data_ptr(),
                  grad.data_ptr(), parts["key"], parts["bucket"], parts["cnt"],
                  parts["tot"], parts["base"], parts["ticket"], b, f, d,
                  num_rows, plan.rlog, plan.bbits, plan.chunks,
                  plan.count_tiles, stream)
    build.check(lib, "embedding_bag", code)
    build.count_launch(embedding_bag_backward)
    return grad


embedding_bag_backward.launches = 0
