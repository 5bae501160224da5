"""Boolean transitive closure on tensor cores: the hand-written CUDA kernels,
their wrappers and their plain versions.

    reach_step(R)                  R[l] <- min(R[l] @ R[l], 1)
                                   R: float32[d, w, w], entries 0 or 1
    reach_closure(table, n_steps)  (table > 0) + I, squared n_steps times
                                   -> bool[d, w, w], in one launch

Both kernels (``csrc/reach_closure.cu``) replace the Pallas tiled product
``repro/kernels/reach_closure.py:reach_step``; ``reach_step`` squares all d
layers in one launch, ``reach_closure`` runs the whole cascade with each
layer in one block's shared memory, for w up to ``CLOSURE_MAX_W``.  See the
source for the design and the exactness argument.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

STEP_TILES = (128, 32)  # output tile edges of the reach_step kernel
SMEM_BLOCK_MAX = 232_448  # dynamic shared memory one block may have (bytes)


def closure_smem_bytes(w: int) -> int:
    """Shared memory of ``reach_closure`` at width w: two bf16 copies of the
    layer padded to W = 16 ceil(w / 16) rows of W + 8 columns."""
    pad = -(-w // 16) * 16
    return 2 * pad * (pad + 8) * 2


def closure_fits(w: int) -> bool:
    """Whether a w-wide layer fits one block: w <= ``CLOSURE_MAX_W``."""
    return closure_smem_bytes(w) <= SMEM_BLOCK_MAX


CLOSURE_MAX_W = max(w for w in range(1, 1025) if closure_fits(w))  # 224


def step_tile(d: int, w: int) -> int:
    """The reach_step kernel's output tile: 128 where that still gives
    every SM a block, else 32."""
    for tile in STEP_TILES:
        if d * (-(-w // tile)) ** 2 >= build.SMS:
            return tile
    return STEP_TILES[-1]


def _check(reach: torch.Tensor) -> None:
    if reach.dim() != 3 or reach.shape[1] != reach.shape[2]:
        raise ValueError(f"reach must be [d, w, w], got {tuple(reach.shape)}")
    if reach.dtype != torch.float32:
        raise TypeError(f"reach must be float32, got {reach.dtype}")
    if not reach.is_contiguous():
        raise ValueError("reach must be contiguous")


def _check_table(table: torch.Tensor, n_steps: int) -> None:
    if table.dim() != 3 or table.shape[1] != table.shape[2]:
        raise ValueError(f"table must be [d, w, w], got {tuple(table.shape)}")
    if table.dtype != torch.int32:
        raise TypeError(f"table must be int32, got {table.dtype}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")


def reach_step_plain(reach: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``clamp(bmm(R, R), max=1)``."""
    return torch.clamp(torch.bmm(reach, reach), max=1.0)


def closure_start(table: torch.Tensor) -> torch.Tensor:
    """``(table > 0) + I`` as float32 0/1: the cascade's first matrix."""
    w = table.shape[-1]
    eye = torch.eye(w, dtype=torch.float32, device=table.device)
    return torch.clamp((table > 0).to(torch.float32) + eye, max=1.0)


def closure_cascade(table: torch.Tensor, n_steps: int, step) -> torch.Tensor:
    """``closure_start``, ``n_steps`` calls of ``step``, then ``> 0.5``."""
    reach = closure_start(table)
    for _ in range(n_steps):
        reach = step(reach)
    return reach > 0.5


def reach_closure_plain(table: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Plain PyTorch version: the ``reach_step_plain`` cascade."""
    return closure_cascade(table, n_steps, reach_step_plain)


@functools.cache
def _launchers():
    lib = build.load("reach_closure")
    step = lib.reach_step_launch
    step.restype = ctypes.c_int
    step.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    closure = lib.reach_closure_launch
    closure.restype = ctypes.c_int
    closure.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib, step, closure


def reach_step(reach: torch.Tensor) -> torch.Tensor:
    """One squaring of every layer into a new tensor.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    Precondition: every entry is 0 or 1 (the kernel multiplies in bf16,
    exact only there), as ``closure_start`` and every squaring give it.  On
    the CPU it is checked and a breach raises ``ValueError``; on the card
    it is not, since the check would wait for the device.
    """
    _check(reach)
    if reach.device.type == "cpu":
        if not bool(((reach == 0) | (reach == 1)).all()):
            raise ValueError("reach must hold only 0 and 1")
        return reach_step_plain(reach)
    if reach.device.type != "cuda":
        raise ValueError(f"reach_step runs on cuda or cpu, not {reach.device}")
    d, w, _ = reach.shape
    if d > 65535:
        raise ValueError(f"d = {d} layers must be <= 65535")
    out = torch.empty_like(reach)
    lib, fn, _ = _launchers()
    with build.on_device(reach.device) as stream:
        code = fn(reach.data_ptr(), out.data_ptr(), d, w, step_tile(d, w),
                  stream)
    build.check(lib, "reach_step", code)
    build.count_launch(reach_step)
    return out


reach_step.launches = 0


def reach_closure(table: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Boolean closure of every layer of int32[d, w, w] counters ->
    bool[d, w, w]: ``(table > 0) + I`` squared ``n_steps`` times.

    A CUDA tensor launches the kernel once, for w up to ``CLOSURE_MAX_W``
    (224: two bf16 copies of the padded layer within the 232,448 bytes of
    shared memory a block may have); a wider table raises.  A CPU tensor
    takes the plain version.  The kernel stops squaring a layer once a
    squaring leaves it unchanged, which gives the same result.
    """
    _check_table(table, n_steps)
    if table.device.type == "cpu":
        return reach_closure_plain(table, n_steps)
    if table.device.type != "cuda":
        raise ValueError(f"reach_closure runs on cuda or cpu, not {table.device}")
    d, w, _ = table.shape
    if not closure_fits(w):
        raise ValueError(f"reach_closure takes w <= {CLOSURE_MAX_W}, got {w}")
    out = torch.empty(table.shape, dtype=torch.bool, device=table.device)
    lib, _, fn = _launchers()
    with build.on_device(table.device) as stream:
        code = fn(table.data_ptr(), out.data_ptr(), d, w, n_steps, stream)
    build.check(lib, "reach_closure", code)
    build.count_launch(reach_closure)
    return out


reach_closure.launches = 0
