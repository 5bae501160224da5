"""One boolean transitive-closure squaring step for every layer: the
hand-written CUDA kernel, its wrapper and its plain version.

    R[l] <- min(R[l] @ R[l], 1)       R: float32[d, w, w]

The kernel (``csrc/reach_closure.cu``) replaces the Pallas tiled product
``repro/kernels/reach_closure.py:reach_step``; one launch squares all d
layers, and the ragged edge is masked instead of padded.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build


def _check(reach: torch.Tensor) -> None:
    if reach.dim() != 3 or reach.shape[1] != reach.shape[2]:
        raise ValueError(f"reach must be [d, w, w], got {tuple(reach.shape)}")
    if reach.dtype != torch.float32:
        raise TypeError(f"reach must be float32, got {reach.dtype}")
    if not reach.is_contiguous():
        raise ValueError("reach must be contiguous")


def reach_step_plain(reach: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``clamp(bmm(R, R), max=1)``."""
    return torch.clamp(torch.bmm(reach, reach), max=1.0)


@functools.cache
def _launcher():
    lib = build.load("reach_closure")
    fn = lib.reach_step_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    return lib, fn


def reach_step(reach: torch.Tensor) -> torch.Tensor:
    """One squaring of every layer into a new tensor.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
    """
    _check(reach)
    if reach.device.type == "cpu":
        return reach_step_plain(reach)
    if reach.device.type != "cuda":
        raise ValueError(f"reach_step runs on cuda or cpu, not {reach.device}")
    d, w, _ = reach.shape
    if d > 65535:
        raise ValueError(f"d = {d} layers must be <= 65535")
    out = torch.empty_like(reach)
    lib, fn = _launcher()
    with build.on_device(reach.device) as stream:
        code = fn(reach.data_ptr(), out.data_ptr(), d, w, stream)
    build.check(lib, "reach_step", code)
    reach_step.launches += 1
    return out


reach_step.launches = 0
