"""Sketch construction from a byte budget.

Only the kMatrix is ported so far; every other sketch kind of the JAX
package's registry raises ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.core import kmatrix, kmatrix_accel
from repro_torch.core.kmatrix import KMatrix
from repro_torch.core.kmatrix_accel import KMatrixAccel, sketch_backend

SKETCHES = ("countmin", "gsketch", "tcm", "gmatrix", "kmatrix")


def build_sketch(name: str, budget: int, stats, depth: int, seed: int,
                 partitioner: str = "banded", backend: str | None = None, *,
                 device="cuda"):
    """Construct a sketch kind from a byte budget; returns (sketch, module).

    For ``kmatrix`` the layout is a backend choice (``sketch_backend``):
    ``width_class`` (the default) builds ``KMatrixAccel``, whose ingest runs
    the ``matrix_ingest`` kernel; ``flat`` the flat-pool ``KMatrix``.
    """
    if name not in SKETCHES:
        raise ValueError(f"unknown sketch {name!r} (expected one of {SKETCHES})")
    if name != "kmatrix":
        raise NotImplementedError(f"sketch {name!r} is not ported yet")
    if sketch_backend(backend) == "width_class":
        return KMatrixAccel.create(
            bytes_budget=budget, stats=stats, depth=depth, seed=seed,
            partitioner=partitioner, device=device), kmatrix_accel
    return KMatrix.create(bytes_budget=budget, stats=stats, depth=depth,
                          seed=seed, partitioner=partitioner,
                          device=device), kmatrix
