"""Sketch construction from a byte budget, for every sketch kind of the
paper's comparison (the JAX package's ``serving/registry.build_sketch``)."""
from __future__ import annotations

from repro_torch.core import countmin, gsketch, kmatrix, kmatrix_accel, matrix_sketch
from repro_torch.core.countmin import CountMin
from repro_torch.core.gsketch import GSketch
from repro_torch.core.kmatrix import KMatrix
from repro_torch.core.kmatrix_accel import KMatrixAccel, sketch_backend
from repro_torch.core.matrix_sketch import MatrixSketch

SKETCHES = ("countmin", "gsketch", "tcm", "gmatrix", "kmatrix")


def build_sketch(name: str, budget: int, stats, depth: int, seed: int,
                 partitioner: str = "banded", backend: str | None = None, *,
                 device="cuda"):
    """Construct a sketch kind from a byte budget; returns (sketch, module).

    As in the JAX package: gSketch always takes the greedy plan at its
    default ``min_width`` (``partitioner`` applies to kMatrix only), and
    ``tcm`` and ``gmatrix`` differ only in their label, so the same seed
    gives them identical tables.  For ``kmatrix`` the layout is a backend
    choice (``sketch_backend``): ``width_class`` (the default) builds
    ``KMatrixAccel``, whose ingest runs the ``matrix_ingest`` kernel;
    ``flat`` the flat-pool ``KMatrix``.
    """
    if name not in SKETCHES:
        raise ValueError(f"unknown sketch {name!r} (expected one of {SKETCHES})")
    if name == "countmin":
        return CountMin.create(bytes_budget=budget, depth=depth, seed=seed,
                               device=device), countmin
    if name in ("tcm", "gmatrix"):
        return MatrixSketch.create(bytes_budget=budget, depth=depth, seed=seed,
                                   kind=name, device=device), matrix_sketch
    if name == "gsketch":
        return GSketch.create(bytes_budget=budget, stats=stats, depth=depth,
                              seed=seed, device=device), gsketch
    if sketch_backend(backend) == "width_class":
        return KMatrixAccel.create(
            bytes_budget=budget, stats=stats, depth=depth, seed=seed,
            partitioner=partitioner, device=device), kmatrix_accel
    return KMatrix.create(bytes_budget=budget, stats=stats, depth=depth,
                          seed=seed, partitioner=partitioner,
                          device=device), kmatrix
