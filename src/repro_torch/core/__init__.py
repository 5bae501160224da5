"""repro_torch.core — the paper's sketch, its partitioner and its queries.

  kMatrix   flat-pool layout       repro_torch.core.kmatrix
            width-class layout     repro_torch.core.kmatrix_accel  (the
            default; its ingest runs the matrix_ingest kernel)
"""
from repro_torch.core.types import EdgeBatch, VertexStats, vertex_stats_from_sample
from repro_torch.core.kmatrix import KMatrix
from repro_torch.core.kmatrix_accel import KMatrixAccel, sketch_backend

__all__ = [
    "EdgeBatch",
    "VertexStats",
    "vertex_stats_from_sample",
    "KMatrix",
    "KMatrixAccel",
    "sketch_backend",
]
