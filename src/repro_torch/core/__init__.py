"""repro_torch.core — the paper's sketches, its partitioner and its queries.

  CountMin  (Type I,  global)      repro_torch.core.countmin
  gSketch   (Type I,  partitioned) repro_torch.core.gsketch
  TCM       (Type II, global)      repro_torch.core.matrix_sketch (kind="tcm")
  gMatrix   (Type II, global)      repro_torch.core.matrix_sketch (kind="gmatrix")
            (ingest and point queries run the matrix_ingest and
            matrix_lookup kernels at P = 1)
  kMatrix   flat-pool layout       repro_torch.core.kmatrix
            width-class layout     repro_torch.core.kmatrix_accel  (the
            default; its ingest runs the matrix_ingest kernel)
"""
from repro_torch.core.types import EdgeBatch, VertexStats, vertex_stats_from_sample
from repro_torch.core.countmin import CountMin
from repro_torch.core.gsketch import GSketch
from repro_torch.core.matrix_sketch import MatrixSketch
from repro_torch.core.kmatrix import KMatrix
from repro_torch.core.kmatrix_accel import KMatrixAccel, sketch_backend

__all__ = [
    "EdgeBatch",
    "VertexStats",
    "vertex_stats_from_sample",
    "CountMin",
    "GSketch",
    "MatrixSketch",
    "KMatrix",
    "KMatrixAccel",
    "sketch_backend",
]
