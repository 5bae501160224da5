"""Hand-written CUDA kernels for Hopper, one per TPU kernel of the path.

  matrix_ingest  — int32 atomic scatter-add sketch ingest (csrc/matrix_ingest.cu)
  reach_step     — tiled boolean squaring for reachability (csrc/reach_closure.cu)

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter (``<wrapper>.launches``).  A CUDA tensor launches the kernel;
a CPU tensor takes the plain version.  ``build`` compiles the sources with
``nvcc`` at first use.
"""
from repro_torch.kernels.matrix_ingest import matrix_ingest, matrix_ingest_plain
from repro_torch.kernels.reach_closure import reach_step, reach_step_plain

__all__ = ["matrix_ingest", "matrix_ingest_plain", "reach_step", "reach_step_plain"]
