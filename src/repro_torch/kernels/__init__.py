"""Hand-written CUDA kernels for Hopper, one per TPU kernel of the path.

  matrix_ingest  — int32 atomic scatter-add sketch ingest (csrc/matrix_ingest.cu)
  matrix_lookup  — gather + min over layers, sketch point queries
                   (csrc/matrix_lookup.cu)
  reach_step     — one boolean squaring on tensor cores, every layer
                   (csrc/reach_closure.cu)
  reach_closure  — the whole boolean closure of every layer in one launch,
                   for layers that fit one block (csrc/reach_closure.cu)
  embedding_bag  — fixed-arity row gather + sum, the FM's lookups
                   (csrc/embedding_bag.cu)

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter (``<wrapper>.launches``).  A CUDA tensor launches the kernel;
a CPU tensor takes the plain version.  ``build`` compiles the sources with
``nvcc`` at first use.
"""
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_plain
from repro_torch.kernels.matrix_ingest import matrix_ingest, matrix_ingest_plain
from repro_torch.kernels.matrix_lookup import matrix_lookup, matrix_lookup_plain
from repro_torch.kernels.reach_closure import (
    reach_closure,
    reach_closure_plain,
    reach_step,
    reach_step_plain,
)

__all__ = ["embedding_bag", "embedding_bag_plain", "matrix_ingest",
           "matrix_ingest_plain", "matrix_lookup", "matrix_lookup_plain",
           "reach_closure", "reach_closure_plain", "reach_step",
           "reach_step_plain"]
