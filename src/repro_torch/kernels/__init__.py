"""Hand-written CUDA kernels for Hopper, one per TPU kernel of the path.

  matrix_ingest  — int32 atomic scatter-add sketch ingest on the TPU's
                   rectangles (csrc/matrix_ingest.cu)
  matrix_ingest_edges — the whole batch ingest from the raw edges: routing,
                   hashing and the scatter-add in one launch (same file)
  matrix_lookup  — gather + min over layers, sketch point queries on given
                   cells (csrc/matrix_lookup.cu)
  matrix_lookup_edges — the same from the raw query endpoints, hashed in
                   the kernel (same file)
  kmatrix_lookup_edges, kmatrix_node_out — the width-class kMatrix's edge
                   and node-out queries, routing and the class-table
                   gather in one launch each (same file; the JAX package
                   runs them as gathers outside any kernel)
  reach_step     — one boolean squaring on tensor cores, every layer
                   (csrc/reach_closure.cu)
  reach_closure  — the whole boolean closure of every layer in one launch,
                   for layers that fit one block (csrc/reach_closure.cu)
  embedding_bag  — fixed-arity row gather + sum, the FM's lookups
                   (csrc/embedding_bag.cu)
  embedding_bag_backward — the bag's table gradient, a scatter-add with
                   the FM's squared term, for training (same file)

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter (``<wrapper>.launches``; ``launch_counts()`` reads them
all).  A CUDA tensor launches the kernel; a CPU tensor takes the plain
version.  ``build`` compiles the sources with
``nvcc`` at first use; ``csrc/sketch_addr.cuh`` holds the hashing and
routing that the edge and kMatrix query kernels share.  ``ops`` (the bindings to sketch
state) is loaded on first use: it imports ``repro_torch.core``, whose
sketches import the wrappers here.
"""
from repro_torch.kernels.embedding_bag import (
    embedding_bag,
    embedding_bag_backward,
    embedding_bag_backward_plain,
    embedding_bag_plain,
    sum_and_square_bags,
)
from repro_torch.kernels.matrix_ingest import (
    matrix_ingest,
    matrix_ingest_edges,
    matrix_ingest_edges_plain,
    matrix_ingest_plain,
)
from repro_torch.kernels.matrix_lookup import (
    kmatrix_lookup_edges,
    kmatrix_lookup_edges_plain,
    kmatrix_node_out,
    kmatrix_node_out_plain,
    matrix_lookup,
    matrix_lookup_edges,
    matrix_lookup_edges_plain,
    matrix_lookup_plain,
)
from repro_torch.kernels.reach_closure import (
    reach_closure,
    reach_closure_plain,
    reach_step,
    reach_step_plain,
)

__all__ = ["embedding_bag", "embedding_bag_backward",
           "embedding_bag_backward_plain", "embedding_bag_plain",
           "sum_and_square_bags", "matrix_ingest",
           "matrix_ingest_edges", "matrix_ingest_edges_plain",
           "matrix_ingest_plain", "kmatrix_lookup_edges",
           "kmatrix_lookup_edges_plain", "kmatrix_node_out",
           "kmatrix_node_out_plain", "matrix_lookup", "matrix_lookup_edges",
           "matrix_lookup_edges_plain", "matrix_lookup_plain",
           "reach_closure", "reach_closure_plain", "reach_step",
           "reach_step_plain", "launch_counts", "ops"]


def launch_counts() -> dict:
    """Each kernel wrapper's launch count in this process, by name."""
    return {fn.__name__: fn.launches for fn in (
        matrix_ingest, matrix_ingest_edges, matrix_lookup, matrix_lookup_edges,
        kmatrix_lookup_edges, kmatrix_node_out, reach_step, reach_closure,
        embedding_bag, embedding_bag_backward)}


def __getattr__(name: str):
    if name != "ops":
        raise AttributeError(
            f"module 'repro_torch.kernels' has no attribute {name!r}")
    import importlib

    return importlib.import_module("repro_torch.kernels.ops")
