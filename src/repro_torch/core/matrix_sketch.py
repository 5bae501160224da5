"""TCM / gMatrix — paper §III-C/D, the Type II global-sketch baselines.

Both store ``d`` layers of ``w x w`` counter matrices; an edge ``(i, j)`` is
hashed to cell ``(h_r(i), h_r(j))`` in layer ``r``.  TCM as published uses
arbitrary hash functions; gMatrix requires pairwise independent ones, which
is what ``HashFamily`` provides, so the two differ only in their ``kind``
label and build identical tables from the same seed (as in the JAX package).

Ingest and edge-frequency queries are one launch each of the hand-written
kernels, which hash the raw edges themselves: ``matrix_ingest_edges`` adds
a batch into ``sk.table`` (viewed as ``[d, 1, w, w]``) in place (the JAX
package returns a new array) and ``matrix_lookup_edges`` answers point
queries.  On a CPU table both take their plain versions.  ``empty_like``
and ``merge`` return fresh storage.
"""
from __future__ import annotations

import torch

from repro_torch.common.hashing import HashFamily, families_match, fastrange
from repro_torch.common.struct import static_field, tensor_dataclass
from repro_torch.core.kmatrix import layer_rows
from repro_torch.core.types import EdgeBatch
from repro_torch.kernels.matrix_ingest import matrix_ingest_edges
from repro_torch.kernels.matrix_lookup import matrix_lookup_edges
from repro_torch.obs.profile import profile_span


@tensor_dataclass
class MatrixSketch:
    table: torch.Tensor  # int32[d, w, w]
    hashes: HashFamily
    w: int = static_field()
    kind: str = static_field(default="gmatrix")  # "tcm" | "gmatrix"

    @property
    def depth(self) -> int:
        return self.table.shape[0]

    @property
    def num_counters(self) -> int:
        return self.table.numel()

    @staticmethod
    def create(*, bytes_budget: int, depth: int = 7, seed: int = 0,
               kind: str = "gmatrix", device="cuda") -> "MatrixSketch":
        counters = bytes_budget // 4
        w = max(int((counters // depth) ** 0.5), 2)
        return MatrixSketch(
            table=torch.zeros((depth, w, w), dtype=torch.int32, device=device),
            hashes=HashFamily.create(seed, depth, device=device),
            w=w,
            kind=kind,
        )


def node_cells(sk: MatrixSketch, v: torch.Tensor) -> torch.Tensor:
    """Per-layer hash slot of vertex ``v`` -> int32[d, *S]."""
    return fastrange(sk.hashes.mix(v), sk.w)


def ingest(sk: MatrixSketch,
           batch: EdgeBatch) -> MatrixSketch:  # writes: 0
    """Add ``batch`` into ``sk.table`` in place (one ``matrix_ingest_edges``
    launch on a CUDA table); returns ``sk``.  Every nonzero weight counts,
    negative (turnstile) ones too, as in the JAX package."""
    with profile_span("sketch.ingest"):
        matrix_ingest_edges((sk.table.unsqueeze(1),), sk.hashes.a,
                            sk.hashes.b, *(_int32(x) for x in (
                                batch.src, batch.dst, batch.weight)))
    return sk


def edge_freq(sk: MatrixSketch, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Point queries (one ``matrix_lookup_edges`` launch on a CUDA table);
    shape-preserving."""
    with profile_span("query.edge_freq"):
        est = matrix_lookup_edges(sk.table, sk.hashes.a, sk.hashes.b,
                                  _int32(src), _int32(dst))
        return est.view(src.shape)


def _int32(x: torch.Tensor) -> torch.Tensor:
    """Flat contiguous int32: the same uint32 under the hashes as ``x``
    (the low 32 bits, two's complement)."""
    return x.reshape(-1).to(torch.int32).contiguous()


def node_out_freq(sk: MatrixSketch, v: torch.Tensor) -> torch.Tensor:
    """Aggregate out-weight of vertex ``v``: min over layers of its row sum."""
    with profile_span("query.node_freq"):
        hv = node_cells(sk, v).long()  # [d, *S]
        rows = layer_rows(sk.depth, v.ndim, v.device)
        # [d, *S]
        sums = sk.table[rows, hv, :].sum(dim=-1, dtype=torch.int32)
        return sums.amin(dim=0)


def node_in_freq(sk: MatrixSketch, v: torch.Tensor) -> torch.Tensor:
    """Aggregate in-weight of vertex ``v``: min over layers of its column sum."""
    with profile_span("query.node_freq"):
        hv = node_cells(sk, v).long()
        rows = layer_rows(sk.depth, v.ndim, v.device)
        # advanced indices around the middle slice put the broadcast dims in
        # front, as in numpy: gathered shape is [d, *S, w]
        sums = sk.table[rows, :, hv].sum(dim=-1, dtype=torch.int32)
        return sums.amin(dim=0)


def empty_like(sk: MatrixSketch) -> MatrixSketch:
    """A zero-counter sketch sharing layout and hashes; fresh storage."""
    with profile_span("sketch.empty_like"):
        return sk.replace(table=torch.zeros_like(sk.table))


def merge(a: MatrixSketch, b: MatrixSketch) -> MatrixSketch:
    """Counter-additivity into a fresh table; operands must share layout
    AND hash seeds."""
    if a.w != b.w or a.table.shape != b.table.shape:
        raise ValueError("merge: operands have different layouts")
    if not families_match(a.hashes, b.hashes):
        raise ValueError(
            "merge: operands use different hash families (built with "
            "different seeds); merging them silently corrupts estimates")
    with profile_span("sketch.merge"):
        return a.replace(table=a.table + b.table)
