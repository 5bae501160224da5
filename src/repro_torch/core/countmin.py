"""CountMin sketch (Cormode & Muthukrishnan) — paper §III-A, Type I baseline.

A ``(d, w)`` counter table; every edge is reduced to a single 32-bit key and
hashed into each row by an independent 2-universal function.  The JAX
package has no Pallas kernel for it, so ingest is a plain ``scatter_add_``
into ``sk.table`` in place (the JAX package returns a new array) and queries
are a gather and a min.
"""
from __future__ import annotations

import torch

from repro_torch.common.hashing import (
    HashFamily,
    families_match,
    fastrange,
    hash_pair_mix,
)
from repro_torch.common.struct import static_field, tensor_dataclass
from repro_torch.core.kmatrix import layer_rows
from repro_torch.core.types import EdgeBatch


@tensor_dataclass
class CountMin:
    table: torch.Tensor  # int32[d, w]
    hashes: HashFamily
    w: int = static_field()

    @property
    def depth(self) -> int:
        return self.table.shape[0]

    @property
    def num_counters(self) -> int:
        return self.table.numel()

    @staticmethod
    def create(*, bytes_budget: int, depth: int = 7, seed: int = 0,
               device="cuda") -> "CountMin":
        counters = bytes_budget // 4
        w = max(counters // depth, 1)
        return CountMin(
            table=torch.zeros((depth, w), dtype=torch.int32, device=device),
            hashes=HashFamily.create(seed, depth, device=device),
            w=w,
        )


def _edge_cells(sk: CountMin, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    key = hash_pair_mix(src, dst)
    return fastrange(sk.hashes.mix(key), sk.w).long()  # [d, *S]


def ingest(sk: CountMin, batch: EdgeBatch) -> CountMin:  # writes: 0
    """Add ``batch`` into ``sk.table`` in place; returns ``sk``."""
    idx = _edge_cells(sk, batch.src, batch.dst)  # [d, B]
    sk.table.scatter_add_(1, idx, batch.weight.to(torch.int32).expand_as(idx))
    return sk


def edge_freq(sk: CountMin, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Point query: estimated frequency of each edge.  Shape-preserving."""
    idx = _edge_cells(sk, src, dst)  # [d, *S]
    rows = layer_rows(sk.depth, src.ndim, idx.device)
    return sk.table[rows, idx].amin(dim=0)


def empty_like(sk: CountMin) -> CountMin:
    """A zero-counter sketch sharing layout and hashes; fresh storage."""
    return sk.replace(table=torch.zeros_like(sk.table))


def merge(a: CountMin, b: CountMin) -> CountMin:
    """Counter-additivity into a fresh table; operands must share layout
    AND hash seeds."""
    if a.w != b.w or a.table.shape != b.table.shape:
        raise ValueError("merge: operands have different layouts")
    if not families_match(a.hashes, b.hashes):
        raise ValueError(
            "merge: operands use different hash families (built with "
            "different seeds); merging them silently corrupts estimates")
    return a.replace(table=a.table + b.table)
