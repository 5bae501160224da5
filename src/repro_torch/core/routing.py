"""Vertex -> partition routing for kMatrix.

The partition plan is host-side (numpy); at stream time routing is a binary
search over the sorted sampled-vertex table (``torch.searchsorted``), falling
back to the outlier partition for unseen vertices (paper §IV-A).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.struct import static_field, tensor_dataclass
from repro_torch.core.partitioning import PartitionPlan


@tensor_dataclass
class RouteTable:
    keys: torch.Tensor  # int32[n] sorted sampled vertex ids
    part: torch.Tensor  # int32[n] partition index per key
    offsets: torch.Tensor  # int32[P] slab offset per partition
    widths: torch.Tensor  # int32[P] hash width per partition
    outlier: int = static_field()
    n_partitions: int = static_field()
    max_width: int = static_field()

    @property
    def routed_bytes(self) -> int:
        """Bytes of the routing table proper: its int32 keys and parts."""
        return (self.keys.numel() + self.part.numel()) * 4

    def lookup(self, v: torch.Tensor) -> torch.Tensor:
        """Partition id (int32) for each vertex in ``v`` (any shape)."""
        v = v.to(torch.int32)
        if self.keys.shape[0] == 0:
            return torch.full(v.shape, self.outlier, dtype=torch.int32,
                              device=v.device)
        pos = torch.searchsorted(self.keys, v)
        pos = pos.clamp_(0, self.keys.shape[0] - 1)
        found = self.keys[pos] == v
        return torch.where(found, self.part[pos], self.outlier)


def route_table_from_plan(plan: PartitionPlan, *, square: bool,
                          device="cuda") -> tuple[RouteTable, int]:
    """Build the RouteTable + total pool size from a PartitionPlan.

    Slab size per partition is ``w**2`` (kMatrix, 2-D) or ``w`` (1-D).
    Returns (table, pool_size).
    """
    widths = np.asarray(plan.widths, dtype=np.int64)
    slab = widths**2 if square else widths
    offsets = np.concatenate([[0], np.cumsum(slab)[:-1]]).astype(np.int32)
    pool_size = int(slab.sum())
    table = RouteTable(
        keys=torch.as_tensor(plan.route_keys, device=device),
        part=torch.as_tensor(plan.route_part, device=device),
        offsets=torch.as_tensor(offsets, device=device),
        widths=torch.as_tensor(widths.astype(np.int32), device=device),
        outlier=plan.outlier,
        n_partitions=len(plan.partitions),
        max_width=int(widths.max()) if len(widths) else 0,
    )
    return table, pool_size


def routes_match(a: RouteTable, b: RouteTable) -> bool:
    """Whether two route tables encode the same partition plan.  Used by
    sketch ``merge``: equal layouts and hash families can still route
    vertices to different slabs when built from different samples."""
    return (
        a.outlier == b.outlier
        and a.keys.shape == b.keys.shape
        and a.offsets.shape == b.offsets.shape
        and all(torch.equal(x.cpu(), y.cpu())
                for x, y in [(a.keys, b.keys), (a.part, b.part),
                             (a.offsets, b.offsets), (a.widths, b.widths)])
    )
