"""Core stream / sketch types shared across the port."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.struct import tensor_dataclass
from repro_torch.obs.profile import profile_span


@tensor_dataclass
class EdgeBatch:
    """A fixed-size batch of stream updates ``(src, dst, weight)``.

    ``weight == 0`` marks padding slots (sketches are additive, so adding a
    zero-weight edge is a no-op; this lets every batch be a static shape).
    """

    src: torch.Tensor  # int32[B]
    dst: torch.Tensor  # int32[B]
    weight: torch.Tensor  # int32[B]

    @property
    def size(self) -> int:
        return self.src.shape[0]

    @staticmethod
    def from_numpy(src: np.ndarray, dst: np.ndarray,
                   weight: np.ndarray | None = None, *,
                   device="cuda") -> "EdgeBatch":
        def put(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int32), device=device)

        with profile_span("dispatch.from_numpy"):
            if weight is None:
                weight = np.ones_like(src, dtype=np.int32)
            return EdgeBatch(src=put(src), dst=put(dst), weight=put(weight))

    @staticmethod
    def pad_to(src: np.ndarray, dst: np.ndarray, weight: np.ndarray,
               size: int, *, device="cuda") -> "EdgeBatch":
        """The ``n <= size`` edges followed by zero-weight padding: a batch
        of ``size`` slots on ``device``."""
        n = src.shape[0]
        if n > size:
            raise ValueError(f"{n} edges do not fit a batch of {size}")
        pad = np.zeros(size - n, np.int32)
        return EdgeBatch.from_numpy(
            np.concatenate([src, pad]), np.concatenate([dst, pad]),
            np.concatenate([weight.astype(np.int32), pad]), device=device)


@tensor_dataclass
class VertexStats:
    """Per-vertex statistics estimated from a stream sample.

    These drive the partitioning objective (paper Eq. 8):
      f_v(m): summed weight of out-edges of m observed in the sample
      deg(m): number of *distinct* out-neighbours of m in the sample
    Host-side by design: only the numpy partition planner reads them, so
    the tensors stay on the CPU whatever device the sketch uses.
    """

    vertex: torch.Tensor  # int32[n] sorted unique vertex ids
    freq: torch.Tensor  # float32[n]
    deg: torch.Tensor  # float32[n]


def vertex_stats_from_sample(src: np.ndarray, dst: np.ndarray,
                             weight: np.ndarray | None = None) -> VertexStats:
    """Host-side (numpy) computation of VertexStats from sampled edges."""
    if weight is None:
        weight = np.ones_like(src, dtype=np.int64)
    order = np.argsort(src, kind="stable")
    s, d_, w_ = src[order], dst[order], weight[order]
    verts, starts = np.unique(s, return_index=True)
    ends = np.append(starts[1:], len(s))
    freq = np.add.reduceat(w_, starts).astype(np.float32)
    deg = np.empty(len(verts), np.float32)
    for i, (lo, hi) in enumerate(zip(starts, ends)):
        deg[i] = len(np.unique(d_[lo:hi]))
    return VertexStats(
        vertex=torch.as_tensor(verts.astype(np.int32)),
        freq=torch.as_tensor(freq),
        deg=torch.as_tensor(deg),
    )
