"""Deterministic, seekable synthetic graph-stream generators.

The paper benchmarks on unicorn-wget, email-EuAll and cit-HepPh; those files
are not available offline, so the streams are *statistically matched*:
same node/edge counts, and power-law out/in-degree with per-dataset skew.
A real edge list on disk (a SNAP file's ``src dst`` lines with ``#``
comments) is read by ``FileStream``, which batches and replays as the
generated streams do.

Replayability contract: batch ``i`` of a stream is a pure function of
``(seed, i)`` — a Philox generator keyed with the batch index — so seeking to
any offset is O(1).  The generator is numpy; only ``batch`` puts a batch on
a device.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Iterator

import numpy as np

from repro_torch.core.types import EdgeBatch


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Static description of an edge stream."""

    name: str
    n_nodes: int
    n_edges: int
    alpha_src: float  # Zipf skew of source endpoint choice
    alpha_dst: float
    self_loops: bool = False


# Paper §V-B datasets, statistically matched (node/edge counts from the text).
UNICORN_WGET = StreamSpec("unicorn-wget", 17_778, 277_972, 1.2, 1.1)
EMAIL_EUALL = StreamSpec("email-EuAll", 265_214, 420_045, 1.35, 1.25)
CIT_HEPPH = StreamSpec("cit-HepPh", 34_546, 421_578, 1.05, 1.3)
DATASETS = {s.name: s for s in (UNICORN_WGET, EMAIL_EUALL, CIT_HEPPH)}


def _padded(src: np.ndarray, dst: np.ndarray, size: int
            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(src, dst, weight) int32[size]: the edges with weight 1, then
    zero-weight padding up to ``size``."""
    n = len(src)
    weight = np.ones(n, np.int32)
    if n < size:
        pad = np.zeros(size - n, np.int32)
        src, dst = np.concatenate([src, pad]), np.concatenate([dst, pad])
        weight = np.concatenate([weight, pad])
    return src.astype(np.int32), dst.astype(np.int32), weight


def _zipf_cdf(n: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    weights = ranks ** (-alpha)
    cdf = np.cumsum(weights)
    return cdf / cdf[-1]


class SyntheticStream:
    """Power-law edge stream; batch i is a pure function of (seed, i)."""

    def __init__(self, spec: StreamSpec, *, batch_size: int = 8192, seed: int = 0):
        self.spec = spec
        self.batch_size = batch_size
        self.seed = seed
        self._cdf_src = _zipf_cdf(spec.n_nodes, spec.alpha_src)
        self._cdf_dst = _zipf_cdf(spec.n_nodes, spec.alpha_dst)
        # Node identities are a seeded permutation so that "rank 1" is not
        # always vertex 0 (adversarial for sequential-id hash families).
        perm_rng = np.random.default_rng(np.random.Philox(key=seed))
        self._perm_src = perm_rng.permutation(spec.n_nodes).astype(np.int32)
        self._perm_dst = perm_rng.permutation(spec.n_nodes).astype(np.int32)

    @property
    def num_batches(self) -> int:
        return -(-self.spec.n_edges // self.batch_size)

    def batch_numpy(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, weight) for batch ``i``; final batch zero-padded."""
        if not (0 <= i < self.num_batches):
            raise IndexError(i)
        lo = i * self.batch_size
        n = min(self.batch_size, self.spec.n_edges - lo)
        rng = np.random.default_rng(np.random.Philox(key=(self.seed << 20) + i + 1))
        u = rng.random((2, n))
        src = self._perm_src[np.searchsorted(self._cdf_src, u[0])]
        dst = self._perm_dst[np.searchsorted(self._cdf_dst, u[1])]
        if not self.spec.self_loops:
            collide = src == dst
            dst = np.where(collide, (dst + 1) % self.spec.n_nodes, dst)
        return _padded(src, dst, self.batch_size)

    def batch(self, i: int, *, device="cuda") -> EdgeBatch:
        return EdgeBatch.from_numpy(*self.batch_numpy(i), device=device)

    def __iter__(self) -> Iterator[EdgeBatch]:
        """Every batch in order, on the card (``iter_from`` takes a
        device)."""
        for i in range(self.num_batches):
            yield self.batch(i)

    def iter_from(self, offset: int, *,
                  device="cuda") -> Iterator[tuple[int, EdgeBatch]]:
        """Resume iteration from a checkpointed batch offset: yields
        ``(i, batch i)`` on ``device`` for every i >= offset."""
        for i in range(offset, self.num_batches):
            yield i, self.batch(i, device=device)

    def all_edges_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Materialize the full stream host-side (evaluation oracles only)."""
        parts = [self.batch_numpy(i) for i in range(self.num_batches)]
        src = np.concatenate([p[0] for p in parts])
        dst = np.concatenate([p[1] for p in parts])
        w = np.concatenate([p[2] for p in parts])
        keep = w > 0
        return src[keep], dst[keep], w[keep]


class FileStream:
    """Edge-list file stream: one ``src dst`` pair per line, ``#`` comments
    (a SNAP file; tabs or spaces, further columns ignored).  Loaded once
    host-side; batching and replay as ``SyntheticStream``'s: weights 1, the
    last batch zero-padded, batch ``i`` the file's edges ``i * batch_size``
    on.  ``spec.n_nodes`` is the largest id + 1, its skews 0.

    Ids must lie in [0, 2^31), the int32 range the sketches hash: the JAX
    package's ``FileStream`` wraps a larger id to a negative one and keeps
    a negative id, where this one raises ``ValueError`` naming the value.
    A file with no edges raises ``ValueError`` too.
    """

    def __init__(self, path: str, *, batch_size: int = 8192,
                 name: str | None = None):
        with warnings.catch_warnings():  # an empty file: refused below
            warnings.simplefilter("ignore", UserWarning)
            edges = np.loadtxt(path, dtype=np.int64, comments="#", ndmin=2)
        if edges.shape[0] == 0:
            raise ValueError(f"{path}: no edges")
        if edges.shape[1] < 2:
            raise ValueError(f"{path}: a line holds one id, not 'src dst'")
        ids = edges[:, :2]
        outside = (ids < 0) | (ids > np.iinfo(np.int32).max)
        if outside.any():
            row = int(np.argmax(outside.any(axis=1)))
            value = int(ids[outside][0])
            raise ValueError(f"{path}: vertex id {value} on edge {row} lies "
                             "outside [0, 2^31)")
        self._src = ids[:, 0].astype(np.int32)
        self._dst = ids[:, 1].astype(np.int32)
        self.batch_size = batch_size
        n_nodes = int(max(self._src.max(), self._dst.max())) + 1
        self.spec = StreamSpec(name or os.path.basename(path), n_nodes,
                               len(self._src), 0.0, 0.0)

    @property
    def num_batches(self) -> int:
        return -(-self.spec.n_edges // self.batch_size)

    def batch_numpy(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, weight) for batch ``i``; final batch zero-padded."""
        if not (0 <= i < self.num_batches):
            raise IndexError(i)
        lo = i * self.batch_size
        hi = min(lo + self.batch_size, self.spec.n_edges)
        return _padded(self._src[lo:hi], self._dst[lo:hi], self.batch_size)

    def batch(self, i: int, *, device="cuda") -> EdgeBatch:
        return EdgeBatch.from_numpy(*self.batch_numpy(i), device=device)

    def __iter__(self) -> Iterator[EdgeBatch]:
        """Every batch in order, on the card (``iter_from`` takes a
        device)."""
        for i in range(self.num_batches):
            yield self.batch(i)

    def iter_from(self, offset: int, *,
                  device="cuda") -> Iterator[tuple[int, EdgeBatch]]:
        """``(i, batch i)`` on ``device`` for every i >= offset."""
        for i in range(offset, self.num_batches):
            yield i, self.batch(i, device=device)

    def all_edges_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The file's edges host-side, weights 1 (evaluation oracles)."""
        return self._src, self._dst, np.ones(len(self._src), np.int32)


def make_stream(name: str, *, batch_size: int = 8192, seed: int = 0,
                scale: float = 1.0) -> SyntheticStream:
    """Stream factory. ``scale`` < 1 shrinks a dataset preset."""
    spec = DATASETS[name]
    if scale != 1.0:
        spec = dataclasses.replace(
            spec,
            n_nodes=max(int(spec.n_nodes * scale), 16),
            n_edges=max(int(spec.n_edges * scale), 64),
        )
    return SyntheticStream(spec, batch_size=batch_size, seed=seed)
