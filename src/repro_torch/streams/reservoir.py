"""Reservoir sampling over edge streams (paper §V-A: 30k-edge init sample).

Vectorized Algorithm R: a whole batch is processed with one RNG draw per
element; deterministic given (seed, stream order).  Bootstraps the kMatrix
partitioner and draws the evaluation query set.
"""
from __future__ import annotations

import numpy as np


class Reservoir:
    def __init__(self, k: int, seed: int = 0):
        self.k = k
        self._rng = np.random.default_rng(np.random.Philox(key=seed ^ 0x5EED))
        self._src = np.zeros(k, np.int32)
        self._dst = np.zeros(k, np.int32)
        self._w = np.zeros(k, np.int32)
        self._seen = 0

    def offer_batch(self, src: np.ndarray, dst: np.ndarray, w: np.ndarray) -> None:
        valid = w > 0
        src, dst, w = src[valid], dst[valid], w[valid]
        n = len(src)
        if n == 0:
            return
        pos = self._seen
        # Fill phase.
        if pos < self.k:
            take = min(self.k - pos, n)
            self._src[pos : pos + take] = src[:take]
            self._dst[pos : pos + take] = dst[:take]
            self._w[pos : pos + take] = w[:take]
            self._seen += take
            src, dst, w = src[take:], dst[take:], w[take:]
            n = len(src)
            if n == 0:
                return
        # Replacement phase: item t (1-based) replaces a random slot w.p. k/t.
        # Accepted items land in slot order, so the LAST accepted item
        # targeting a slot wins; np.unique on the reversed slot array yields
        # each slot's last occurrence (duplicate fancy-index assignment order
        # is unspecified in numpy).
        t = self._seen + np.arange(1, n + 1, dtype=np.float64)
        accept = self._rng.random(n) < (self.k / t)
        slots = self._rng.integers(0, self.k, size=n)
        idx = np.nonzero(accept)[0]
        if idx.size:
            accepted_slots = slots[idx]
            uniq, last_rev = np.unique(accepted_slots[::-1], return_index=True)
            winners = idx[idx.size - 1 - last_rev]
            self._src[uniq] = src[winners]
            self._dst[uniq] = dst[winners]
            self._w[uniq] = w[winners]
        self._seen += n

    @property
    def sample(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        n = min(self._seen, self.k)
        return self._src[:n].copy(), self._dst[:n].copy(), self._w[:n].copy()


def sample_stream(stream, k: int, seed: int = 0,
                  max_batches: int | None = None):
    """One-pass reservoir sample of ``k`` edges from a stream object."""
    res = Reservoir(k, seed)
    n = stream.num_batches if max_batches is None else min(max_batches, stream.num_batches)
    for i in range(n):
        res.offer_batch(*stream.batch_numpy(i))
    return res.sample
