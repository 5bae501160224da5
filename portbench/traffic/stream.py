"""The benchmark's own edge-stream generator: a frozen copy.

Copied from ``src/repro_torch/streams/generators.py`` (``StreamSpec``,
``_zipf_cdf``, ``SyntheticStream.batch_numpy`` and ``num_batches``) at
commit cbdfd1d8e666db7c6b1c59ee99c9e22d4d3a7c8d, so that the yardstick does
not move when the program does.  Batch ``i`` is a pure function of
``(seed, i)``: a Philox generator keyed with the batch index draws two
Zipf-ranked endpoints per edge through seeded permutations of the node ids.

``batch_numpy`` pads the last batch with zero-weight slots, as the program's
generator does (its reservoir sample iterates padded batches);
``edge_batches`` gives the same edges without the padding, which is what
the benchmark hands to the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Static description of an edge stream (a configuration's ``stream``)."""

    name: str
    n_nodes: int
    n_edges: int
    alpha_src: float  # Zipf skew of source endpoint choice
    alpha_dst: float
    self_loops: bool = False


def _zipf_cdf(n: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    weights = ranks ** (-alpha)
    cdf = np.cumsum(weights)
    return cdf / cdf[-1]


class SyntheticStream:
    """Power-law edge stream; batch i is a pure function of (seed, i)."""

    def __init__(self, spec: StreamSpec, *, batch_size: int, seed: int):
        self.spec = spec
        self.batch_size = batch_size
        self.seed = seed
        self._cdf_src = _zipf_cdf(spec.n_nodes, spec.alpha_src)
        self._cdf_dst = _zipf_cdf(spec.n_nodes, spec.alpha_dst)
        perm_rng = np.random.default_rng(np.random.Philox(key=seed))
        self._perm_src = perm_rng.permutation(spec.n_nodes).astype(np.int32)
        self._perm_dst = perm_rng.permutation(spec.n_nodes).astype(np.int32)

    @property
    def num_batches(self) -> int:
        return -(-self.spec.n_edges // self.batch_size)

    def edges(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(src, dst) int32 of batch ``i``, without padding."""
        if not (0 <= i < self.num_batches):
            raise IndexError(i)
        lo = i * self.batch_size
        n = min(self.batch_size, self.spec.n_edges - lo)
        rng = np.random.default_rng(
            np.random.Philox(key=(self.seed << 20) + i + 1))
        u = rng.random((2, n))
        src = self._perm_src[np.searchsorted(self._cdf_src, u[0])]
        dst = self._perm_dst[np.searchsorted(self._cdf_dst, u[1])]
        if not self.spec.self_loops:
            collide = src == dst
            dst = np.where(collide, (dst + 1) % self.spec.n_nodes, dst)
        return src.astype(np.int32), dst.astype(np.int32)

    def batch_numpy(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, weight) int32[batch_size] of batch ``i``: the edges
        with weight 1, then zero-weight padding."""
        src, dst = self.edges(i)
        pad = self.batch_size - len(src)
        weight = np.concatenate([np.ones(len(src), np.int32),
                                 np.zeros(pad, np.int32)])
        zeros = np.zeros(pad, np.int32)
        return (np.concatenate([src, zeros]), np.concatenate([dst, zeros]),
                weight)

    def edge_batches(self) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Every batch as (src, dst, weight) without padding: the last one
        holds ``n_edges - (num_batches - 1) * batch_size`` edges."""
        out = []
        for i in range(self.num_batches):
            src, dst = self.edges(i)
            out.append((src, dst, np.ones(len(src), np.int32)))
        return out


def stream_from_config(config: dict, *, batch_size: int,
                       seed: int) -> SyntheticStream:
    """The stream a configuration's ``stream`` group describes, shrunk by
    its ``scale`` (default 1) as the program's ``make_stream`` shrinks a
    dataset."""
    s = config["stream"]
    scale = float(config.get("scale", 1.0))
    n_nodes, n_edges = int(s["n_nodes"]), int(s["n_edges"])
    if scale != 1.0:
        n_nodes = max(int(n_nodes * scale), 16)
        n_edges = max(int(n_edges * scale), 64)
    spec = StreamSpec(s["name"], n_nodes, n_edges, float(s["alpha_src"]),
                      float(s["alpha_dst"]), bool(s.get("self_loops", False)))
    return SyntheticStream(spec, batch_size=batch_size, seed=seed)


def sample_size(config: dict) -> int:
    """The reservoir sample's size, shrunk by ``scale`` as the program's
    registry shrinks it (never below 1,000)."""
    scale = float(config.get("scale", 1.0))
    return max(int(int(config["sample_size"]) * scale), 1000)
