"""Host-side fanout neighbor sampler (GraphSAGE-style) for minibatch_lg.

The port's copy of ``repro/models/gnn/sampler.py`` (numpy only, so the
same seeds give the same subgraphs bit for bit).

A *real* sampler over a CSR adjacency: seed nodes -> fanout-15 -> fanout-10,
with replacement-free sampling per node (falling back to with-replacement
when degree < fanout, matching DGL semantics).  Output is a padded, static-
shape subgraph (local node ids) ready for the device step; node budget is
batch_nodes * (1 + f1 + f1*f2) exactly as the dry-run input specs assume.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray  # int64[N+1]
    indices: np.ndarray  # int32[nnz]
    n_nodes: int

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> "CSRGraph":
        order = np.argsort(dst, kind="stable")  # CSR over incoming edges
        s, d = src[order], dst[order]
        counts = np.bincount(d, minlength=n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return CSRGraph(indptr=indptr, indices=s.astype(np.int32), n_nodes=n_nodes)


def random_regular_csr(n_nodes: int, avg_degree: int, seed: int = 0) -> CSRGraph:
    """Synthetic CSR stand-in for the full minibatch_lg graph (the 114M-edge
    Reddit-scale edge list never materializes on device; only sampled
    subgraphs do)."""
    rng = np.random.default_rng(seed)
    indptr = np.arange(n_nodes + 1, dtype=np.int64) * avg_degree
    indices = rng.integers(0, n_nodes, n_nodes * avg_degree, dtype=np.int64)
    return CSRGraph(indptr=indptr, indices=indices.astype(np.int32), n_nodes=n_nodes)


def sample_subgraph(
    graph: CSRGraph,
    seeds: np.ndarray,
    fanout: tuple[int, ...],
    *,
    seed: int = 0,
):
    """Multi-hop fanout sampling.

    Returns (nodes, edge_src_local, edge_dst_local, edge_mask) with padded
    static shapes: n_nodes = sum of layer budgets, n_edges = sum of
    per-layer edge budgets. Local ids index into ``nodes``.
    """
    rng = np.random.default_rng(seed)
    layer_nodes = [np.asarray(seeds, dtype=np.int64)]
    edges_src: list[np.ndarray] = []
    edges_dst: list[np.ndarray] = []

    frontier = layer_nodes[0]
    for f in fanout:
        deg = graph.indptr[frontier + 1] - graph.indptr[frontier]
        # sample f neighbours per frontier node (with replacement if needed)
        offsets = (rng.random((len(frontier), f)) * np.maximum(deg, 1)[:, None]).astype(np.int64)
        neigh = graph.indices[
            (graph.indptr[frontier][:, None] + offsets).clip(0, len(graph.indices) - 1)
        ]
        edges_src.append(neigh.reshape(-1))
        edges_dst.append(np.repeat(frontier, f))
        layer_nodes.append(neigh.reshape(-1).astype(np.int64))
        frontier = layer_nodes[-1]

    all_nodes = np.concatenate(layer_nodes)
    # Local ids = positions in the duplicate-preserving concat list (static
    # budget; deduplication would make shapes data-dependent). Edges flow
    # sampled-neighbour slot (layer li+1) -> frontier parent slot (layer li).
    src_local = []
    dst_local = []
    cursor = len(layer_nodes[0])
    dst_cursor = 0
    for li, f in enumerate(fanout):
        n_front = len(layer_nodes[li])
        src_local.append(np.arange(cursor, cursor + n_front * f, dtype=np.int32))
        dst_local.append(np.repeat(np.arange(dst_cursor, dst_cursor + n_front,
                                             dtype=np.int32), f))
        dst_cursor = cursor
        cursor += n_front * f

    return (
        all_nodes.astype(np.int64),  # global ids per local slot (for features)
        np.concatenate(src_local),
        np.concatenate(dst_local),
        np.ones(sum(len(s) for s in src_local), np.float32),
    )
