"""Graph batch representation and the message-passing primitives.

The port of ``repro/models/gnn/graph.py``.  Message passing is an explicit
edge-index scatter: gather source features -> edge function -> sum into
destinations.  ``scatter_sum`` (``index_add``) and ``scatter_max``
(``scatter_reduce``) are the JAX package's ``segment_sum`` /
``segment_max``: plain XLA there, plain PyTorch here.  On the card both
add with float atomics, so the order of a node's sum varies from run to
run; on the CPU they add in edge order.

Graphs are padded to static shapes: ``edge_mask`` / ``node_mask`` mark real
entries (padding edges point at node 0 with mask 0, and the segment ops
weight them out).  Index fields stay int32, the JAX package's dtype, and
are widened only where a torch op needs int64.

On a mesh.  Under an installed mesh (``mesh_ops.use_mesh``) a graph is
split over every axis of it, as the JAX package's specs split it: each
rank holds its block of every node array (rows ``r * N`` on, ``N`` =
``g.n_nodes`` its rows, ``r`` its index over every axis) and of every
edge array, and the edges name nodes by their index in the whole graph.
Each rank passes its own edges' messages: ``whole`` gathers a node array
from every rank's block (its adjoint a reduce-scatter), the messages are
summed into a whole-graph buffer of ``graph_nodes(g)`` rows, and
``own_block`` sums those buffers over the ranks into this rank's rows.
Per-graph sums are summed over the ranks (``summed``).  Off a mesh each
of these is the identity.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.common.struct import static_field, tensor_dataclass
from repro_torch.distributed import mesh_ops


@tensor_dataclass
class GraphBatch:
    """A (possibly padded) graph or batch of graphs.

    For batched small graphs (the molecule shape) the graphs are
    concatenated and ``graph_id`` routes nodes to per-graph readouts.
    """

    node_feat: torch.Tensor  # f32[N, F]
    edge_src: torch.Tensor  # int32[E]
    edge_dst: torch.Tensor  # int32[E]
    edge_feat: torch.Tensor  # f32[E, Fe] (zeros when unused)
    positions: torch.Tensor  # f32[N, 3] (zeros for non-geometric graphs)
    node_mask: torch.Tensor  # f32[N]
    edge_mask: torch.Tensor  # f32[E]
    graph_id: torch.Tensor  # int32[N] (zeros for single graphs)
    n_graphs: int = static_field(default=1)

    @property
    def n_nodes(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_src.shape[0]

    def to(self, device) -> "GraphBatch":
        """The same batch with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "n_graphs"})


def scatter_sum(edge_vals: torch.Tensor, dst: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """Sum edge messages into destination nodes: the SpMM primitive."""
    out = edge_vals.new_zeros((n_nodes, *edge_vals.shape[1:]))
    return out.index_add(0, dst, edge_vals)


def scatter_mean(edge_vals, dst, n_nodes, edge_mask=None):
    w = (torch.ones(edge_vals.shape[0], device=edge_vals.device)
         if edge_mask is None else edge_mask)
    tot = scatter_sum(edge_vals * w[:, None], dst, n_nodes)
    cnt = scatter_sum(w, dst, n_nodes)
    return tot / torch.clamp_min(cnt, 1.0)[:, None]


def scatter_max(edge_vals: torch.Tensor, dst: torch.Tensor,
                n_nodes: int) -> torch.Tensor:
    """Per-node max of the edge values; ``-inf`` for a node no edge reaches,
    as ``jax.ops.segment_max`` gives (the fill takes part in the max)."""
    out = edge_vals.new_full((n_nodes, *edge_vals.shape[1:]), -torch.inf)
    idx = dst.long().view(-1, *([1] * (edge_vals.dim() - 1)))
    return out.scatter_reduce(0, idx.expand_as(edge_vals), edge_vals, "amax",
                              include_self=True)


def _every():
    """(the installed mesh, its axes), or (None, ())."""
    mesh = mesh_ops.current_mesh()
    return (mesh, tuple(mesh.mesh_dim_names)) if mesh is not None else (None, ())


def ranks() -> int:
    """How many ranks split the graph: 1 off a mesh."""
    mesh, every = _every()
    return mesh_ops.axis_size(mesh, every) if mesh is not None else 1


def graph_nodes(g: GraphBatch) -> int:
    """The whole graph's node count (the range of the edges' indices)."""
    return g.n_nodes * ranks()


def first_node(g: GraphBatch) -> int:
    """The whole-graph index of this rank's first node."""
    mesh, every = _every()
    return g.n_nodes * mesh_ops.axis_index(mesh, every) if mesh is not None else 0


def whole(node_vals: torch.Tensor) -> torch.Tensor:
    """A node array of the whole graph from every rank's block."""
    mesh, every = _every()
    return node_vals if mesh is None else mesh_ops.gather(node_vals, every, 0,
                                                          mesh)


def own_block(full: torch.Tensor) -> torch.Tensor:
    """This rank's rows of the sum over the ranks of a whole-graph node
    array (each rank's messages into every node)."""
    mesh, every = _every()
    return full if mesh is None else mesh_ops.psum_scatter(full, every, 0, mesh)


def summed(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks: a per-graph sum, or any array every
    rank holds whole."""
    mesh, every = _every()
    return x if mesh is None else mesh_ops.psum(x, every, mesh)


def node_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a node array over the whole graph; on a mesh this
    rank's share of it (the ranks' shares sum to the mean)."""
    return torch.mean(x) if ranks() == 1 else x.sum() / (x.numel() * ranks())


def share(x: torch.Tensor) -> torch.Tensor:
    """A loss every rank computes whole, as this rank's share of it."""
    return x if ranks() == 1 else x / ranks()


def gather(node_vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``node_vals[idx]`` by ``index_select``: its backward adds the rows
    with ``index_add`` (atomics on the card), where advanced indexing's
    backward sorts the indices first."""
    return node_vals.index_select(0, idx)


def edge_softmax(scores: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                 edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax over incoming edges per destination node. scores: [E, H];
    ``n_nodes`` the range of ``dst``.  On a mesh a node's edges lie on
    every rank: the maxima (a stabiliser, which the softmax's value does
    not depend on) and the sums are taken over the ranks."""
    if edge_mask is not None:
        scores = torch.where(edge_mask[:, None] > 0, scores,
                             scores.new_tensor(-1e30))
    mx = scatter_max(scores, dst, n_nodes)
    mesh, every = _every()
    if mesh is not None:
        mx = mesh_ops.pmax(mx, every, mesh)
    mx = torch.where(torch.isfinite(mx), mx, mx.new_zeros(()))
    ex = torch.exp(scores - gather(mx, dst))
    if edge_mask is not None:
        ex = ex * edge_mask[:, None]
    den = summed(scatter_sum(ex, dst, n_nodes))
    return ex / torch.clamp_min(gather(den, dst), 1e-9)


def graph_readout(node_vals: torch.Tensor, graph_id: torch.Tensor,
                  n_graphs: int, node_mask: torch.Tensor) -> torch.Tensor:
    """Mean-pool nodes per graph -> [G, F]."""
    tot = scatter_sum(node_vals * node_mask[:, None], graph_id, n_graphs)
    cnt = scatter_sum(node_mask, graph_id, n_graphs)
    return tot / torch.clamp_min(cnt, 1.0)[:, None]


# ------------------------------------------------------------ generators --

def synthetic_graph_numpy(n_nodes: int, n_edges: int, d_feat: int, *,
                          seed: int = 0, n_graphs: int = 1) -> dict:
    """The arrays of :func:`synthetic_graph` on the host: the JAX package's
    numpy draws, in its order."""
    rng = np.random.default_rng(seed)
    per_g_nodes = n_nodes
    total_nodes = n_nodes * n_graphs
    total_edges = n_edges * n_graphs
    graph_id = np.repeat(np.arange(n_graphs, dtype=np.int32), per_g_nodes)

    src = np.empty(total_edges, np.int32)
    dst = np.empty(total_edges, np.int32)
    for g in range(n_graphs):
        lo = g * n_edges
        base = g * per_g_nodes
        src[lo : lo + n_edges] = base + rng.integers(0, per_g_nodes, n_edges)
        dst[lo : lo + n_edges] = base + rng.integers(0, per_g_nodes, n_edges)

    positions = rng.normal(size=(total_nodes, 3)).astype(np.float32) * 2.0
    feat = rng.normal(size=(total_nodes, d_feat)).astype(np.float32)
    return {"node_feat": feat, "edge_src": src, "edge_dst": dst,
            "positions": positions, "graph_id": graph_id}


def synthetic_graph(n_nodes: int, n_edges: int, d_feat: int, *,
                    seed: int = 0, n_graphs: int = 1, geometric: bool = False,
                    device="cuda") -> GraphBatch:
    """Deterministic random graph batch matching an assigned GNN shape, on
    ``device``: the same graph as the JAX package's for the same arguments.

    For ``n_graphs > 1`` (molecule shape) nodes/edges are split evenly.
    ``geometric`` is accepted as the JAX package accepts it; positions are
    random in every graph."""
    arrs = synthetic_graph_numpy(n_nodes, n_edges, d_feat, seed=seed,
                                 n_graphs=n_graphs)
    total_nodes, total_edges = n_nodes * n_graphs, n_edges * n_graphs
    f32 = dict(dtype=torch.float32, device=device)
    return GraphBatch(
        node_feat=torch.as_tensor(arrs["node_feat"], device=device),
        edge_src=torch.as_tensor(arrs["edge_src"], device=device),
        edge_dst=torch.as_tensor(arrs["edge_dst"], device=device),
        edge_feat=torch.zeros((total_edges, 8), **f32),
        positions=torch.as_tensor(arrs["positions"], device=device),
        node_mask=torch.ones(total_nodes, **f32),
        edge_mask=torch.ones(total_edges, **f32),
        graph_id=torch.as_tensor(arrs["graph_id"], device=device),
        n_graphs=n_graphs,
    )
