"""GraphCast-style encode-process-decode mesh GNN [arXiv:2212.12794].

The port of ``repro/models/gnn/graphcast.py``.  Given any (n_nodes,
n_edges) graph:
  * grid nodes  = the given nodes (n_vars=227 features each),
  * mesh nodes  = every ``mesh_ratio``-th node (multimesh stand-in whose
    edge set is the given edge set contracted onto mesh nodes; refinement
    level 6 sets mesh_ratio = 4),
  * grid2mesh / mesh2grid edges = each grid node <-> its mesh anchor.
All three stages are InteractionNetwork blocks (edge MLP + node MLP with
residuals, sum aggregation), d_hidden=512, 16 processor layers.

Latents are ``latent_dtype`` (the full config's bfloat16): weights are
cast to it at use, LayerNorm runs in float32, and the sums into nodes add
in the latent dtype, rounding at every add as XLA's scatter does (on the
card in another order).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import layer_norm, normal_init, unstack_layers
from repro_torch.models.gnn.graph import (GraphBatch, first_node, gather,
                                          graph_nodes, scatter_sum, summed)
from repro_torch.training.optimizer import tree_leaves


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16  # processor depth
    d_hidden: int = 512
    n_vars: int = 227
    mesh_ratio: int = 4  # grid nodes per mesh node (refinement-6 stand-in)
    remat: bool = False
    # latent dtype: bf16 halves the (E, d_hidden) edge latents; params f32.
    latent_dtype: str = "float32"


def _mlp_init(generator, d_in, d_hidden, d_out, device, lead=()):
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w1": normal_init(generator, (*lead, d_in, d_hidden),
                          1 / math.sqrt(d_in), device=device),
        "b1": torch.zeros((*lead, d_hidden), **f32),
        "w2": normal_init(generator, (*lead, d_hidden, d_out),
                          1 / math.sqrt(d_hidden), device=device),
        "b2": torch.zeros((*lead, d_out), **f32),
        "ln_g": torch.ones((*lead, d_out), **f32),
        "ln_b": torch.zeros((*lead, d_out), **f32),
    }


def _mlp(p, x):
    dt = x.dtype
    h = F.silu(x @ p["w1"].to(dt) + p["b1"].to(dt))
    h = h @ p["w2"].to(dt) + p["b2"].to(dt)
    return layer_norm(h, p["ln_g"], p["ln_b"])


def _interaction_init(generator, d, device, lead=()):
    return {
        # [e, h_src, h_dst]
        "edge": _mlp_init(generator, 3 * d, d, d, device, lead),
        "node": _mlp_init(generator, 2 * d, d, d, device, lead),  # [h, agg]
    }


def _interaction(p, h_src_nodes, h_dst_nodes, e, src, dst, n_dst, edge_mask,
                 reduce=None):
    """``reduce``: how the destinations' sums meet over the ranks (``summed``
    for the mesh nodes, which every rank holds whole; None where each rank
    holds its own destinations)."""
    m = edge_mask[:, None].to(e.dtype)  # keep the latent dtype
    ein = torch.cat([e, gather(h_src_nodes, src), gather(h_dst_nodes, dst)],
                    dim=-1)
    e_new = e + _mlp(p["edge"], ein) * m
    agg = scatter_sum(e_new * m, dst, n_dst)
    if reduce is not None:
        agg = reduce(agg)
    h_new = h_dst_nodes + _mlp(p["node"], torch.cat([h_dst_nodes, agg], -1))
    return h_new, e_new


def init_params(cfg: GraphCastConfig, generator: torch.Generator,
                device="cuda", *, requires_grad: bool = True) -> dict:
    """Random parameters in the JAX tree layout on ``device``."""
    d = cfg.d_hidden
    params = {
        "embed_grid": _mlp_init(generator, cfg.n_vars, d, d, device),
        "embed_mesh": _mlp_init(generator, cfg.n_vars, d, d, device),
        "embed_edge": _mlp_init(generator, 4, d, d, device),  # [dist feats]
        "g2m": _interaction_init(generator, d, device),
        "processor": _interaction_init(generator, d, device, (cfg.n_layers,)),
        "m2g": _interaction_init(generator, d, device),
        "head": _mlp_init(generator, d, d, cfg.n_vars, device),
    }
    for leaf in tree_leaves(params):
        leaf.requires_grad_(requires_grad)
    return params


def _mesh_topology(cfg: GraphCastConfig, g: GraphBatch):
    """Deterministic mesh derivation from a generic graph (see module doc).
    On a mesh of ranks the grid is split and the mesh nodes are whole on
    every rank: ``anchor`` is this rank's grid nodes'."""
    n_mesh = max(graph_nodes(g) // cfg.mesh_ratio, 1)
    anchor = ((first_node(g) + torch.arange(g.n_nodes, dtype=torch.int32,
                                            device=g.edge_src.device))
              // cfg.mesh_ratio) % n_mesh
    mesh_src = (g.edge_src // cfg.mesh_ratio) % n_mesh
    mesh_dst = (g.edge_dst // cfg.mesh_ratio) % n_mesh
    return n_mesh, anchor, mesh_src, mesh_dst


def forward(cfg: GraphCastConfig, params: dict, g: GraphBatch) -> torch.Tensor:
    """Next-state prediction for every grid node: [N, n_vars]."""
    n_mesh, anchor, mesh_src, mesh_dst = _mesh_topology(cfg, g)
    d = cfg.d_hidden
    lat = getattr(torch, cfg.latent_dtype)
    dev = g.node_feat.device

    h_grid = _mlp(params["embed_grid"], g.node_feat.to(lat))
    # mesh initial state: mean of anchored grid nodes (cheap pre-encoder)
    cnt = torch.clamp_min(summed(scatter_sum(g.node_mask, anchor, n_mesh)),
                          1.0)
    mesh_feat = (summed(scatter_sum(g.node_feat * g.node_mask[:, None], anchor,
                                    n_mesh)) / cnt[:, None])
    h_mesh = _mlp(params["embed_mesh"], mesh_feat.to(lat))

    # grid2mesh: one edge per grid node to its anchor.
    grid_ids = torch.arange(g.n_nodes, dtype=torch.int32, device=dev)
    g2m_e = torch.zeros((g.n_nodes, d), dtype=lat, device=dev)
    h_mesh, _ = _interaction(params["g2m"], h_grid, h_mesh, g2m_e, grid_ids,
                             anchor, n_mesh, g.node_mask, summed)

    # processor on the contracted mesh graph
    e_mesh = torch.zeros((g.n_edges, d), dtype=lat, device=dev)
    for lp in _unstack_processor(params["processor"], cfg.n_layers):
        args = (lp, h_mesh, h_mesh, e_mesh, mesh_src, mesh_dst, n_mesh,
                g.edge_mask, summed)
        h_mesh, e_mesh = (checkpoint(_interaction, *args, use_reentrant=False)
                          if cfg.remat else _interaction(*args))

    # mesh2grid
    m2g_e = torch.zeros((g.n_nodes, d), dtype=lat, device=dev)
    h_grid, _ = _interaction(params["m2g"], h_mesh, h_grid, m2g_e, anchor,
                             grid_ids, g.n_nodes, g.node_mask)
    return _mlp(params["head"], h_grid).float()


def _unstack_processor(proc: dict, n_layers: int) -> list[dict]:
    """Each processor layer's ``{"edge": mlp, "node": mlp}`` from the
    stacked leaves."""
    edge = unstack_layers(proc["edge"], n_layers)
    node = unstack_layers(proc["node"], n_layers)
    return [{"edge": e, "node": n} for e, n in zip(edge, node)]
