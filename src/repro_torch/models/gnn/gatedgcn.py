"""GatedGCN [arXiv:2003.00982 benchmarking / 1711.07553] — edge-gated MPNN.

The port of ``repro/models/gnn/gatedgcn.py``.  Layer (Bresson & Laurent):
    e'_ij = E1 e_ij + E2 h_i + E3 h_j                       (edge update)
    eta_ij = sigma(e'_ij) / (sum_{j'} sigma(e'_ij') + eps)  (gates)
    h'_i  = A h_i + sum_j eta_ij ⊙ (B h_j)                  (node update)
with LayerNorm->ReLU->residual on both streams.

Parameters keep the JAX tree layout: ``layers`` holds each leaf stacked
over the layers, (n_layers, ...).  Where the JAX package scans over the
stack, the port loops over the layers (each leaf unbound once per
forward); ``remat`` runs each layer under ``torch.utils.checkpoint``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import (dense_init, layer_norm, normal_init,
                                       unstack_layers)
from repro_torch.models.gnn.graph import (GraphBatch, gather, graph_nodes,
                                          own_block, scatter_sum, whole)
from repro_torch.training.optimizer import tree_leaves


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_hidden: int = 70
    d_out: int = 16
    aggregator: str = "gated"
    remat: bool = False


def init_params(cfg: GatedGCNConfig, generator: torch.Generator, d_in: int,
                d_edge_in: int = 8, device="cuda", *,
                requires_grad: bool = True) -> dict:
    """Random parameters in the JAX tree layout on ``device`` (the generator
    lives there too)."""
    d, n = cfg.d_hidden, cfg.n_layers
    f32 = dict(dtype=torch.float32, device=device)
    params = {
        "embed_h": dense_init(generator, d_in, cfg.d_hidden, device=device),
        "embed_e": dense_init(generator, d_edge_in, cfg.d_hidden, device=device),
        "layers": {
            **{k: normal_init(generator, (n, d, d), 1 / math.sqrt(d),
                              device=device)
               for k in ("A", "B", "E1", "E2", "E3")},
            "ln_h_g": torch.ones((n, d), **f32),
            "ln_h_b": torch.zeros((n, d), **f32),
            "ln_e_g": torch.ones((n, d), **f32),
            "ln_e_b": torch.zeros((n, d), **f32),
        },
        "head": dense_init(generator, cfg.d_hidden, cfg.d_out, device=device),
    }
    for leaf in tree_leaves(params):
        leaf.requires_grad_(requires_grad)
    return params


def _layer(cfg: GatedGCNConfig, p: dict, h, e, g: GraphBatch):
    h_all, n = whole(h), graph_nodes(g)
    hi = gather(h_all, g.edge_src)
    hj = gather(h_all, g.edge_dst)
    e_new = e @ p["E1"] + hi @ p["E2"] + hj @ p["E3"]
    gate = torch.sigmoid(e_new) * g.edge_mask[:, None]
    denom = own_block(scatter_sum(gate, g.edge_dst, n)) + 1e-6
    msg = own_block(scatter_sum(gate * (hi @ p["B"]), g.edge_dst, n))
    h_new = h @ p["A"] + msg / denom
    h = h + F.relu(layer_norm(h_new, p["ln_h_g"], p["ln_h_b"]))
    e = e + F.relu(layer_norm(e_new, p["ln_e_g"], p["ln_e_b"]))
    return h, e


def forward(cfg: GatedGCNConfig, params: dict, g: GraphBatch) -> torch.Tensor:
    """Node-level outputs [N, d_out]."""
    h = g.node_feat @ params["embed_h"]
    e = g.edge_feat @ params["embed_e"]
    for lp in unstack_layers(params["layers"], cfg.n_layers):
        args = (cfg, lp, h, e, g)
        h, e = (checkpoint(_layer, *args, use_reentrant=False) if cfg.remat
                else _layer(*args))
    return h @ params["head"]
