"""EquiformerV2 [arXiv:2306.12059] — equivariant graph attention via eSCN.

The port of ``repro/models/gnn/equiformer_v2.py``.  Assigned config: 12
layers, 128 channels, l_max=6, m_max=2, 8 heads.

The eSCN trick: rotating each edge's features into a frame where the edge
is the z-axis makes the SO(3) convolution block-diagonal in m and
truncatable to |m| <= m_max, a handful of dense per-m linear maps (SO(2)
convolutions).  The per-edge rotation is two analytic z-rotations and two
static J-matrix products (so3.py).

Edge flow per layer (attention):
    gather src/dst features -> rotate to edge frame -> truncate to m<=m_max
    -> SO(2) linear (separate W per m, complex-pair structure for m>0)
    -> attention logits from the m=0 (invariant) block -> edge softmax
    -> value messages * alpha -> un-truncate -> rotate back -> sum to dst.

Memory: edges are processed in static chunks (two passes: logits, each
chunk under ``torch.utils.checkpoint``; then messages through
``chunked_edge_aggregate``) so the (E, C, d) tensors never materialize.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import dense_init, normal_init, unstack_layers
from repro_torch.models.gnn.chunked import (chunked_edge_aggregate, gather_rows,
                                            pad_rows)
from repro_torch.models.gnn.graph import (GraphBatch, edge_softmax, gather,
                                          graph_nodes, own_block, scatter_sum,
                                          summed, whole)
from repro_torch.models.gnn.so3 import m_array, n_comps, rotate_to_edge_frame
from repro_torch.training.optimizer import tree_leaves


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    edge_chunk: int = 32_768
    remat: bool = False


@functools.lru_cache(maxsize=None)
def _m_indices(l_max: int, m_max: int):
    """Component slots per |m| <= m_max: (idx_m0, [(idx_+m, idx_-m)] m=1..)."""
    ms = m_array(l_max)
    idx0 = np.nonzero(ms == 0)[0]
    pairs = []
    for m in range(1, m_max + 1):
        plus = np.nonzero(ms == m)[0]
        minus = np.nonzero(ms == -m)[0]
        assert len(plus) == len(minus)
        pairs.append((plus, minus))
    return idx0, pairs


@functools.lru_cache(maxsize=None)
def _m_index_tensors(l_max: int, m_max: int, device: str):
    idx0, pairs = _m_indices(l_max, m_max)
    return (torch.as_tensor(idx0, device=device),
            [(torch.as_tensor(p, device=device),
              torch.as_tensor(m, device=device)) for p, m in pairs])


def _so2_sizes(cfg) -> list[int]:
    idx0, pairs = _m_indices(cfg.l_max, cfg.m_max)
    return [len(idx0)] + [len(p) for p, _ in pairs]


def init_params(cfg: EquiformerV2Config, generator: torch.Generator,
                d_in: int, device="cuda", *,
                requires_grad: bool = True) -> dict:
    """Random parameters in the JAX tree layout on ``device``; ``head_w2``
    starts at zero, as the JAX package's does."""
    d, n = cfg.d_hidden, cfg.n_layers
    sizes = _so2_sizes(cfg)

    def stacked(d_in_, d_out):
        return normal_init(generator, (n, d_in_, d_out), 1 / math.sqrt(d_in_),
                           device=device)

    layers = {
        "alpha_w1": stacked(2 * sizes[0] * d, d),
        "alpha_w2": stacked(d, cfg.n_heads),
        "ffn_w1": stacked(d, 2 * d),
        "ffn_w2": stacked(2 * d, d),
        "ffn_gate": stacked(d, cfg.l_max * d),
        "out_w": stacked(d, d),
    }
    # SO(2) conv weights: m=0 real; m>0 complex pairs. Input is the CONCAT
    # of rotated src+dst features (2d channels) -> d channels.
    for mi, n_l in enumerate(sizes):
        d_in_, d_out = n_l * 2 * d, n_l * d
        if mi == 0:
            layers["so2_m0"] = stacked(d_in_, d_out)
        else:
            layers[f"so2_m{mi}_r"] = stacked(d_in_, d_out)
            layers[f"so2_m{mi}_i"] = stacked(d_in_, d_out)
    params = {
        "embed": dense_init(generator, d_in, d, device=device),
        "layers": layers,
        "head_w1": dense_init(generator, d, d, device=device),
        "head_w2": torch.zeros((d, 1), dtype=torch.float32, device=device),
    }
    for leaf in tree_leaves(params):
        leaf.requires_grad_(requires_grad)
    return params


def _so2_conv(cfg, p, x):
    """SO(2) convolution on edge-frame features x: (E, C, 2d) -> (E, C, d)."""
    e = x.shape[0]
    d = cfg.d_hidden
    idx0, pairs = _m_index_tensors(cfg.l_max, cfg.m_max, str(x.device))
    out = x.new_zeros((e, n_comps(cfg.l_max), d))
    x0 = x.index_select(1, idx0).reshape(e, -1)
    out[:, idx0, :] = (x0 @ p["so2_m0"]).reshape(e, len(idx0), d)
    for mi, (plus, minus) in enumerate(pairs, start=1):
        xp_ = x.index_select(1, plus).reshape(e, -1)
        xm_ = x.index_select(1, minus).reshape(e, -1)
        wr, wi = p[f"so2_m{mi}_r"], p[f"so2_m{mi}_i"]
        out[:, plus, :] = (xp_ @ wr - xm_ @ wi).reshape(e, len(plus), d)
        out[:, minus, :] = (xp_ @ wi + xm_ @ wr).reshape(e, len(plus), d)
    return out


def _equiv_layer_norm(h):
    """Normalize per-l subspace norms (equivariant)."""
    sq = torch.mean(h * h, dim=1, keepdim=True)  # (N, 1, d) — l-mixed RMS
    return h * torch.rsqrt(sq + 1e-6)


def _rotate_mix(cfg, h_, so2_p, s, t, v):
    """Rotated + SO(2)-mixed features of a chunk of edges."""
    x = torch.cat([gather_rows(h_, s), gather_rows(h_, t)], dim=-1)  # (E, C, 2d)
    x = x.transpose(1, 2)  # comps last for the so3 helper
    x = rotate_to_edge_frame(x, v[:, None, :], l_max=cfg.l_max)
    x = x.transpose(1, 2)
    return _so2_conv(cfg, so2_p, x)  # (chunk, C, d)


def _logits_chunk(cfg, p, so2_p, h, s, t, v):
    """Pass 1 of a chunk: attention logits from the invariant m=0 block."""
    idx0, _ = _m_index_tensors(cfg.l_max, cfg.m_max, str(h.device))
    mixed = _rotate_mix(cfg, h, so2_p, s, t, v)
    inv = mixed.index_select(1, idx0).reshape(mixed.shape[0], -1)
    z = F.silu(torch.cat([inv, inv], dim=-1) @ p["alpha_w1"])
    return z @ p["alpha_w2"]  # (chunk, H)


def _attention_layer(cfg, p, h, g: GraphBatch, inv_sqrt_deg):
    n_edges, n_all = g.n_edges, graph_nodes(g)
    d = cfg.d_hidden
    pos = whole(g.positions)
    vec = gather(pos, g.edge_src) - gather(pos, g.edge_dst)
    h_all = whole(h)

    n_chunks = max(n_edges // cfg.edge_chunk, 1)
    chunk = -(-n_edges // n_chunks)
    pad = n_chunks * chunk - n_edges

    src = pad_rows(g.edge_src, pad)
    dst = pad_rows(g.edge_dst, pad)
    vec_p = pad_rows(vec, pad)
    so2_p = {k: v for k, v in p.items() if k.startswith("so2_")}

    # ---- pass 1: attention logits (invariant m=0 block) -------------------
    # each chunk checkpointed: its rotate/mix recomputes in backward, so no
    # chunk's residuals are held
    logits = torch.cat([
        checkpoint(_logits_chunk, cfg, p, so2_p, h_all,
                   src[i * chunk:(i + 1) * chunk],
                   dst[i * chunk:(i + 1) * chunk],
                   vec_p[i * chunk:(i + 1) * chunk], use_reentrant=False)
        for i in range(n_chunks)])[:n_edges]
    alpha = edge_softmax(logits, g.edge_dst, n_all, g.edge_mask)  # (E, H)
    alpha_p = pad_rows(alpha, pad)

    # ---- pass 2: weighted messages via the linear-aggregate Function ------
    def msg_fn(carry, es, ie):
        h_, so2_ = carry
        mixed = _rotate_mix(cfg, h_, so2_, ie["src"], ie["dst"], es["vec"])
        val = mixed.reshape(mixed.shape[0], -1, cfg.n_heads, d // cfg.n_heads)
        val = val * es["alpha"][:, None, :, None]
        val = val.reshape(val.shape[0], n_comps(cfg.l_max), d)
        val = val.transpose(1, 2)
        val = rotate_to_edge_frame(val, es["vec"][:, None, :],
                                   l_max=cfg.l_max, inverse=True)
        return val.transpose(1, 2)

    agg = own_block(chunked_edge_aggregate(
        msg_fn, n_all, n_chunks,
        (h_all, so2_p),
        {"vec": vec_p, "alpha": alpha_p},
        {"src": src, "dst": dst},
        dst,
    ))
    agg = agg * inv_sqrt_deg[:, None, None]

    h = h + agg @ p["out_w"]
    h = _equiv_layer_norm(h)

    # ---- pointwise equivariant FFN ----------------------------------------
    scalars = h[:, 0, :]
    z = F.silu(scalars @ p["ffn_w1"]) @ p["ffn_w2"]
    gates = torch.sigmoid(scalars @ p["ffn_gate"]).reshape(
        -1, cfg.l_max, cfg.d_hidden)
    out = [(h[:, 0, :] + z)[:, None, :]]
    for l in range(1, cfg.l_max + 1):
        out.append(h[:, l * l : (l + 1) * (l + 1), :] * gates[:, l - 1 : l, :])
    return torch.cat(out, 1)


def forward(cfg: EquiformerV2Config, params: dict, g: GraphBatch) -> torch.Tensor:
    """Per-graph energies (n_graphs,) — the OC20-style readout."""
    deg = own_block(scatter_sum(g.edge_mask, g.edge_dst, graph_nodes(g)))
    inv_sqrt_deg = torch.rsqrt(torch.clamp_min(deg, 1.0))
    h0 = g.node_feat @ params["embed"]
    h = torch.cat([h0[:, None, :], h0.new_zeros(
        (g.n_nodes, n_comps(cfg.l_max) - 1, cfg.d_hidden))], 1)

    for lp in unstack_layers(params["layers"], cfg.n_layers):
        args = (cfg, lp, h, g, inv_sqrt_deg)
        h = (checkpoint(_attention_layer, *args, use_reentrant=False)
             if cfg.remat else _attention_layer(*args))
    e_atom = F.silu(h[:, 0, :] @ params["head_w1"]) @ params["head_w2"]
    e_atom = e_atom[:, 0] * g.node_mask
    return summed(scatter_sum(e_atom, g.graph_id, g.n_graphs))
