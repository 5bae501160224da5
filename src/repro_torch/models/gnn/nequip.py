"""NequIP [arXiv:2101.03164] — E(3)-equivariant interatomic potential.

The port of ``repro/models/gnn/nequip.py``.  Assigned config: 5 layers,
32 channels, l_max=2, 8 Bessel RBFs, cutoff 5 A.

Features are (N, C_irr, d) with C_irr = (l_max+1)^2 SH-indexed components and
d channels.  An interaction layer computes, per edge (j -> i):

    m_ij[l3] = sum_paths  R_path(|r|) * G_{l1 l2 l3} ( h_j[l1] (x) Y_{l2}(r^) )

with learned radial MLPs R on a Bessel basis under a smooth polynomial
cutoff, followed by per-l self-interactions and gated nonlinearities.
Energy = sum_atoms MLP(h[l=0]); forces = -dE/dpositions by autograd.

The messages stream through ``chunked_edge_aggregate``.  Where the JAX
package adds one einsum per path, the port contracts every path at once
(the same sum in another order): the Gaunt couplings of all paths form
one static (C, C*C*P) matrix, so a chunk is a handful of large kernels.
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
from repro_torch.models.gnn.chunked import (aggregate_unchunked,
                                            chunked_edge_aggregate,
                                            gather_rows, pad_rows)
from repro_torch.models.gnn.graph import (GraphBatch, gather, graph_nodes,
                                          own_block, scatter_sum, summed, whole)
from repro_torch.models.gnn.so3 import gaunt_tensor, n_comps, real_sph_harm
from repro_torch.training.optimizer import tree_leaves


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    edge_chunk: int = 65_536
    remat: bool = False


@functools.lru_cache(maxsize=None)
def _paths(l_max: int) -> tuple:
    """All (l1, l2, l3) with non-vanishing Gaunt coupling, l* <= l_max."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                g = gaunt_tensor(l1, l2, l3)
                if np.abs(g).max() > 1e-10:
                    out.append((l1, l2, l3))
    return tuple(out)


def _sl(l: int) -> slice:
    return slice(l * l, (l + 1) * (l + 1))


@functools.lru_cache(maxsize=None)
def _coupling(l_max: int, dtype: torch.dtype, device: str) -> torch.Tensor:
    """Every path's Gaunt block at its slots: G[b, (a, c, p)], shape
    (C, C * C * P), for W = y @ G, W[e, a, c, p] = sum_b G_p[a, b, c] y_b."""
    c = n_comps(l_max)
    paths = _paths(l_max)
    full = np.zeros((c, c, c, len(paths)))  # (b, a, c, p)
    for pi, (l1, l2, l3) in enumerate(paths):
        full[_sl(l2), _sl(l1), _sl(l3), pi] = np.transpose(
            gaunt_tensor(l1, l2, l3), (1, 0, 2))
    return torch.as_tensor(full.reshape(c, -1), dtype=dtype, device=device)


def bessel_rbf(r: torch.Tensor, n: int, cutoff: float) -> torch.Tensor:
    """Bessel radial basis with smooth polynomial cutoff envelope."""
    r = torch.clamp_min(r, 1e-6)
    k = torch.arange(1, n + 1, dtype=torch.float32, device=r.device)
    basis = (math.sqrt(2.0 / cutoff)
             * torch.sin(k * math.pi * r[..., None] / cutoff) / r[..., None])
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1.0 - 10.0 * x**3 + 15.0 * x**4 - 6.0 * x**5  # p=2 poly cutoff
    return basis * env[..., None]


def init_params(cfg: NequIPConfig, generator: torch.Generator, d_in: int,
                device="cuda", *, requires_grad: bool = True) -> dict:
    """Random parameters in the JAX tree layout on ``device``; ``head_w2``
    starts at zero, as the JAX package's does."""
    d, n = cfg.d_hidden, cfg.n_layers
    n_paths = len(_paths(cfg.l_max))
    n_l = cfg.l_max + 1

    def stacked(lead, d_in_, d_out):
        return normal_init(generator, (*lead, d_in_, d_out),
                           1 / math.sqrt(d_in_), device=device)

    params = {
        "embed": dense_init(generator, d_in, d, device=device),
        "layers": {
            # radial MLP -> one weight per (path, channel)
            "rad_w1": stacked((n,), cfg.n_rbf, 64),
            "rad_w2": stacked((n,), 64, n_paths * d),
            # per-l self interactions (channel mixing)
            "self_w": stacked((n, n_l), d, d),
            "msg_w": stacked((n, n_l), d, d),
            # gates for l > 0 from scalar channels
            "gate_w": stacked((n,), d, (n_l - 1) * d),
        },
        "head_w1": dense_init(generator, d, d, device=device),
        "head_w2": torch.zeros((d, 1), dtype=torch.float32, device=device),
    }
    for leaf in tree_leaves(params):
        leaf.requires_grad_(requires_grad)
    return params


def _message_fn(cfg: NequIPConfig):
    """The chunk's messages: the radial MLP, the gather of source features
    and every path's coupling, masked."""
    n_paths = len(_paths(cfg.l_max))
    c, d = n_comps(cfg.l_max), cfg.d_hidden

    def msg_fn(carry, es, ie):
        h_, w1, w2 = carry
        rad = (F.silu(es["rbf"] @ w1) @ w2).reshape(-1, n_paths, d)
        h_src = gather_rows(h_, ie["src"])  # (chunk, C, d)
        gmat = _coupling(cfg.l_max, h_.dtype, str(h_.device))
        w = (es["y"] @ gmat).reshape(-1, c * c, n_paths)  # (chunk, (a,c), P)
        k = torch.bmm(w, rad).reshape(-1, c, c, d)  # (chunk, a, c, d)
        msg = (k * h_src[:, :, None, :]).sum(1)
        return msg * es["mask"][:, None, None]

    return msg_fn


def _interaction(cfg: NequIPConfig, p: dict, h, g: GraphBatch, y_edge, rbf,
                 chunked: bool = True):
    """One message-passing layer. h: (N, C, d).

    Edge messages stream through ``chunked_edge_aggregate``: radial MLP,
    couplings and gathers all live inside the chunk function, so nothing
    E-sized beyond the (E, C_sh) SH values and (E, n_rbf) basis ever
    materializes, in either direction.  ``chunked=False`` aggregates every
    message at once (the plain version, for comparisons).
    """
    n_edges = g.n_edges
    n_chunks = max(n_edges // cfg.edge_chunk, 1)
    chunk = -(-n_edges // n_chunks)
    pad = n_chunks * chunk - n_edges
    src = pad_rows(g.edge_src, pad)
    dst = pad_rows(g.edge_dst, pad)
    edges = {"y": pad_rows(y_edge, pad), "rbf": pad_rows(rbf, pad),
             "mask": pad_rows(g.edge_mask, pad)}
    carry = (whole(h), p["rad_w1"], p["rad_w2"])
    if chunked:
        agg = chunked_edge_aggregate(_message_fn(cfg), graph_nodes(g), n_chunks,
                                     carry, edges, {"src": src}, dst)
    else:
        agg = aggregate_unchunked(_message_fn(cfg), graph_nodes(g), carry,
                                  edges, {"src": src}, dst)
    agg = own_block(agg)

    # self-interaction + message mix per l, then gated nonlinearity
    mixed = [h[:, _sl(l), :] @ p["self_w"][l] + agg[:, _sl(l), :] @ p["msg_w"][l]
             for l in range(cfg.l_max + 1)]
    scalars = mixed[0][:, 0, :]
    gates = torch.sigmoid(scalars @ p["gate_w"]).reshape(
        -1, cfg.l_max, cfg.d_hidden)
    out = [F.silu(scalars)[:, None, :]] + [
        mixed[l] * gates[:, l - 1 : l, :] for l in range(1, cfg.l_max + 1)]
    return h + torch.cat(out, 1)  # residual


def energy(cfg: NequIPConfig, params: dict, g: GraphBatch,
           positions: torch.Tensor, *, chunked: bool = True) -> torch.Tensor:
    """Total energy per graph: (n_graphs,). Differentiable in positions."""
    pos = whole(positions)
    return energy_from_edges(cfg, params, g,
                             gather(pos, g.edge_src) - gather(pos, g.edge_dst),
                             chunked=chunked)


def energy_from_edges(cfg: NequIPConfig, params: dict, g: GraphBatch,
                      vec: torch.Tensor, *, chunked: bool = True) -> torch.Tensor:
    """:func:`energy` from the edge vectors ``positions[src] - positions[dst]``.
    A self-loop's vector is exactly 0, and its direction ``vec / 1e-9``
    carries gradients 1e9 times its messages'; they cancel in its atom's
    force, up to their rounding."""
    dist = torch.linalg.norm(vec + 1e-12, dim=-1)
    vhat = vec / torch.clamp_min(dist[:, None], 1e-9)
    y_edge = real_sph_harm(vhat, cfg.l_max)  # (E, C)
    rbf = bessel_rbf(dist, cfg.n_rbf, cfg.cutoff)

    h0 = g.node_feat @ params["embed"]  # (N, d) scalars
    h = torch.cat([h0[:, None, :], h0.new_zeros(
        (g.n_nodes, n_comps(cfg.l_max) - 1, cfg.d_hidden))], 1)

    for lp in unstack_layers(params["layers"], cfg.n_layers):
        args = (cfg, lp, h, g, y_edge, rbf, chunked)
        h = (checkpoint(_interaction, *args, use_reentrant=False)
             if cfg.remat else _interaction(*args))

    e_atom = F.silu(h[:, 0, :] @ params["head_w1"]) @ params["head_w2"]
    e_atom = e_atom[:, 0] * g.node_mask
    return summed(scatter_sum(e_atom, g.graph_id, g.n_graphs))


def energy_and_forces(cfg: NequIPConfig, params: dict, g: GraphBatch):
    """(energies, forces = -dE/dpositions).  When autograd records the
    caller (a force loss), the forces keep their graph, so a loss on them
    differentiates through the gradient."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        pos = g.positions.detach().requires_grad_(True)
        e = energy(cfg, params, g, pos)
        (d_pos,) = torch.autograd.grad(e.sum(), pos, create_graph=create)
    if not create:
        e = e.detach()
    return e, -d_pos
