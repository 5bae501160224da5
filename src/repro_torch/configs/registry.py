"""Architecture registry and cell builders: the FM and GNN parts of
``repro/configs/registry.py``.

A cell is (arch x shape): the step function and its inputs.  The port
builds the FM's train, serve and retrieval cells and the GNNs' train cells
on one card.  The JAX package's LM cells, ``build_cell`` / ``all_cells``
and its shardings come with the shardings slice (ROADMAP.md, §A, 16c);
its mesh is ``repro_torch.launch.mesh``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.shapes import (
    GNN_SHAPES,
    RECSYS_SHAPES,
    GNNShape,
    sampled_subgraph_sizes,
)
from repro_torch.models.recsys import fm as fm_mod
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.steps import fm_loss_fn

# the JAX package's FM train cell (repro/configs/registry.py build_fm_cell)
FM_TRAIN_OPT = AdamWConfig(lr_peak=1e-3, warmup_steps=100, total_steps=5000)


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str  # "gnn" | "recsys" (the LM cells come with 16c)
    config: Any
    shape_names: tuple[str, ...]


def _gnn_configs():
    from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config
    from repro_torch.models.gnn.gatedgcn import GatedGCNConfig
    from repro_torch.models.gnn.graphcast import GraphCastConfig
    from repro_torch.models.gnn.nequip import NequIPConfig

    return {
        "graphcast": GraphCastConfig(n_layers=16, d_hidden=512, n_vars=227,
                                     remat=True, latent_dtype="bfloat16"),
        "gatedgcn": GatedGCNConfig(n_layers=16, d_hidden=70, d_out=64, remat=True),
        "equiformer-v2": EquiformerV2Config(
            n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8, remat=True
        ),
        "nequip": NequIPConfig(
            n_layers=5, d_hidden=32, l_max=2, n_rbf=8, cutoff=5.0, remat=True
        ),
    }


def _fm_config() -> fm_mod.FMConfig:
    return fm_mod.FMConfig(n_fields=39, embed_dim=10, total_vocab=10_000_000)


@functools.lru_cache(maxsize=1)
def archs() -> dict[str, Arch]:
    out = {name: Arch(name, "gnn", cfg, tuple(GNN_SHAPES))
           for name, cfg in _gnn_configs().items()}
    out["fm"] = Arch("fm", "recsys", _fm_config(), tuple(RECSYS_SHAPES))
    return out


@dataclasses.dataclass
class Cell:
    """One (arch, shape) on one device: ``run()`` is
    ``step_fn(params, *inputs)``, which scores ``rows`` rows (the batch,
    or the candidates of a retrieval).  A train cell's ``params`` is a
    ``TrainState``: ``run()`` takes one step, keeps the new state and
    returns the step's metrics."""

    arch: str
    shape: str
    step_fn: Callable
    params: Any
    inputs: tuple
    rows: int
    train: bool = False

    def run(self):
        out = self.step_fn(self.params, *self.inputs)
        if not self.train:
            return out
        self.params, metrics = out
        return metrics


def build_fm_cell(shape_name: str, params, rng: np.random.Generator,
                  device="cuda") -> Cell:
    """The FM cell ``shape_name`` over ``params`` (an ``FM`` on ``device``).

    Ids are uniform in [0, 2^30) from the numpy generator ``rng``, made on
    the host and copied to ``device``, so the same seed gives the same ids
    on any device.  The train kind: labels in {0, 1} from the same
    generator, after the ids; ``params`` must require grad, and the cell
    holds a fresh ``TrainState`` over them (AdamW as the JAX package's FM
    train cell sets it, ``FM_TRAIN_OPT``).
    """
    if shape_name not in RECSYS_SHAPES:
        raise ValueError(f"fm has no shape {shape_name!r} "
                         f"(one of {sorted(RECSYS_SHAPES)})")
    shape = RECSYS_SHAPES[shape_name]
    device = torch.device(device)
    if params.emb.device.type != device.type:
        raise ValueError(f"params are on {params.emb.device}, not {device}")
    cfg = params.cfg

    def ids(*shape_):
        arr = rng.integers(0, 1 << 30, shape_, dtype=np.int32)
        return torch.as_tensor(arr).to(device)

    if shape.kind == "train":
        if not all(p.requires_grad for p in params.parameters()):
            raise ValueError("fm train_batch trains its params: make them "
                             "with requires_grad=True")
        batch = {"ids": ids(shape.batch, cfg.n_fields)}
        labels = rng.integers(0, 2, shape.batch).astype(np.float32)
        batch["labels"] = torch.as_tensor(labels).to(device)
        return Cell("fm", shape_name,
                    make_train_step(fm_loss_fn(cfg), FM_TRAIN_OPT),
                    init_train_state(params, FM_TRAIN_OPT), (batch,),
                    shape.batch, train=True)

    if shape.kind == "serve":
        def step(p, ids_):
            return fm_mod.forward(cfg, p, ids_)

        return Cell("fm", shape_name, step, params,
                    (ids(shape.batch, cfg.n_fields),), shape.batch)

    # retrieval: 1 query x n_candidates
    def step(p, q_, cands_):
        return fm_mod.retrieval_scores(cfg, p, q_, cands_)

    return Cell("fm", shape_name, step, params,
                (ids(cfg.n_fields), ids(shape.n_candidates, cfg.n_fields)),
                shape.n_candidates)


# ------------------------------------------------------------- GNN cells --

def gnn_module(arch_name: str):
    """The model module of the GNN ``arch_name``."""
    from repro_torch.models.gnn import equiformer_v2, gatedgcn, graphcast, nequip

    return {"gatedgcn": gatedgcn, "graphcast": graphcast, "nequip": nequip,
            "equiformer-v2": equiformer_v2}[arch_name]


def gnn_d_in(arch_name: str, cfg, shape: GNNShape) -> int:
    """Node feature width of ``arch_name`` at ``shape``: GraphCast's grid
    nodes carry ``n_vars`` features, every other model the shape's."""
    return cfg.n_vars if arch_name == "graphcast" else shape.d_feat


def init_gnn_params(arch_name: str, cfg, generator: torch.Generator,
                    d_in: int, device="cuda", *,
                    requires_grad: bool = True) -> dict:
    """Random parameters of the GNN ``arch_name`` (config ``cfg``) in the
    JAX tree layout on ``device``; GraphCast ignores ``d_in``."""
    module = gnn_module(arch_name)
    if arch_name == "graphcast":
        return module.init_params(cfg, generator, device,
                                  requires_grad=requires_grad)
    return module.init_params(cfg, generator, d_in, device=device,
                              requires_grad=requires_grad)


@torch.no_grad()
def perturb_constant_leaves(params, generator: torch.Generator) -> None:
    """Add N(0, 0.1^2) noise, in place, to every leaf whose entries are
    all equal: the biases, LayerNorm gains and offsets and zero energy
    heads that the JAX init sets to constants.  A trained state has none;
    at the init, GraphCast's padding rows meet LayerNorm with exactly-zero
    inputs (zero features, zero biases), and the first AdamW step moves
    their predictions from 0 to O(1), so its unmasked MSE (the JAX cell's
    loss) rises once by about the padding's share of the rows."""
    for leaf in tree_leaves(params):
        flat = leaf.reshape(-1)
        if bool((flat == flat[0]).all()):
            leaf.add_(0.1 * torch.randn(leaf.shape, generator=generator,
                                          device=leaf.device))


def gnn_loss_fn(arch_name: str, cfg):
    """The JAX package's ``_gnn_forward_and_loss``: node classification for
    GatedGCN, next-state MSE for GraphCast, energy MSE for NequIP and
    EquiformerV2."""
    from repro_torch.training import steps as tsteps

    module = gnn_module(arch_name)
    if arch_name == "gatedgcn":
        return tsteps.gnn_node_class_loss_fn(cfg, module.forward, cfg.d_out)
    if arch_name == "graphcast":
        def loss_fn(params, batch):
            pred = module.forward(cfg, params, batch["graph"])
            loss = torch.mean((pred - batch["target"]) ** 2)
            return loss, {"mse": loss}
        return loss_fn
    if arch_name == "nequip":
        def loss_fn(params, batch):
            g = batch["graph"]
            e = module.energy(cfg, params, g, g.positions)
            loss = torch.mean((e - batch["energy"]) ** 2)
            return loss, {"e_mse": loss}
        return loss_fn
    if arch_name == "equiformer-v2":
        def loss_fn(params, batch):
            e = module.forward(cfg, params, batch["graph"])
            loss = torch.mean((e - batch["energy"]) ** 2)
            return loss, {"e_mse": loss}
        return loss_fn
    raise KeyError(arch_name)


def _pad512(n: int) -> int:
    return -(-n // 512) * 512


def gnn_graph_numpy(shape: GNNShape, d_feat: int,
                    rng: np.random.Generator) -> dict:
    """The graph of a GNN cell on the host, padded as the JAX package's
    ``_gnn_graph_shape`` pads it: nodes and edges to multiples of 512,
    padding edges at node 0, padding rows masked out.

    ``full`` and ``batched`` shapes: ``synthetic_graph``'s arrays (seed
    drawn from ``rng``).  ``sampled``: a ``random_regular_csr`` of the
    shape's nodes and average degree, ``batch_nodes`` distinct seeds drawn
    from ``rng``, ``sample_subgraph`` with the shape's fanout, and features
    and positions from per-node tables of the whole graph, gathered by the
    sampled slots' global ids."""
    from repro_torch.models.gnn import sampler
    from repro_torch.models.gnn.graph import synthetic_graph_numpy

    seed = int(rng.integers(0, 2**31 - 1))
    if shape.kind == "sampled":
        csr = sampler.random_regular_csr(
            shape.n_nodes, round(shape.n_edges / shape.n_nodes), seed=seed)
        seeds = rng.choice(shape.n_nodes, shape.batch_nodes, replace=False)
        nodes, src, dst, emask = sampler.sample_subgraph(
            csr, seeds, shape.fanout, seed=int(rng.integers(0, 2**31 - 1)))
        del csr
        feat = rng.standard_normal((shape.n_nodes, d_feat), dtype=np.float32)
        pos = rng.normal(size=(shape.n_nodes, 3)).astype(np.float32) * 2.0
        arrs = {"node_feat": feat[nodes], "positions": pos[nodes],
                "edge_src": src, "edge_dst": dst, "edge_mask": emask,
                "graph_id": np.zeros(len(nodes), np.int32)}
        n_graphs = 1
        assert (len(nodes), len(src)) == sampled_subgraph_sizes(shape)
    else:
        n_graphs = shape.batch_graphs if shape.kind == "batched" else 1
        arrs = synthetic_graph_numpy(shape.n_nodes, shape.n_edges, d_feat,
                                     seed=seed, n_graphs=n_graphs)
        arrs["edge_mask"] = np.ones(len(arrs["edge_src"]), np.float32)
    n, e = len(arrs["node_feat"]), len(arrs["edge_src"])
    n_pad, e_pad = _pad512(n) - n, _pad512(e) - e

    def pad(x, k):
        return np.concatenate([x, np.zeros((k, *x.shape[1:]), x.dtype)])

    return {
        "node_feat": pad(arrs["node_feat"], n_pad),
        "edge_src": pad(arrs["edge_src"].astype(np.int32), e_pad),
        "edge_dst": pad(arrs["edge_dst"].astype(np.int32), e_pad),
        "positions": pad(arrs["positions"], n_pad),
        "node_mask": pad(np.ones(n, np.float32), n_pad),
        "edge_mask": pad(arrs["edge_mask"], e_pad),
        "graph_id": pad(arrs["graph_id"].astype(np.int32), n_pad),
        "n_graphs": n_graphs,
    }


def gnn_batch(arch_name: str, shape: GNNShape, rng: np.random.Generator,
              device="cuda", *, cfg=None) -> dict:
    """A GNN cell's batch on ``device``: the graph (``gnn_graph_numpy``),
    then from the same generator, for the real nodes (padding rows hold
    zeros, as in every per-node array), the labels (GatedGCN: classes in
    [0, d_out)) or the next state (GraphCast: normal, (N, n_vars)); or the
    energies (NequIP, EquiformerV2): extensive, each graph's the sum of
    per-atom normal draws.  ``cfg``: the registry's by default."""
    from repro_torch.models.gnn.graph import GraphBatch

    cfg = cfg or archs()[arch_name].config
    arrs = gnn_graph_numpy(shape, gnn_d_in(arch_name, cfg, shape), rng)
    n, e = len(arrs["node_feat"]), len(arrs["edge_src"])

    def put(x):
        return torch.as_tensor(x).to(device)

    g = GraphBatch(
        node_feat=put(arrs["node_feat"]), edge_src=put(arrs["edge_src"]),
        edge_dst=put(arrs["edge_dst"]),
        edge_feat=torch.zeros((e, 8), dtype=torch.float32, device=device),
        positions=put(arrs["positions"]), node_mask=put(arrs["node_mask"]),
        edge_mask=put(arrs["edge_mask"]), graph_id=put(arrs["graph_id"]),
        n_graphs=arrs["n_graphs"])
    del arrs
    real = g.node_mask.cpu().numpy() > 0
    batch = {"graph": g}
    if arch_name == "gatedgcn":
        labels = np.zeros(n, np.int32)
        labels[real] = rng.integers(0, cfg.d_out, int(real.sum()))
        batch["labels"] = put(labels)
    elif arch_name == "graphcast":
        target = np.zeros((n, cfg.n_vars), np.float32)
        target[real] = rng.normal(size=(int(real.sum()), cfg.n_vars))
        batch["target"] = put(target)
    else:
        per_atom = rng.normal(size=int(real.sum()))
        gid = g.graph_id.cpu().numpy()[real]
        batch["energy"] = put(np.bincount(gid, per_atom, g.n_graphs)
                              .astype(np.float32))
    return batch


def build_gnn_cell(arch_name: str, shape_name: str, params, rng:
                   np.random.Generator, device="cuda", *, cfg=None) -> Cell:
    """The train cell of the GNN ``arch_name`` at ``shape_name`` over
    ``params`` (on ``device``, requiring grad): a fresh ``TrainState`` with
    AdamW as the JAX package's GNN cells set it (``FM_TRAIN_OPT``: lr 1e-3,
    100 warm-up steps of 5,000), the batch from the numpy generator
    ``rng`` (``gnn_batch``), and the loss of ``gnn_loss_fn``; ``run()``
    takes one step.  ``cfg`` replaces the registry's full config (a cut
    depth, a reduced width)."""
    gnns = sorted(n for n, a in archs().items() if a.family == "gnn")
    if arch_name not in gnns:
        raise ValueError(f"{arch_name!r} is not a GNN (one of {gnns})")
    if shape_name not in GNN_SHAPES:
        raise ValueError(f"{arch_name} has no shape {shape_name!r} "
                         f"(one of {sorted(GNN_SHAPES)})")
    cfg = cfg or archs()[arch_name].config
    device = torch.device(device)
    leaves = tree_leaves(params)
    if leaves[0].device.type != device.type:
        raise ValueError(f"params are on {leaves[0].device}, not {device}")
    if not all(p.requires_grad for p in leaves):
        raise ValueError(f"{arch_name} {shape_name} trains its params: make "
                         "them with requires_grad=True")
    batch = gnn_batch(arch_name, GNN_SHAPES[shape_name], rng, device, cfg=cfg)
    return Cell(arch_name, shape_name,
                make_train_step(gnn_loss_fn(arch_name, cfg), FM_TRAIN_OPT),
                init_train_state(params, FM_TRAIN_OPT), (batch,),
                batch["graph"].n_nodes, train=True)
