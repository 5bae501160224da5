"""Architecture registry and cell builders: the port of
``repro/configs/registry.py``.

A cell is (arch x shape): the step function and its inputs.  Two kinds:

  * ``Cell``, one card: the FM's train, serve and retrieval cells
    (``build_fm_cell``) and the GNNs' train cells (``build_gnn_cell``),
    over real tensors; ``run()`` takes a step.
  * ``MeshCell``, one rank of a mesh: what the JAX package's ``Cell``
    holds for its dry run, for every cell of ``all_cells()``
    (``build_cell``: the LM cells of ``build_lm_cell`` and the mesh forms
    of the GNN and FM cells).  Its step runs on one rank's blocks of the
    arguments (``launch/shardings.py``); its global argument shapes and
    specs give every rank's blocks.

Cells = (arch x applicable shape).  Skips, as in the JAX package: the
pure-global-attention archs (internlm2-20b, grok-1-314b) take no
long_500k.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import lm as lm_configs
from repro_torch.configs.shapes import (
    GNN_SHAPES,
    LM_SHAPES,
    RECSYS_SHAPES,
    GNNShape,
    sampled_subgraph_sizes,
)
from repro_torch.distributed import mesh_ops
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import dp_axes
from repro_torch.launch.shardings import P, ShapeDtype
from repro_torch.models.recsys import fm as fm_mod
from repro_torch.training import AdamWConfig, init_train_state, make_train_step
from repro_torch.training.optimizer import AdamWState, tree_leaves
from repro_torch.training.steps import (
    TrainState,
    fm_loss_fn,
    make_mesh_train_step,
)

# the JAX package's FM train cell (repro/configs/registry.py build_fm_cell)
FM_TRAIN_OPT = AdamWConfig(lr_peak=1e-3, warmup_steps=100, total_steps=5000)


@dataclasses.dataclass(frozen=True)
class Arch:
    name: str
    family: str  # "lm" | "gnn" | "recsys"
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
    lm_shapes_full = tuple(LM_SHAPES)
    lm_shapes_fullattn = ("train_4k", "prefill_32k", "decode_32k")  # no 500k
    out: dict[str, Arch] = {}
    for name, cfg in lm_configs.LM_CONFIGS.items():
        shapes = lm_shapes_fullattn if cfg.is_pure_global else lm_shapes_full
        out[name] = Arch(name, "lm", cfg, shapes)
    for name, cfg in _gnn_configs().items():
        out[name] = Arch(name, "gnn", cfg, tuple(GNN_SHAPES))
    out["fm"] = Arch("fm", "recsys", _fm_config(), tuple(RECSYS_SHAPES))
    return out


def all_cells() -> list[tuple[str, str]]:
    return [(a.name, s) for a in archs().values() for s in a.shape_names]


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
    EquiformerV2.  On a mesh (a split graph, ``models/gnn/graph.py``) each
    returns this rank's share of the loss."""
    from repro_torch.models.gnn.graph import node_mean, share
    from repro_torch.training import steps as tsteps

    module = gnn_module(arch_name)
    if arch_name == "gatedgcn":
        return tsteps.gnn_node_class_loss_fn(cfg, module.forward, cfg.d_out)
    if arch_name == "graphcast":
        def loss_fn(params, batch):
            pred = module.forward(cfg, params, batch["graph"])
            loss = node_mean((pred - batch["target"]) ** 2)
            return loss, {"mse": loss}
        return loss_fn
    if arch_name == "nequip":
        def loss_fn(params, batch):
            g = batch["graph"]
            e = module.energy(cfg, params, g, g.positions)
            loss = share(torch.mean((e - batch["energy"]) ** 2))
            return loss, {"e_mse": loss}
        return loss_fn
    if arch_name == "equiformer-v2":
        def loss_fn(params, batch):
            e = module.forward(cfg, params, batch["graph"])
            loss = share(torch.mean((e - batch["energy"]) ** 2))
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


# ------------------------------------------------------------ mesh cells --

@dataclasses.dataclass
class MeshCell:
    """One (arch, shape) on one rank of a mesh: the JAX package's dry-run
    ``Cell``.  ``step_fn(*args)`` takes this rank's blocks of the
    arguments (each global argument of ``arg_shapes``, a tree of
    ``ShapeDtype``, cut by the spec tree of ``in_specs``) and runs its
    collectives on the mesh the cell was built for."""

    arch: str
    shape: str
    step_fn: Callable
    arg_shapes: tuple
    in_specs: tuple
    out_specs: Any
    model_flops_per_step: float  # 6*N*D (dense) / 6*N_active*D (MoE)
    donate: tuple = ()  # arguments whose blocks the step updates in place

    def local_arg_shapes(self, mesh) -> tuple:
        return tuple(sh.local_shapes(a, p, mesh)
                     for a, p in zip(self.arg_shapes, self.in_specs))

    def argument_bytes(self, mesh) -> int:
        """The exact bytes of one rank's blocks of every argument."""
        return sum(sh.bytes_per_rank(a, p, mesh)
                   for a, p in zip(self.arg_shapes, self.in_specs))


def _on_mesh(mesh, fn: Callable) -> Callable:
    def step(*args):
        with mesh_ops.use_mesh(mesh):
            return fn(*args)
    return step


def _shapes(tree):
    """A tree of tensors (meta or real) as ``ShapeDtype`` leaves."""
    return sh.tree_map(lambda _k, t: ShapeDtype(tuple(t.shape), t.dtype), tree)


def _train_state_shape(params_shape, opt_cfg: AdamWConfig) -> TrainState:
    mdt = getattr(torch, opt_cfg.moment_dtype)
    moments = sh.tree_map(lambda _k, s: ShapeDtype(s.shape, mdt), params_shape)
    return TrainState(params=params_shape, opt=AdamWState(
        step=ShapeDtype((), torch.int32), mu=moments,
        nu=sh.tree_map(lambda _k, s: s, moments)))


def _state_specs(p_specs) -> TrainState:
    return TrainState(params=p_specs, opt=sh.opt_state_specs(p_specs))


def lm_opt_cfg() -> AdamWConfig:
    """The JAX package's LM cells' AdamW: bf16 moments."""
    return AdamWConfig(lr_peak=3e-4, warmup_steps=200, total_steps=10_000,
                       moment_dtype="bfloat16")


def lm_mesh_config(cfg, kind: str, mesh):
    """``cfg`` as the JAX package's LM cells set it on ``mesh``: ZeRO-3
    storage everywhere; train cells sequence-parallel over the data axes;
    MoE archs one dispatch group per data rank (and, serving, the data
    axes as group axes)."""
    dp = dp_axes(mesh)
    dp_ways = int(np.prod([mesh.shape[mesh.mesh_dim_names.index(a)]
                           for a in dp]))
    groups = dp_ways if cfg.is_moe else 1
    if kind == "train":
        return dataclasses.replace(cfg, seq_parallel=dp, zero3_gather=True,
                                   moe_groups=groups)
    return dataclasses.replace(cfg, zero3_gather=True,
                               seq_parallel=dp if cfg.is_moe else None,
                               moe_groups=groups)


def lm_param_shapes(cfg) -> dict:
    from repro_torch.models.transformer import model as tmodel

    return _shapes(tmodel.init_params(cfg, torch.Generator(), "meta",
                                      requires_grad=False))


def lm_cache_shape(cfg, batch: int, max_len: int,
                   dtype=torch.bfloat16):
    from repro_torch.models.transformer.model import KVCache, _period

    per = _period(cfg)
    n_per = cfg.n_layers // per
    rem = cfg.n_layers - n_per * per
    full = ShapeDtype((n_per, per, batch, max_len, cfg.n_kv_heads, cfg.d_head),
                      dtype)
    tail = ShapeDtype((rem, batch, max_len, cfg.n_kv_heads, cfg.d_head), dtype)
    return KVCache(full, full, tail, tail, ShapeDtype((), torch.int32))


def build_lm_cell(arch: Arch, shape_name: str, mesh) -> MeshCell:
    from repro_torch.models.transformer import model as tmodel
    from repro_torch.training.steps import lm_loss_fn

    shape = LM_SHAPES[shape_name]
    cfg = lm_mesh_config(arch.config, shape.kind, mesh)
    b, s = shape.global_batch, shape.seq_len
    params_shape = lm_param_shapes(cfg)
    p_specs = sh.lm_param_specs(params_shape, mesh)
    n_active = cfg.active_param_count()

    if shape.kind == "train":
        opt_cfg = lm_opt_cfg()
        state_specs = _state_specs(p_specs)
        batch_shape = {"tokens": ShapeDtype((b, s), torch.int32),
                       "labels": ShapeDtype((b, s), torch.int32)}
        step = make_mesh_train_step(lm_loss_fn(cfg), opt_cfg, p_specs, mesh)
        return MeshCell(arch.name, shape_name, _on_mesh(mesh, step),
                        (_train_state_shape(params_shape, opt_cfg), batch_shape),
                        (state_specs, sh.lm_batch_specs(mesh)),
                        (state_specs, None), 6.0 * n_active * b * s, donate=(0,))

    cache_shape = lm_cache_shape(cfg, b, s)
    c_specs = sh.lm_cache_specs(cache_shape, mesh, batch=b, kind=shape.kind)
    dp = dp_axes(mesh) if b > 1 else ()
    if shape.kind == "prefill":
        def step(params, toks, cache):
            return tmodel.prefill(cfg, params, toks, cache._replace(length=0))

        return MeshCell(arch.name, shape_name, _on_mesh(mesh, step),
                        (params_shape, ShapeDtype((b, s), torch.int32),
                         cache_shape),
                        (p_specs, P(dp, None), c_specs), (None, c_specs),
                        2.0 * n_active * b * s, donate=(2,))

    # decode: one new token against a full cache (the last position)
    cache_axes = tuple(mesh.mesh_dim_names) if b == 1 else ("model",)

    def step(params, toks, cache):
        return tmodel.decode_step(cfg, params, toks,
                                  cache._replace(length=s - 1),
                                  cache_axes=cache_axes)

    return MeshCell(arch.name, shape_name, _on_mesh(mesh, step),
                    (params_shape, ShapeDtype((b, 1), torch.int32), cache_shape),
                    (p_specs, P(dp, None), c_specs), (None, c_specs),
                    2.0 * n_active * b, donate=(2,))


def gnn_graph_shape(arch_name: str, shape_name: str):
    """(GraphBatch of ``ShapeDtype``, padded nodes, padded edges): the JAX
    package's ``_gnn_graph_shape``."""
    from repro_torch.models.gnn.graph import GraphBatch

    cfg = archs()[arch_name].config
    shape = GNN_SHAPES[shape_name]
    if shape.kind == "sampled":
        n, e = sampled_subgraph_sizes(shape)
        n_graphs = 1
    elif shape.kind == "batched":
        n, e = shape.n_nodes * shape.batch_graphs, shape.n_edges * shape.batch_graphs
        n_graphs = shape.batch_graphs
    else:
        n, e, n_graphs = shape.n_nodes, shape.n_edges, 1
    n, e = _pad512(n), _pad512(e)
    f32, i32 = torch.float32, torch.int32
    g = GraphBatch(
        node_feat=ShapeDtype((n, gnn_d_in(arch_name, cfg, shape)), f32),
        edge_src=ShapeDtype((e,), i32), edge_dst=ShapeDtype((e,), i32),
        edge_feat=ShapeDtype((e, 8), f32), positions=ShapeDtype((n, 3), f32),
        node_mask=ShapeDtype((n,), f32), edge_mask=ShapeDtype((e,), f32),
        graph_id=ShapeDtype((n,), i32), n_graphs=n_graphs)
    return g, n, e


def build_gnn_mesh_cell(arch: Arch, shape_name: str, mesh) -> MeshCell:
    """The JAX package's GNN cell on a mesh: nodes and edges over every
    axis, params replicated.  Each rank passes its own edges' messages
    and updates its own nodes (``models/gnn/graph.py``, "On a mesh"), and
    takes its share of the loss; GraphCast's mesh nodes, a quarter of the
    grid's, are whole on every rank."""
    cfg = arch.config
    g_shape, n, e = gnn_graph_shape(arch.name, shape_name)
    d_in = g_shape.node_feat.shape[1]
    params_shape = _shapes(init_gnn_params(arch.name, cfg, torch.Generator(),
                                           d_in, "meta", requires_grad=False))
    p_specs = sh.gnn_param_specs(params_shape)
    state_specs = _state_specs(p_specs)
    ax = tuple(mesh.mesh_dim_names)
    batch_shape: dict[str, Any] = {"graph": g_shape}
    batch_specs: dict[str, Any] = {
        "graph": sh.gnn_graph_specs(mesh, n_graphs=g_shape.n_graphs)}
    if arch.name == "gatedgcn":
        batch_shape["labels"] = ShapeDtype((n,), torch.int32)
        batch_specs["labels"] = P(ax)
    elif arch.name == "graphcast":
        batch_shape["target"] = ShapeDtype((n, cfg.n_vars), torch.float32)
        batch_specs["target"] = P(ax, None)
    else:
        batch_shape["energy"] = ShapeDtype((g_shape.n_graphs,), torch.float32)
        batch_specs["energy"] = P()
    step = make_mesh_train_step(gnn_loss_fn(arch.name, cfg), FM_TRAIN_OPT,
                                p_specs, mesh)
    n_params = sum(int(np.prod(s.shape)) for _, s in sh.tree_items(params_shape))
    return MeshCell(arch.name, shape_name, _on_mesh(mesh, step),
                    (_train_state_shape(params_shape, FM_TRAIN_OPT), batch_shape),
                    (state_specs, batch_specs), (state_specs, None),
                    6.0 * n_params * n, donate=(0,))


def build_fm_mesh_cell(arch: Arch, shape_name: str, mesh) -> MeshCell:
    """The JAX package's FM cells on a mesh, table-parallel: ``emb`` and
    ``lin`` rows over "model", the batch (or the candidates) over the data
    axes; each model rank bags its rows (``fm.forward(mesh=)``).  A serve
    cell keeps its rank's squared table across calls."""
    cfg = arch.config
    shape = RECSYS_SHAPES[shape_name]
    rows, k = cfg.table_rows, cfg.embed_dim
    f32 = torch.float32
    params_shape = {"bias": ShapeDtype((), f32), "emb": ShapeDtype((rows, k), f32),
                    "lin": ShapeDtype((rows, 1), f32)}
    p_specs = sh.fm_param_specs(params_shape, mesh)
    dp = dp_axes(mesh)
    tables = fm_mod.TableRows()

    if shape.kind == "train":
        def loss_fn(params, batch):  # this rank's share of the mean BCE
            loss = fm_mod.bce_loss(cfg, tables.of(params), batch["ids"],
                                   batch["labels"], mesh)
            return loss, {"bce": loss}

        state_specs = _state_specs(p_specs)
        batch_shape = {"ids": ShapeDtype((shape.batch, cfg.n_fields), torch.int32),
                       "labels": ShapeDtype((shape.batch,), f32)}
        step = make_mesh_train_step(loss_fn, FM_TRAIN_OPT, p_specs, mesh)
        return MeshCell(arch.name, shape_name, _on_mesh(mesh, step),
                        (_train_state_shape(params_shape, FM_TRAIN_OPT), batch_shape),
                        (state_specs, sh.fm_batch_specs(mesh)), (state_specs, None),
                        6.0 * shape.batch * cfg.n_fields * cfg.embed_dim,
                        donate=(0,))

    if shape.kind == "serve":
        def step(params, ids):
            return fm_mod.forward(cfg, tables.of(params), ids, mesh)

        return MeshCell(arch.name, shape_name, _on_mesh(mesh, torch.no_grad()(step)),
                        (params_shape,
                         ShapeDtype((shape.batch, cfg.n_fields), torch.int32)),
                        (p_specs, P(dp, None)), None,
                        2.0 * shape.batch * cfg.n_fields * cfg.embed_dim)

    # retrieval: 1 query x n_candidates, the candidates over the data axes
    def step(params, q, cands):
        return fm_mod.retrieval_scores(cfg, tables.of(params), q, cands, mesh)

    return MeshCell(arch.name, shape_name, _on_mesh(mesh, torch.no_grad()(step)),
                    (params_shape, ShapeDtype((cfg.n_fields,), torch.int32),
                     ShapeDtype((shape.n_candidates, cfg.n_fields), torch.int32)),
                    (p_specs, P(), P(dp, None)), None,
                    2.0 * shape.n_candidates * cfg.n_fields * cfg.embed_dim)


def build_cell(arch_name: str, shape_name: str, mesh) -> MeshCell:
    """The mesh cell of (arch, shape) on ``mesh``: a ``DeviceMesh`` to run
    its step, or any mesh with axis names and sizes to plan it."""
    arch = archs()[arch_name]
    if shape_name not in arch.shape_names:
        raise ValueError(f"{arch_name} does not run shape {shape_name} "
                         "(pure-global archs take no long_500k)")
    if arch.family == "lm":
        return build_lm_cell(arch, shape_name, mesh)
    if arch.family == "gnn":
        return build_gnn_mesh_cell(arch, shape_name, mesh)
    return build_fm_mesh_cell(arch, shape_name, mesh)
