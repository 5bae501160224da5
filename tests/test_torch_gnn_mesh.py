"""The GNNs on a split graph: four gloo ranks of a (2, 2) ("data", "model")
mesh on the CPU, each holding its block of the nodes and of the edges
(``launch/shardings.py``'s graph specs: both over every axis), pass their
own edges' messages (``models/gnn/graph.py``, "On a mesh") and take their
shares of the loss.  Held against the same loss and gradients unsharded
in this process, whose one-card path the GNN tests hold against the JAX
package.

Reduced configs (``launch/smoke.py``'s), float32 latents, a batch of four
small graphs padded to 512 nodes and edges (128 of each a rank).
Tolerances: the loss within 1e-5 relative; every gradient leaf within
1e-5 of its largest magnitude (+1e-8): the ranks sum their messages in
another order.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.configs.shapes import GNNShape
from repro_torch.distributed import mesh_ops, run_ranks
from repro_torch.launch import shardings as sh
from repro_torch.launch.smoke import gnn_smoke_config
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.steps import mesh_grads

ARCHS = ("gatedgcn", "graphcast", "nequip", "equiformer-v2")
SHAPE = GNNShape("tiny", "batched", 24, 64, 13, batch_graphs=4)
WAIT_S = 240.0


def _cfg(name):
    cfg = gnn_smoke_config(name)
    if name == "graphcast":
        cfg = dataclasses.replace(cfg, latent_dtype="float32")
    return cfg


def _inputs(name):
    """(params, batch) on the CPU: the registry's batch of ``SHAPE``."""
    cfg = _cfg(name)
    gen = torch.Generator().manual_seed(3)
    params = registry.init_gnn_params(name, cfg, gen,
                                      registry.gnn_d_in(name, cfg, SHAPE), "cpu")
    registry.perturb_constant_leaves(params, gen)
    batch = registry.gnn_batch(name, SHAPE, np.random.default_rng(5), "cpu",
                               cfg=cfg)
    return params, batch


def _batch_specs(batch, mesh):
    every = tuple(mesh.mesh_dim_names)
    specs = {"graph": sh.gnn_graph_specs(mesh, n_graphs=batch["graph"].n_graphs)}
    for k, v in batch.items():
        if k != "graph":
            specs[k] = sh.P() if k == "energy" else sh.P(every, *[None] * (v.dim() - 1))
    return specs


def _rank(rank, world, jobs):
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for name, (params, batch) in jobs.items():
        specs = sh.gnn_param_specs(params)
        local = sh.tree_map(
            lambda _k, x, p: sh.local_block(x, p, mesh)
            if isinstance(x, torch.Tensor) else x, batch, _batch_specs(batch, mesh))
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        with mesh_ops.use_mesh(mesh):
            loss, _, grads = mesh_grads(registry.gnn_loss_fn(name, _cfg(name)),
                                        params, local, specs, mesh)
        out[name] = {"loss": float(loss),
                     "grads": [g.detach().numpy().copy() for g in grads]}
    return out


@pytest.fixture(scope="module")
def runs():
    jobs = {name: _inputs(name) for name in ARCHS}
    ranks = run_ranks(_rank, 4, jobs, device="cpu", timeout_s=WAIT_S)
    return {"jobs": jobs, "ranks": ranks}


@pytest.mark.parametrize("name", ARCHS)
def test_split_graph_loss_and_gradients_equal_the_whole_graph(runs, name):
    params, batch = runs["jobs"][name]
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, _ = registry.gnn_loss_fn(name, _cfg(name))(params, batch)
    want = torch.autograd.grad(loss, leaves, materialize_grads=True)
    loss = float(loss.detach())
    for rank in runs["ranks"]:
        got = rank[name]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        assert len(got["grads"]) == len(want)
        for g, w in zip(got["grads"], want):
            w = w.numpy()
            tol = 1e-5 * float(np.abs(w).max()) + 1e-8
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
