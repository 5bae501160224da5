"""Training the GNNs on the port against the JAX package: NequIP's forces
and the force-matching loss (grad of a gradient, through
``chunked_edge_aggregate``'s differentiable backward), the GNN loss
functions, the registry's configs and ``build_gnn_cell`` (one-card train
cells) at reduced configs on the CPU, and a GNN train state carried over
from JAX.

Tolerances: forces, losses and gradients within 1e-5 of each quantity's
largest magnitude, as in test_torch_gnn_models.py (the same float32
formulas in other orders).  A self-loop (``synthetic_graph`` draws them)
has the zero vector as its edge, and ``vec / max(dist, 1e-9)`` gives its
direction gradients 1e9 times its messages'; they enter its atom's force
twice with opposite signs and cancel up to their rounding, which depends
on the order of the sum: an atom with a self-loop holds its force within
1e-6 (8 float32 ulps) of the summed magnitudes of its edges' gradients.
The force loss squares those forces, so its comparison masks self-loops
out.  An AdamW step moves a parameter by about lr * sign(g) (the k-th
step's lr is k * 1e-5 in the warm-up), so an element whose gradient is
rounding noise on one side may move by up to lr either way: after k steps
parameters within 2 * (lr_1 + ... + lr_k) + 1e-6 * |p| of JAX's.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models.gnn import graph as jgraph
from repro.models.gnn import nequip as jnq
from repro.training import steps as jsteps
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro_torch import interop
from repro_torch.configs import registry as tregistry
from repro_torch.configs.shapes import GNN_SHAPES, GNNShape
from repro_torch.models.gnn import graph as tgraph
from repro_torch.models.gnn import nequip as tnq
from repro_torch.training import init_train_state
from repro_torch.training import steps as tsteps
from repro_torch.training.optimizer import tree_leaves

import test_torch_gnn_models as models

REL = 1e-5
NQ = jnq.NequIPConfig(n_layers=2, d_hidden=8, edge_chunk=32)

# reduced configs of the registry's architectures for the CPU cells
REDUCED = {
    "gatedgcn": dict(n_layers=2, d_hidden=16, d_out=8),
    "graphcast": dict(n_layers=2, d_hidden=32, latent_dtype="float32"),
    "nequip": dict(n_layers=2, d_hidden=8, edge_chunk=4096),
    "equiformer-v2": dict(n_layers=1, d_hidden=16, l_max=2, n_heads=4,
                          edge_chunk=4096),
}


def _reduced(arch):
    return dataclasses.replace(tregistry.archs()[arch].config, **REDUCED[arch])


def _nequip_pair(graph, seed):
    n, e, d, n_graphs = graph
    jp = models.random_params(jnq, "nequip", NQ, d, seed)
    tp = interop.gnn_params_from_jax("nequip", jax.tree.map(np.asarray, jp),
                                     device="cpu")
    jg = jgraph.synthetic_graph(n, e, d, seed=seed, n_graphs=n_graphs)
    tg = tgraph.synthetic_graph(n, e, d, seed=seed, n_graphs=n_graphs,
                                device="cpu")
    return jp, tp, jg, tg


def _mask_loops(jg, tg):
    keep = (tg.edge_src != tg.edge_dst).float()
    return (jg.replace(edge_mask=jnp.asarray(keep.numpy())),
            tg.replace(edge_mask=keep))


@pytest.mark.parametrize("graph", [(24, 64, 13, 1), (10, 24, 5, 3)])
def test_nequip_forces_match_jax(graph):
    jp, tp, jg, tg = _nequip_pair(graph, seed=2)
    loops = (tg.edge_src == tg.edge_dst).numpy()
    assert loops.sum() > 0
    ef = jax.jit(lambda p, g: jnq.energy_and_forces(NQ, p, g))
    # self-loops masked out: every atom within REL
    jm, tm = _mask_loops(jg, tg)
    e_ref, f_ref = ef(jp, jm)
    e, f = tnq.energy_and_forces(NQ, tp, tm)
    models.assert_scaled(e_ref, e, REL, "energy")
    models.assert_scaled(f_ref, f, REL, "forces")
    assert float(f.detach().abs().max()) > 1e-3
    with torch.no_grad():  # inference: no graph kept
        e2, f2 = tnq.energy_and_forces(NQ, tp, tm)
    assert not e2.requires_grad and not f2.requires_grad
    models.assert_scaled(f.detach().numpy(), f2, REL, "inference forces")
    # live self-loops: atoms without one within REL, atoms with one within
    # 1e-6 of the summed magnitudes of their edges' vector gradients
    e_ref, f_ref = ef(jp, jg)
    e, f = tnq.energy_and_forces(NQ, tp, tg)
    models.assert_scaled(e_ref, e, REL, "energy")
    vec = (tg.positions[tg.edge_src] - tg.positions[tg.edge_dst]).requires_grad_(True)
    (g_vec,) = torch.autograd.grad(tnq.energy_from_edges(NQ, tp, tg, vec).sum(), vec)
    mag = torch.zeros(tg.n_nodes).index_add_(0, tg.edge_src, g_vec.abs().sum(1))
    mag.index_add_(0, tg.edge_dst, g_vec.abs().sum(1))
    looped = np.zeros(tg.n_nodes, bool)
    looped[tg.edge_src.numpy()[loops]] = True
    diff = np.abs(np.asarray(f_ref) - f.detach().numpy()).max(1)
    scale = float(np.abs(np.asarray(f_ref)[~looped]).max())
    assert diff[~looped].max() <= REL * scale
    assert (diff[looped] <= 1e-6 * mag.numpy()[looped]).all()
    assert float(mag[looped].max()) > 1e3  # the 1e9-scale terms are there


@pytest.mark.parametrize("force_weight", [0.0, 0.5])
def test_energy_loss_fn_and_its_grad_of_grad_match_jax(force_weight):
    jp, tp, jg, tg = _nequip_pair((10, 24, 5, 3), seed=3)
    jg, tg = _mask_loops(jg, tg)
    rng = np.random.default_rng(4)
    energy = rng.normal(size=(3,)).astype(np.float32) * 3
    forces = rng.normal(size=(30, 3)).astype(np.float32)
    jb = {"graph": jg, "energy": jnp.asarray(energy), "forces": jnp.asarray(forces)}
    tb = {"graph": tg, "energy": torch.as_tensor(energy),
          "forces": torch.as_tensor(forces)}
    j_loss_fn = jsteps.energy_loss_fn(NQ, jnq.energy_and_forces,
                                      force_weight=force_weight)
    (j_loss, j_m), j_grads = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True))(
        jp, jb)
    loss, m = tsteps.energy_loss_fn(NQ, tnq.energy_and_forces,
                                    force_weight=force_weight)(tp, tb)
    models.assert_scaled(j_loss, loss, REL, "loss")
    models.assert_scaled(j_m["e_mse"], m["e_mse"], REL, "e_mse")
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(j_grads), grads)):
        models.assert_scaled(a, b, REL, f"grad leaf {i}")
    if force_weight > 0:  # the force term moves every layer's radial MLP
        e_only, _ = tsteps.energy_loss_fn(NQ, tnq.energy_and_forces)(tp, tb)
        g0 = torch.autograd.grad(e_only, tree_leaves(tp))
        assert all(float((a - b).abs().max()) > 0 for a, b in zip(grads[1:3], g0[1:3]))


def test_regression_and_node_class_losses_match_jax():
    rng = np.random.default_rng(6)
    g = tgraph.synthetic_graph(12, 20, 4, device="cpu")
    jg = jgraph.synthetic_graph(12, 20, 4)
    mask = (rng.random(12) > 0.25).astype(np.float32)
    g, jg = g.replace(node_mask=torch.as_tensor(mask)), jg.replace(
        node_mask=jnp.asarray(mask))
    out = rng.normal(size=(12, 6)).astype(np.float32)
    labels = rng.integers(0, 5, 12).astype(np.int32)
    target = rng.normal(size=(12, 6)).astype(np.float32)

    def t_fwd(cfg, p, g_):
        return torch.as_tensor(out)

    def j_fwd(cfg, p, g_):
        return jnp.asarray(out)

    for j_fn, t_fn, extra in (
            (jsteps.gnn_node_class_loss_fn(None, j_fwd, 5),
             tsteps.gnn_node_class_loss_fn(None, t_fwd, 5), {"labels": labels}),
            (jsteps.gnn_regression_loss_fn(None, j_fwd),
             tsteps.gnn_regression_loss_fn(None, t_fwd), {"target": target})):
        j_loss, j_m = j_fn(None, {"graph": jg, **{k: jnp.asarray(v) for k, v in extra.items()}})
        loss, m = t_fn(None, {"graph": g, **{k: torch.as_tensor(v) for k, v in extra.items()}})
        assert set(m) == set(j_m)
        np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)


def test_registry_gnn_configs_equal_jax():
    j_archs, t_archs = jregistry.archs(), tregistry.archs()
    gnns = sorted(n for n, a in t_archs.items() if a.family == "gnn")
    assert gnns == sorted(n for n, a in j_archs.items() if a.family == "gnn")
    assert gnns == ["equiformer-v2", "gatedgcn", "graphcast", "nequip"]
    for name in gnns:
        assert vars(t_archs[name].config) == vars(j_archs[name].config)
        assert t_archs[name].shape_names == j_archs[name].shape_names
    assert t_archs["graphcast"].config.latent_dtype == "bfloat16"
    assert all(t_archs[n].config.remat for n in gnns)


def test_graph_is_padded_as_the_jax_cell_pads_it():
    for name, (n, e) in {"full_graph_sm": (3_072, 10_752),
                         "molecule": (4_096, 8_192)}.items():
        shape = GNN_SHAPES[name]
        arrs = tregistry.gnn_graph_numpy(shape, 5, np.random.default_rng(0))
        j_g, j_n, j_e = jregistry._gnn_graph_shape(
            jregistry.archs()["nequip"], name)
        assert (len(arrs["node_feat"]), len(arrs["edge_src"])) == (j_n, j_e) == (n, e)
        assert arrs["n_graphs"] == j_g.n_graphs
        real_n = shape.n_nodes * shape.batch_graphs
        real_e = shape.n_edges * shape.batch_graphs
        assert arrs["node_mask"].sum() == real_n and arrs["edge_mask"].sum() == real_e
        assert not arrs["edge_src"][real_e:].any() and not arrs["node_feat"][real_n:].any()
        # the real part is synthetic_graph's with the generator's first draw
        seed = int(np.random.default_rng(0).integers(0, 2**31 - 1))
        ref = jgraph.synthetic_graph(shape.n_nodes, shape.n_edges, 5, seed=seed,
                                     n_graphs=shape.batch_graphs)
        np.testing.assert_array_equal(arrs["edge_dst"][:real_e], np.asarray(ref.edge_dst))
        np.testing.assert_array_equal(arrs["positions"][:real_n], np.asarray(ref.positions))


def test_sampled_graph_comes_from_the_sampler():
    shape = GNNShape("tiny_sampled", "sampled", 3_000, 60_000, 7,
                     batch_nodes=16, fanout=(5, 3))
    arrs = tregistry.gnn_graph_numpy(shape, 7, np.random.default_rng(1))
    n, e = 16 * (1 + 5 + 15), 16 * (5 + 15)
    assert len(arrs["node_feat"]) == 512 and len(arrs["edge_src"]) == 512
    assert arrs["node_mask"].sum() == n and arrs["edge_mask"].sum() == e
    rng = np.random.default_rng(1)
    from repro.models.gnn import sampler as jsampler

    csr = jsampler.random_regular_csr(3_000, 20, seed=int(rng.integers(0, 2**31 - 1)))
    seeds = rng.choice(3_000, 16, replace=False)
    nodes, src, dst, _ = jsampler.sample_subgraph(
        csr, seeds, (5, 3), seed=int(rng.integers(0, 2**31 - 1)))
    np.testing.assert_array_equal(arrs["edge_src"][:e], src)
    np.testing.assert_array_equal(arrs["edge_dst"][:e], dst)
    feat = rng.standard_normal((3_000, 7), dtype=np.float32)
    np.testing.assert_array_equal(arrs["node_feat"][:n], feat[nodes])
    assert (dst[:16 * 5] < 16).all() and arrs["n_graphs"] == 1


# the architecture and shape of each cell held against JAX's train step
PARITY = [("gatedgcn", "full_graph_sm"), ("graphcast", "molecule"),
          ("nequip", "molecule"), ("equiformer-v2", "molecule")]


@pytest.mark.parametrize("arch,shape_name", PARITY)
def test_gnn_cell_steps_equal_jax(arch, shape_name):
    """Two steps of ``build_gnn_cell`` on the CPU at a reduced config equal
    two of the JAX package's ``make_train_step`` over the same params and
    batch (losses, then parameters); the loss falls."""
    cfg = _reduced(arch)
    shape = GNN_SHAPES[shape_name]
    d_in = tregistry.gnn_d_in(arch, cfg, shape)
    module = {"gatedgcn": models.jgc, "graphcast": models.jgcast,
              "nequip": jnq, "equiformer-v2": models.jeq}[arch]
    np_params = jax.tree.map(np.asarray, models.random_params(
        module, arch, cfg, d_in, seed=9))
    params = interop.gnn_params_from_jax(arch, np_params, device="cpu")
    cell = tregistry.build_gnn_cell(arch, shape_name, params,
                                    np.random.default_rng(2), device="cpu",
                                    cfg=cfg)
    assert cell.train and cell.rows == cell.inputs[0]["graph"].n_nodes
    batch = cell.inputs[0]
    g = batch["graph"]
    jg = jgraph.GraphBatch(**{f.name: jnp.asarray(getattr(g, f.name).numpy())
                              for f in dataclasses.fields(g) if f.name != "n_graphs"},
                           n_graphs=g.n_graphs)
    jb = {"graph": jg, **{k: jnp.asarray(v.numpy()) for k, v in batch.items()
                          if k != "graph"}}
    opt = JAdamWConfig(lr_peak=1e-3, warmup_steps=100, total_steps=5000)
    _, j_loss_fn = jregistry._gnn_forward_and_loss(
        jregistry.Arch(arch, "gnn", cfg, ()))
    jstep = jax.jit(jsteps.make_train_step(j_loss_fn, opt))
    jstate = jsteps.init_train_state(jax.tree.map(jnp.asarray, np_params), opt)
    losses = []
    for _ in range(2):
        m = cell.run()
        jstate, jm = jstep(jstate, jb)
        losses.append(float(m["loss"]))
        models.assert_scaled(jm["loss"], m["loss"], REL, "loss")
        assert abs(float(m["lr"]) - float(jm["lr"])) <= 1e-9
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    lrs = 1e-5 + 2e-5  # the two steps'
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jstate.params),
                                   tree_leaves(cell.params.params))):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), rtol=1e-6,
                                   atol=2 * lrs, err_msg=f"leaf {i}")


@pytest.mark.parametrize("arch", sorted(REDUCED))
def test_gnn_cells_run_on_the_cpu_at_both_small_shapes(arch):
    cfg = _reduced(arch)
    for shape_name in ("full_graph_sm", "molecule"):
        d_in = tregistry.gnn_d_in(arch, cfg, GNN_SHAPES[shape_name])
        gen = torch.Generator().manual_seed(0)
        params = tregistry.init_gnn_params(arch, cfg, gen, d_in, "cpu")
        tregistry.perturb_constant_leaves(params, gen)
        cell = tregistry.build_gnn_cell(arch, shape_name, params,
                                        np.random.default_rng(0), "cpu", cfg=cfg)
        losses = [float(cell.run()["loss"]) for _ in range(2)]
        assert np.isfinite(losses).all() and losses[1] < losses[0], (shape_name, losses)
        assert int(cell.params.opt.step) == 2


def test_graphcast_at_the_jax_init_rises_once_on_its_padding():
    """The reason for ``perturb_constant_leaves``: at the JAX init (zero
    biases) GraphCast's padding rows are exactly zero before each LayerNorm,
    and the first step moves their predictions off zero."""
    cfg = _reduced("graphcast")
    params = tregistry.init_gnn_params("graphcast", cfg,
                                       torch.Generator().manual_seed(0), 227, "cpu")
    cell = tregistry.build_gnn_cell("graphcast", "full_graph_sm", params,
                                    np.random.default_rng(0), "cpu", cfg=cfg)
    g = cell.inputs[0]["graph"]
    with torch.no_grad():
        pred = models.tgcast.forward(cfg, params, g)
    pad = g.node_mask == 0
    assert int(pad.sum()) == 3_072 - 2_708 and float(pred[pad].abs().max()) == 0
    losses = [float(cell.run()["loss"]) for _ in range(2)]
    with torch.no_grad():
        pred = models.tgcast.forward(cfg, params, g)
    assert losses[1] > losses[0] and float(pred[pad].abs().mean()) > 0.1


def test_build_gnn_cell_checks_its_arguments():
    cfg = _reduced("gatedgcn")
    params = tregistry.init_gnn_params("gatedgcn", cfg, torch.Generator(), 1433, "cpu")
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="not a GNN"):
        tregistry.build_gnn_cell("fm", "molecule", params, rng, "cpu")
    with pytest.raises(ValueError, match="no shape"):
        tregistry.build_gnn_cell("gatedgcn", "train_4k", params, rng, "cpu")
    with pytest.raises(ValueError, match="params are on cpu"):
        tregistry.build_gnn_cell("gatedgcn", "molecule", params, rng, "meta")
    frozen = tregistry.init_gnn_params("gatedgcn", cfg, torch.Generator(), 16,
                                       "cpu", requires_grad=False)
    with pytest.raises(ValueError, match="requires_grad=True"):
        tregistry.build_gnn_cell("gatedgcn", "molecule", frozen, rng, "cpu")
    with pytest.raises(KeyError, match="must hold"):
        interop.gnn_params_from_jax("nequip", {"embed": np.zeros(2)}, device="cpu")
    with pytest.raises(KeyError, match="unknown GNN"):
        interop.gnn_params_from_jax("fm", {}, device="cpu")


def test_train_state_from_jax_fills_a_gnn_state():
    cfg = jnq.NequIPConfig(n_layers=2, d_hidden=8, edge_chunk=32)
    opt = JAdamWConfig(lr_peak=1e-3, warmup_steps=100, total_steps=5000)
    jp = models.random_params(jnq, "nequip", cfg, 5, seed=1)
    jg = jgraph.synthetic_graph(10, 24, 5, seed=0, n_graphs=3)
    jb = {"graph": jg, "energy": jnp.ones(3)}
    _, loss_fn = jregistry._gnn_forward_and_loss(jregistry.Arch("nequip", "gnn", cfg, ()))
    jstate, _ = jsteps.make_train_step(loss_fn, opt)(
        jsteps.init_train_state(jp, opt), jb)
    np_state = jax.tree.map(np.asarray, jstate)
    template = init_train_state(
        tregistry.init_gnn_params("nequip", cfg, torch.Generator(), 5, "cpu"),
        tregistry.FM_TRAIN_OPT)
    state = interop.train_state_from_jax(np_state, template)
    assert int(state.opt.step) == 1
    for a, b in zip(jax.tree_util.tree_leaves(np_state), tree_leaves(state)):
        np.testing.assert_array_equal(a, b.detach().numpy())
    assert tree_leaves(state.params)[0].shape == (5, 8)
