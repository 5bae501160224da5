"""The four GNNs of the port against the JAX package: forward, loss and
every parameter's gradient at the smoke sizes (``synthetic_graph(24, 64,
13)``, repro/launch/smoke.py) and at tests/test_gnn_smoke.py's sizes, from
one set of weights carried over by ``gnn_params_from_jax``.  Every leaf is
drawn from a numpy seed, ``head_w2`` included (NequIP's and EquiformerV2's
start at zero, which would make energies and most gradients 0).

Then the invariance checks of tests/test_gnn_smoke.py on the port, with
non-zero heads: rotation, translation and edge chunking.  A self-loop has
no direction: its SH values and its edge frame are those of the zero vector
whatever the rotation, so it breaks the symmetry, on both sides alike (the
JAX tests' zero heads hide it; ``test_self_loops_break_rotation_alike``
shows it).  The symmetry checks mask self-loops out (``edge_mask`` 0).

Tolerances (float32): outputs, losses and gradients within 1e-5 of each
leaf's largest magnitude (max |a - b| <= 1e-5 * max |a|).  Both sides run
the same float32 formulas, but in other orders (the port contracts every
NequIP path at once; the matmuls block differently), so they differ by a
few ulps per op and ~1e-6 relative after two or three layers.  GraphCast
with bfloat16 latents (the full config's) rounds every latent op to 8 bits
on both sides, in other orders: its outputs within 0.06 of their largest
magnitude (a few bf16 ulps, 2^-8 each, over 2 processor layers).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models.gnn import equiformer_v2 as jeq
from repro.models.gnn import gatedgcn as jgc
from repro.models.gnn import graphcast as jgcast
from repro.models.gnn import nequip as jnq
from repro.models.gnn import so3 as jso3
from repro.models.gnn.graph import synthetic_graph as jgraph
from repro_torch import interop
from repro_torch.configs import registry as tregistry
from repro_torch.models.gnn import equiformer_v2 as teq
from repro_torch.models.gnn import gatedgcn as tgc
from repro_torch.models.gnn import graphcast as tgcast
from repro_torch.models.gnn import nequip as tnq
from repro_torch.models.gnn.graph import synthetic_graph as tgraph
from repro_torch.training.optimizer import tree_leaves

REL = 1e-5
BF16_REL = 0.06

# (arch, JAX module, port module, config, graph (n, e, d, n_graphs))
SMOKE = (24, 64, 13, 1)
CASES = {
    "gatedgcn": (jgc, tgc, jgc.GatedGCNConfig(n_layers=3, d_hidden=16, d_out=4),
                 [SMOKE, (24, 64, 12, 1)]),
    "graphcast": (jgcast, tgcast,
                  jgcast.GraphCastConfig(n_layers=2, d_hidden=32, n_vars=13),
                  [SMOKE]),
    "nequip": (jnq, tnq, jnq.NequIPConfig(n_layers=2, d_hidden=8, edge_chunk=32),
               [SMOKE, (10, 24, 5, 3)]),
    "equiformer-v2": (jeq, teq, jeq.EquiformerV2Config(
        n_layers=2, d_hidden=16, l_max=3, n_heads=4, edge_chunk=32),
        [SMOKE, (8, 20, 6, 2)]),
}


def random_params(module, arch, cfg, d_in, seed):
    """The JAX package's params tree with every leaf redrawn from a numpy
    seed (LeCun scale for matrices, around 1 for LayerNorm gains)."""
    key = jax.random.PRNGKey(0)
    p = (module.init_params(cfg, key) if arch == "graphcast"
         else module.init_params(cfg, key, d_in))
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        scale = 1 / np.sqrt(x.shape[-2]) if x.ndim >= 2 else 0.3
        out = rng.normal(size=x.shape) * scale
        if x.ndim == 1 or (np.all(x == 1) and x.ndim <= 2):
            out = out + (1.0 if np.all(x == 1) else 0.0)
        return out.astype(np.float32)

    return jax.tree.map(draw, p)


def _batch(arch, cfg, graph, seed):
    """JAX and port batches holding the same graph and targets."""
    n, e, d, n_graphs = graph
    jg = jgraph(n, e, d, seed=seed, n_graphs=n_graphs)
    tg = tgraph(n, e, d, seed=seed, n_graphs=n_graphs, device="cpu")
    rng = np.random.default_rng(seed + 100)
    extra = {}
    if arch == "gatedgcn":
        extra["labels"] = rng.integers(0, cfg.d_out, jg.n_nodes).astype(np.int32)
    elif arch == "graphcast":
        extra["target"] = rng.normal(size=(jg.n_nodes, cfg.n_vars)).astype(np.float32)
    else:
        extra["energy"] = rng.normal(size=(n_graphs,)).astype(np.float32) * 3
    jb = {"graph": jg, **{k: jnp.asarray(v) for k, v in extra.items()}}
    tb = {"graph": tg, **{k: torch.as_tensor(v) for k, v in extra.items()}}
    return jb, tb


def assert_scaled(ref, out, rel, what=""):
    ref = np.asarray(ref, dtype=np.float32)
    out = out.detach().float().cpu().numpy()
    assert ref.shape == out.shape, what
    scale = float(np.abs(ref).max())
    err = float(np.abs(ref - out).max())
    assert err <= rel * scale, f"{what}: max |diff| {err} > {rel} * {scale}"


def _outputs(arch, module, cfg, params, g):
    if arch == "nequip":
        return module.energy(cfg, params, g, g.positions)
    return module.forward(cfg, params, g)


@pytest.mark.parametrize("arch,gi", [(a, i) for a, c in CASES.items()
                                     for i in range(len(c[3]))])
def test_forward_loss_and_grads_match_jax(arch, gi):
    jm, tm, cfg, graphs = CASES[arch]
    graph = graphs[gi]
    jp = random_params(jm, arch, cfg, graph[2], seed=gi + 1)
    tp = interop.gnn_params_from_jax(arch, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    jb, tb = _batch(arch, cfg, graph, seed=gi)
    j_arch = jregistry.Arch(arch, "gnn", cfg, ())
    _, j_loss_fn = jregistry._gnn_forward_and_loss(j_arch)
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(j_loss_fn, has_aux=True))(
        jp, jb)

    out = _outputs(arch, tm, cfg, tp, tb["graph"])
    ref = jax.jit(lambda p_, g_: _outputs(arch, jm, cfg, p_, g_))(jp, jb["graph"])
    assert_scaled(ref, out, REL, "output")
    assert bool(out.abs().max() > 0)
    loss, _ = tregistry.gnn_loss_fn(arch, cfg)(tp, tb)
    assert_scaled(j_loss, loss, REL, "loss")
    leaves = tree_leaves(tp)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    j_leaves = jax.tree_util.tree_leaves(j_grads)
    assert len(j_leaves) == len(grads)
    nonzero = 0
    for i, (a, b) in enumerate(zip(j_leaves, grads)):
        assert_scaled(a, b, REL, f"grad leaf {i} {tuple(b.shape)}")
        nonzero += bool(b.abs().max() > 0)
    # unused on both sides: GraphCast's embed_edge (6 leaves), GatedGCN's
    # embed_e (the edge features are zeros); every other leaf moves
    assert nonzero == len(grads) - {"graphcast": 6, "gatedgcn": 1}.get(arch, 0)


def test_graphcast_bf16_latents_match_jax_within_bf16_rounding():
    cfg = jgcast.GraphCastConfig(n_layers=2, d_hidden=32, n_vars=13,
                                 latent_dtype="bfloat16")
    jp = random_params(jgcast, "graphcast", cfg, 13, seed=7)
    tp = interop.gnn_params_from_jax("graphcast", jax.tree.map(np.asarray, jp),
                                     device="cpu", requires_grad=False)
    jb, tb = _batch("graphcast", cfg, SMOKE, seed=3)
    ref = jgcast.forward(cfg, jp, jb["graph"])
    out = tgcast.forward(cfg, tp, tb["graph"])
    assert out.dtype == torch.float32
    assert_scaled(ref, out, BF16_REL, "bf16 output")
    f32 = tgcast.forward(jgcast.GraphCastConfig(n_layers=2, d_hidden=32,
                                                n_vars=13), tp, tb["graph"])
    assert float((out - f32).abs().max()) > 0  # the latents are bf16 indeed


def test_remat_and_unchunked_paths_equal_the_plain_ones():
    """``remat`` (per-layer checkpoint) changes nothing: same loss and
    gradients; NequIP's unchunked aggregation gives the chunked energy."""
    for arch in CASES:
        jm, tm, cfg, graphs = CASES[arch]
        jp = jax.tree.map(np.asarray, random_params(jm, arch, cfg, 13, seed=4))
        _, tb = _batch(arch, cfg, SMOKE, seed=5)
        res = []
        for remat in (False, True):
            c = type(cfg)(**{**vars(cfg), "remat": remat})
            tp = interop.gnn_params_from_jax(arch, jp, device="cpu")
            loss, _ = tregistry.gnn_loss_fn(arch, c)(tp, tb)
            res.append((loss, torch.autograd.grad(
                loss, tree_leaves(tp), allow_unused=True, materialize_grads=True)))
        torch.testing.assert_close(res[0][0], res[1][0], rtol=0, atol=0)
        for a, b in zip(res[0][1], res[1][1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    cfg = CASES["nequip"][2]
    tp = interop.gnn_params_from_jax(
        "nequip", jax.tree.map(np.asarray, random_params(jnq, "nequip", cfg, 13, 4)),
        device="cpu", requires_grad=False)
    g = tgraph(24, 64, 13, seed=1, device="cpu")
    torch.testing.assert_close(tnq.energy(cfg, tp, g, g.positions),
                               tnq.energy(cfg, tp, g, g.positions, chunked=False),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------- invariance checks, on the port --

def _port_params(module, arch, cfg, d_in, seed):
    return interop.gnn_params_from_jax(
        arch, jax.tree.map(np.asarray, random_params(module, arch, cfg, d_in, seed)),
        device="cpu", requires_grad=False)


def _rotated(g, rot):
    return g.replace(positions=g.positions @ torch.as_tensor(rot.T, dtype=torch.float32))


def _no_loops(g):
    """``g`` with its self-loops masked out."""
    return g.replace(edge_mask=g.edge_mask * (g.edge_src != g.edge_dst))


def test_self_loops_break_rotation_alike():
    """With live self-loops EquiformerV2's energy moves under a rotation, by
    the same amount on both sides (within REL of the energies)."""
    cfg = jeq.EquiformerV2Config(n_layers=2, d_hidden=16, l_max=4, m_max=2,
                                 n_heads=4, edge_chunk=64)
    jp = random_params(jeq, "equiformer-v2", cfg, 6, seed=6)
    p = interop.gnn_params_from_jax("equiformer-v2", jax.tree.map(np.asarray, jp),
                                    device="cpu", requires_grad=False)
    g = tgraph(10, 24, 6, seed=0, device="cpu")
    jg_ = jgraph(10, 24, 6, seed=0)
    assert int((g.edge_src == g.edge_dst).sum()) > 0
    rot = jso3._rot_x(1.2) @ jso3._rot_z(0.5)
    jrot = jg_.replace(positions=jnp.asarray(np.asarray(jg_.positions) @ rot.T))
    moved = teq.forward(cfg, p, _rotated(g, rot)) - teq.forward(cfg, p, g)
    j_moved = np.asarray(jeq.forward(cfg, jp, jrot) - jeq.forward(cfg, jp, jg_))
    assert float(moved.abs().max()) > 1e-2
    scale = float(np.abs(np.asarray(jeq.forward(cfg, jp, jg_))).max())
    assert float(np.abs(j_moved - moved.numpy()).max()) <= REL * scale


NQ = jnq.NequIPConfig(n_layers=2, d_hidden=8, l_max=2, edge_chunk=32)


@pytest.mark.parametrize("seed", [0, 1])
def test_nequip_energy_rotation_invariant(seed):
    g = _no_loops(tgraph(12, 30, 5, seed=seed, device="cpu"))
    p = _port_params(jnq, "nequip", NQ, 5, seed=4)
    rot = jso3._rot_z(0.7) @ jso3._rot_y(-1.1) @ jso3._rot_x(0.3)
    e1 = tnq.energy(NQ, p, g, g.positions)
    g2 = _rotated(g, rot)
    e2 = tnq.energy(NQ, p, g2, g2.positions)
    assert float(e1.abs().max()) > 0.1
    torch.testing.assert_close(e1, e2, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_nequip_forces_rotation_equivariant(seed):
    g = _no_loops(tgraph(12, 30, 5, seed=seed, device="cpu"))
    p = _port_params(jnq, "nequip", NQ, 5, seed=5)
    rot = jso3._rot_y(0.9) @ jso3._rot_z(-0.4)
    _, f1 = tnq.energy_and_forces(NQ, p, g)
    _, f2 = tnq.energy_and_forces(NQ, p, _rotated(g, rot))
    assert float(f1.detach().abs().max()) > 0.01
    torch.testing.assert_close(f1 @ torch.as_tensor(rot.T, dtype=torch.float32),
                               f2, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_equiformer_energy_rotation_invariant(seed):
    cfg = jeq.EquiformerV2Config(n_layers=2, d_hidden=16, l_max=4, m_max=2,
                                 n_heads=4, edge_chunk=64)
    g = _no_loops(tgraph(10, 24, 6, seed=seed, device="cpu"))
    p = _port_params(jeq, "equiformer-v2", cfg, 6, seed=6)
    rot = jso3._rot_x(1.2) @ jso3._rot_z(0.5)
    e1 = teq.forward(cfg, p, g)
    e2 = teq.forward(cfg, p, _rotated(g, rot))
    assert float(e1.abs().max()) > 0.1
    torch.testing.assert_close(e1, e2, rtol=1e-4, atol=1e-5)


def test_nequip_translation_invariant():
    g = tgraph(12, 30, 5, device="cpu")
    p = _port_params(jnq, "nequip", NQ, 5, seed=7)
    e1 = tnq.energy(NQ, p, g, g.positions)
    e2 = tnq.energy(NQ, p, g, g.positions + torch.tensor([3.0, -1.0, 2.0]))
    assert float(e1.abs().max()) > 0.1
    torch.testing.assert_close(e1, e2, rtol=1e-5, atol=1e-6)


def test_edge_chunking_invariance():
    """Results must not depend on the edge_chunk size (pure perf knob)."""
    g = tgraph(12, 30, 5, device="cpu")
    p = _port_params(jnq, "nequip", NQ, 5, seed=8)
    outs = [tnq.energy(jnq.NequIPConfig(n_layers=2, d_hidden=8, edge_chunk=c),
                       p, g, g.positions) for c in (8, 30, 64)]
    assert float(outs[0].abs().max()) > 0.1
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(outs[0], outs[2], rtol=1e-5, atol=1e-6)
