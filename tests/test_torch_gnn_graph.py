"""The GNN family's primitives against the JAX package: the graph ops, the
generators, the SO(3) helpers and ``chunked_edge_aggregate``.

Tolerances: the scatter ops add the same float32 values in edge order on
the CPU, so their sums agree to a few ulps of the sums' magnitudes (rtol
1e-6, atol 1e-6 at |x| ~ 1-10); the SH evaluator and the rotations run the
same float32 formulas (atol 1e-6 on unit-scale values, 2e-5 after three
rotations of l <= 4 features, whose products sum ~50 terms).  The
generators are numpy on both sides and must be equal element for element.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import shapes as jshapes
from repro.models.gnn import chunked as jchunked
from repro.models.gnn import graph as jgraph
from repro.models.gnn import sampler as jsampler
from repro.models.gnn import so3 as jso3
from repro_torch.configs import shapes as tshapes
from repro_torch.models.gnn import chunked as tchunked
from repro_torch.models.gnn import graph as tgraph
from repro_torch.models.gnn import sampler as tsampler
from repro_torch.models.gnn import so3 as tso3


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(a, b, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), b.detach().cpu().numpy(),
                               rtol=rtol, atol=atol)


def _edges(seed, n=16, e=48, h=3):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(e, h)).astype(np.float32) * 3
    dst = rng.integers(0, n - 2, e).astype(np.int32)  # nodes n-2, n-1: empty
    mask = (rng.random(e) > 0.3).astype(np.float32)
    return vals, dst, mask, n


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_ops_match_jax(seed):
    vals, dst, mask, n = _edges(seed)
    _close(jgraph.scatter_sum(vals, dst, n), tgraph.scatter_sum(_t(vals), _t(dst), n))
    _close(jgraph.scatter_mean(vals, dst, n, mask),
           tgraph.scatter_mean(_t(vals), _t(dst), n, _t(mask)))
    _close(jgraph.scatter_mean(vals, dst, n), tgraph.scatter_mean(_t(vals), _t(dst), n))
    mx = tgraph.scatter_max(_t(vals), _t(dst), n)
    ref = np.asarray(jgraph.scatter_max(vals, dst, n))
    assert np.isneginf(ref[-2:]).all() and torch.isneginf(mx[-2:]).all()
    np.testing.assert_array_equal(ref, mx.numpy())  # a max rounds nothing
    idx = np.asarray([3, 0, 3, 15], np.int32)
    np.testing.assert_array_equal(np.asarray(jgraph.gather(vals, idx)),
                                  tgraph.gather(_t(vals), _t(idx)).numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_edge_softmax_with_an_empty_segment_matches_jax(masked):
    vals, dst, mask, n = _edges(2)
    # node 0: every incoming edge masked out when masked
    mask = np.where(dst == 0, 0.0, mask).astype(np.float32)
    args = (mask,) if masked else ()
    ref = jgraph.edge_softmax(vals, dst, n, *args)
    out = tgraph.edge_softmax(_t(vals), _t(dst), n, *map(_t, args))
    _close(ref, out)
    assert torch.isfinite(out).all()
    sums = tgraph.scatter_sum(out, _t(dst), n)
    live = np.unique(dst[mask > 0] if masked else dst)
    np.testing.assert_allclose(sums[live].numpy(), 1.0, rtol=1e-5)
    assert float(sums[-2:].abs().max()) == 0.0


def test_edge_softmax_gradient_matches_jax():
    vals, dst, mask, n = _edges(3)
    w = np.random.default_rng(4).normal(size=vals.shape).astype(np.float32)
    g_ref = jax.grad(lambda s: jnp.sum(jgraph.edge_softmax(s, dst, n, mask) * w))(
        jnp.asarray(vals))
    s = _t(vals).requires_grad_(True)
    (tgraph.edge_softmax(s, _t(dst), n, _t(mask)) * _t(w)).sum().backward()
    _close(g_ref, s.grad, atol=1e-6)


def test_graph_readout_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(20, 4)).astype(np.float32)
    gid = np.repeat(np.arange(4, dtype=np.int32), 5)
    nmask = (rng.random(20) > 0.2).astype(np.float32)
    _close(jgraph.graph_readout(x, gid, 5, nmask),
           tgraph.graph_readout(_t(x), _t(gid), 5, _t(nmask)))


@pytest.mark.parametrize("args", [(24, 64, 13, 1), (30, 64, 16, 4),
                                  (10, 24, 5, 3), (2_708, 10_556, 7, 1)])
def test_synthetic_graph_equals_jax_element_for_element(args):
    n, e, d, n_graphs = args
    ref = jgraph.synthetic_graph(n, e, d, seed=3, n_graphs=n_graphs)
    out = tgraph.synthetic_graph(n, e, d, seed=3, n_graphs=n_graphs,
                                 device="cpu")
    assert out.n_graphs == ref.n_graphs and out.n_nodes == ref.n_nodes
    assert out.n_edges == ref.n_edges
    for f in ("node_feat", "edge_src", "edge_dst", "edge_feat", "positions",
              "node_mask", "edge_mask", "graph_id"):
        a, b = np.asarray(getattr(ref, f)), getattr(out, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_graph_batch_to_and_replace():
    g = tgraph.synthetic_graph(6, 10, 3, device="cpu")
    h = g.replace(positions=g.positions + 1)
    assert torch.equal(h.positions, g.positions + 1) and h.edge_src is g.edge_src
    moved = g.to("meta")
    assert moved.node_feat.device.type == "meta" and moved.n_graphs == 1
    assert moved.edge_src.dtype == torch.int32


def test_sampler_equals_jax_bit_for_bit():
    ref_csr = jsampler.random_regular_csr(5_000, avg_degree=20, seed=0)
    csr = tsampler.random_regular_csr(5_000, avg_degree=20, seed=0)
    np.testing.assert_array_equal(ref_csr.indptr, csr.indptr)
    np.testing.assert_array_equal(ref_csr.indices, csr.indices)
    seeds = np.arange(64, dtype=np.int64)
    ref = jsampler.sample_subgraph(ref_csr, seeds, (15, 10), seed=1)
    out = tsampler.sample_subgraph(csr, seeds, (15, 10), seed=1)
    for a, b in zip(ref, out):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    a, b = (jsampler.CSRGraph.from_edges(src, dst, 50),
            tsampler.CSRGraph.from_edges(src, dst, 50))
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)


def test_gnn_shapes_equal_jax():
    assert {k: vars(v) for k, v in tshapes.GNN_SHAPES.items()} == {
        k: vars(v) for k, v in jshapes.GNN_SHAPES.items()}
    for name, shape in tshapes.GNN_SHAPES.items():
        if shape.kind == "sampled":
            assert tshapes.sampled_subgraph_sizes(shape) == \
                jshapes.sampled_subgraph_sizes(jshapes.GNN_SHAPES[name]) == \
                (169_984, 168_960)


@pytest.mark.parametrize("l_max", [2, 4, 6])
def test_real_sph_harm_matches_jax(l_max):
    rng = np.random.default_rng(l_max)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v[0] = (0, 0, 1)
    v[1] = (0, 0, -1)  # the poles
    v[2] = 0  # a zero-length edge's direction
    _close(jso3.real_sph_harm(jnp.asarray(v), l_max),
           tso3.real_sph_harm(_t(v), l_max), atol=2e-6)
    np.testing.assert_array_equal(jso3.real_sph_harm(v.astype(np.float64), l_max, xp=np),
                                  tso3.real_sph_harm(v.astype(np.float64), l_max, xp=np))


def test_build_time_tensors_equal_jax():
    for l1, l2, l3 in [(0, 0, 0), (1, 1, 2), (2, 2, 2), (2, 1, 1), (3, 2, 1)]:
        np.testing.assert_array_equal(jso3.gaunt_tensor(l1, l2, l3),
                                      tso3.gaunt_tensor(l1, l2, l3))
    for l_max in (2, 6):
        np.testing.assert_array_equal(jso3.j_matrix_big(l_max),
                                      tso3.j_matrix_big(l_max))
        np.testing.assert_array_equal(jso3.m_array(l_max), tso3.m_array(l_max))
        np.testing.assert_array_equal(jso3.flip_index(l_max),
                                      tso3.flip_index(l_max))


@pytest.mark.parametrize("inverse", [False, True])
def test_rotate_to_edge_frame_matches_jax(inverse):
    l_max = 4
    rng = np.random.default_rng(7)
    x = rng.normal(size=(40, 5, tso3.n_comps(l_max))).astype(np.float32)
    vec = rng.normal(size=(40, 1, 3)).astype(np.float32)
    vec[0] = 0  # a self-loop
    vec[1] = (0, 0, 2.5)  # along z
    ref = jso3.rotate_to_edge_frame(jnp.asarray(x), jnp.asarray(vec),
                                    l_max=l_max, inverse=inverse)
    _close(ref, tso3.rotate_to_edge_frame(_t(x), _t(vec), l_max=l_max,
                                          inverse=inverse), atol=2e-5)
    # in the frame, the edge direction's own SH is the z-axis's
    v = vec[2:, 0] / np.linalg.norm(vec[2:, 0], axis=-1, keepdims=True)
    y = tso3.real_sph_harm(_t(v), l_max)
    rot = tso3.rotate_to_edge_frame(y, _t(vec[2:, 0]), l_max=l_max)
    pole = tso3.real_sph_harm(torch.tensor([0.0, 0.0, 1.0]), l_max)
    torch.testing.assert_close(rot, pole.expand_as(rot), rtol=0, atol=2e-5)


# ------------------------------------------------- chunked_edge_aggregate --

def _setup(seed, n=16, e=48, d=8):
    rng = np.random.default_rng(seed)
    return {"h": rng.normal(size=(n, d)).astype(np.float32),
            "w": rng.normal(size=(d, d)).astype(np.float32),
            "ew": rng.normal(size=(e, d)).astype(np.float32),
            "src": rng.integers(0, n, e).astype(np.int32),
            "dst": rng.integers(0, n, e).astype(np.int32), "n": n}


def _jmsg(carry, es, ie):
    h_, w_ = carry
    return jnp.tanh(h_[ie["src"]] @ w_) * es["ew"]


def _tmsg(carry, es, ie):
    h_, w_ = carry
    return torch.tanh(h_[ie["src"]] @ w_) * es["ew"]


@pytest.mark.parametrize("n_chunks", [1, 2, 4, 8])
def test_chunked_matches_unchunked_and_jax(n_chunks):
    """Value and gradients equal the unchunked sum (the port's plain version,
    the same adds in the same order: rtol 1e-6) and JAX's chunked function
    (float32 tanh and products: rtol 1e-5, atol 1e-6, as tests/test_chunked.py
    holds JAX's)."""
    s = _setup(0)
    n, src, dst = s["n"], jnp.asarray(s["src"]), jnp.asarray(s["dst"])

    def jloss(h_, w_, ew_):
        agg = jchunked.chunked_edge_aggregate(_jmsg, n, n_chunks, (h_, w_),
                                              {"ew": ew_}, {"src": src}, dst)
        return jnp.sum(agg ** 2)

    v_ref, g_ref = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(s[k]) for k in ("h", "w", "ew")))
    outs = {}
    for chunked in (True, False):
        leaves = [_t(s[k]).requires_grad_(True) for k in ("h", "w", "ew")]
        args = ((leaves[0], leaves[1]), {"ew": leaves[2]},
                {"src": _t(s["src"])}, _t(s["dst"]))
        agg = (tchunked.chunked_edge_aggregate(_tmsg, n, n_chunks, *args)
               if chunked else tchunked.aggregate_unchunked(_tmsg, n, *args))
        loss = (agg ** 2).sum()
        outs[chunked] = (loss, torch.autograd.grad(loss, leaves))
    (v1, g1), (v2, g2) = outs[True], outs[False]
    torch.testing.assert_close(v1, v2, rtol=1e-6, atol=0)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(v_ref), float(v1.detach()), rtol=1e-5)
    for a, b in zip(g_ref, g1):
        _close(a, b, rtol=1e-4, atol=1e-5)


def test_chunked_stacks_and_takes_no_gradient_for_ints():
    """Two layers compose (gradient flows through both, equal to the
    unchunked composition); nothing needing no gradient gets one."""
    s = _setup(3)
    n, src, dst = s["n"], _t(s["src"]), _t(s["dst"])
    ew = _t(s["ew"])  # needs no gradient
    outs = []
    for agg_fn in (lambda *a: tchunked.chunked_edge_aggregate(_tmsg, n, 4, *a),
                   lambda *a: tchunked.aggregate_unchunked(_tmsg, n, *a)):
        h, w = (_t(s[k]).requires_grad_(True) for k in ("h", "w"))
        a1 = agg_fn((h, w), {"ew": ew}, {"src": src}, dst)
        a2 = agg_fn((a1, w), {"ew": ew}, {"src": src}, dst)
        outs.append(torch.autograd.grad(a2.abs().sum(), (h, w)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert float(outs[0][0].abs().sum()) > 0 and ew.grad is None


@pytest.mark.parametrize("n_chunks", [1, 3])
def test_chunked_backward_is_differentiable(n_chunks):
    """Grad-of-grad: a loss on d(sum agg^2)/dh (create_graph) differentiates
    through the chunked backward as through the unchunked one, and as JAX's
    custom_vjp does."""
    s = _setup(5, e=48)
    n, src, dst = s["n"], jnp.asarray(s["src"]), jnp.asarray(s["dst"])

    def jouter(h_, w_, ew_):
        def inner(hh):
            agg = jchunked.chunked_edge_aggregate(
                _jmsg, n, n_chunks, (hh, w_), {"ew": ew_}, {"src": src}, dst)
            return jnp.sum(agg ** 2)
        return jnp.sum(jax.grad(inner)(h_) ** 2)

    g_ref = jax.grad(jouter, argnums=(0, 1, 2))(
        *(jnp.asarray(s[k]) for k in ("h", "w", "ew")))
    outs = []
    for chunked in (True, False):
        h, w, ew = (_t(s[k]).requires_grad_(True) for k in ("h", "w", "ew"))
        args = ((h, w), {"ew": ew}, {"src": _t(s["src"])}, _t(s["dst"]))
        agg = (tchunked.chunked_edge_aggregate(_tmsg, n, n_chunks, *args)
               if chunked else tchunked.aggregate_unchunked(_tmsg, n, *args))
        (dh,) = torch.autograd.grad((agg ** 2).sum(), h, create_graph=True)
        outs.append(torch.autograd.grad((dh ** 2).sum(), (h, w, ew)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
    for a, b in zip(g_ref, outs[0]):
        scale = float(np.abs(np.asarray(a)).max())
        _close(a, b, rtol=1e-4, atol=1e-5 * scale)
