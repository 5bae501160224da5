"""Port width-class kMatrix vs the JAX package's: ingest (pools, conn,
overflow), queries and relayout, started from one state via interop."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import EdgeBatch as JBatch
from repro.core import KMatrixAccel as JAccel
from repro.core import kmatrix as jkm
from repro.core import kmatrix_accel as jkma
from repro.core import vertex_stats_from_sample as j_stats
from repro_torch import interop
from repro_torch.core import EdgeBatch, KMatrixAccel
from repro_torch.core import kmatrix as tkm
from repro_torch.core import kmatrix_accel as tkma
from repro_torch.core import vertex_stats_from_sample as t_stats
from repro_torch.kernels import ops as tops


def _random_stream(seed, n=4096, nodes=2000, turnstile=False):
    rng = np.random.default_rng(seed)
    src = rng.zipf(1.3, n).astype(np.int32) % nodes
    dst = rng.integers(0, nodes, n).astype(np.int32)
    lo = -2 if turnstile else 1
    w = rng.integers(lo, 4, n).astype(np.int32)
    return src, dst, w


def _ref_accel(seed=5, depth=3, budget=1 << 16):
    src, dst, w = _random_stream(0)
    stats = j_stats(src[:1000], dst[:1000], w[:1000])
    return JAccel.create(bytes_budget=budget, stats=stats, depth=depth,
                         seed=seed)


def _port_of(ref):
    return interop.import_state(*interop.export_state(ref), device="cpu")


def _assert_same_state(port, ref):
    pl, ps = interop.export_state(port)
    rl, rs = interop.export_state(ref)
    assert ps == rs
    assert sorted(pl) == sorted(rl)
    for k in rl:
        assert pl[k].dtype == rl[k].dtype, k
        np.testing.assert_array_equal(pl[k], rl[k], err_msg=k)


def test_create_equals_reference():
    src, dst, w = _random_stream(0)
    for budget, depth in [(1 << 16, 3), (512 * 1024, 7)]:
        ref = JAccel.create(bytes_budget=budget, stats=j_stats(src, dst, w),
                            depth=depth, seed=2, partitioner="banded")
        port = KMatrixAccel.create(bytes_budget=budget,
                                   stats=t_stats(src, dst, w), depth=depth,
                                   seed=2, partitioner="banded", device="cpu")
        _assert_same_state(port, ref)
        for bs in (1024, 8192):
            assert tkma.dispatch_capacity(port, bs) == \
                jkma.dispatch_capacity(ref, bs)


@pytest.mark.parametrize("case", ["turnstile", "overflow"])
def test_ingest_equals_pallas_ingest(case):
    """One batch through the JAX package's Pallas ingest (interpret mode)
    and through the port: pools, conn and the overflow tally bit-equal.
    Turnstile: non-positive weights reach conn but not the pools, as in the
    reference's dispatch.  Overflow: a tiny capacity forces the tail
    through the exact scatter."""
    ref = _ref_accel()
    port = _port_of(ref)
    src, dst, w = _random_stream(7, n=1024, turnstile=case == "turnstile")
    capacity = 128 if case == "overflow" else None
    ref = jkma.ingest(ref, JBatch.from_numpy(src, dst, w), capacity=capacity)
    out = tkma.ingest(port, EdgeBatch.from_numpy(src, dst, w, device="cpu"),
                      capacity=capacity)
    assert out is port  # in place
    assert (int(ref.overflow) > 0) == (case == "overflow")
    _assert_same_state(out, ref)


@pytest.mark.parametrize("capacity", [None, 128, 256])
def test_stream_ingest_equals_reference_flat_twin(capacity):
    """Longer streams against the reference's flat twin, which its own tests
    hold bit-exact to its Pallas path for positive weights."""
    ref = _ref_accel(seed=3)
    port = _port_of(ref)
    twin = jkma.to_flat_layout(ref)
    over = 0
    for seed in (1, 2, 3, 4):
        src, dst, w = _random_stream(100 + seed)
        twin = jkm.ingest(twin, JBatch.from_numpy(src, dst, w))
        batch = EdgeBatch.from_numpy(src, dst, w, device="cpu")
        cap = capacity or tkma.dispatch_capacity(port, batch.size)
        over += int(tops.dispatch_rectangles(
            port, batch, -(-cap // 128) * 128).over.sum())
        port = tkma.ingest(port, batch, capacity=capacity)
    assert int(port.overflow) == over
    assert (over > 0) == (capacity is not None)
    flat = tkma.to_flat_layout(port)
    np.testing.assert_array_equal(flat.pool.numpy(), np.asarray(twin.pool))
    np.testing.assert_array_equal(flat.conn.numpy(), np.asarray(twin.conn))
    back = jkma.to_class_layout(twin, overflow=over)
    _assert_same_state(port, back.replace(load_shares=port.load_shares))


def test_queries_and_relayout_equal_reference():
    ref = _ref_accel(seed=4)
    src, dst, w = _random_stream(21)
    ref = jkma.ingest(ref, JBatch.from_numpy(src[:1024], dst[:1024], w[:1024]),
                      capacity=128)
    port = _port_of(ref)
    rng = np.random.default_rng(1)
    qs = np.concatenate([src[:700], rng.integers(0, 5000, 300)]).astype(np.int32)
    qd = np.concatenate([dst[:700], rng.integers(0, 5000, 300)]).astype(np.int32)
    ts, td = torch.as_tensor(qs), torch.as_tensor(qd)
    js, jd = jnp.asarray(qs), jnp.asarray(qd)
    np.testing.assert_array_equal(tkma.edge_freq(port, ts, td).numpy(),
                                  np.asarray(jkma.edge_freq(ref, js, jd)))
    np.testing.assert_array_equal(tkma.node_out_freq(port, ts).numpy(),
                                  np.asarray(jkma.node_out_freq(ref, js)))
    np.testing.assert_array_equal(tkma.conn_cells(port, ts).numpy(),
                                  np.asarray(jkma.conn_cells(ref, js)))
    # relayout: the port's flat twin equals the reference's, and the
    # round trip is the identity on every leaf (overflow tally included)
    flat = tkma.to_flat_layout(port)
    _assert_same_state(flat, jkma.to_flat_layout(ref))
    np.testing.assert_array_equal(tkm.edge_freq(flat, ts, td).numpy(),
                                  tkma.edge_freq(port, ts, td).numpy())
    np.testing.assert_array_equal(tkm.node_out_freq(flat, ts).numpy(),
                                  tkma.node_out_freq(port, ts).numpy())
    back = tkma.to_class_layout(flat)
    assert int(back.overflow) == int(port.overflow) > 0
    _assert_same_state(back.replace(load_shares=port.load_shares), ref)
    assert int(tkma.to_class_layout(flat, overflow=0).overflow) == 0
    flat.pool[0, 0] += 1  # fresh storage: the source is untouched
    assert not torch.equal(tkma.to_flat_layout(port).pool, flat.pool)


def test_to_class_layout_rejects_non_class_plans():
    src, dst, w = _random_stream(0)
    flat = tkm.KMatrix.create(bytes_budget=1 << 16, stats=t_stats(src, dst, w),
                              depth=2, device="cpu")
    assert any(x & (x - 1) for x in flat.route.widths.tolist())
    with pytest.raises(ValueError, match="powers"):
        tkma.to_class_layout(flat)


def test_empty_like_and_merge():
    ref = _ref_accel(seed=6)
    src, dst, w = _random_stream(8, n=1024)
    a = tkma.ingest(_port_of(ref), EdgeBatch.from_numpy(src, dst, w,
                                                        device="cpu"))
    e = tkma.empty_like(a)
    for pe, pa in zip(e.pools, a.pools):
        assert pe.data_ptr() != pa.data_ptr() and not pe.any()
    assert e.conn.data_ptr() != a.conn.data_ptr()
    before = interop.export_state(a)[0]
    tkma.ingest(e, EdgeBatch.from_numpy(src, dst, w, device="cpu"))
    after = interop.export_state(a)[0]
    assert all(np.array_equal(before[k], after[k]) for k in before)
    m = tkma.merge(a, e)
    for pm, pa in zip(m.pools, a.pools):
        assert torch.equal(pm, 2 * pa)
    assert torch.equal(m.conn, 2 * a.conn)
    with pytest.raises(ValueError, match="hash families"):
        tkma.merge(a, _port_of(_ref_accel(seed=7)))
    rerouted = a.replace(route=a.route.replace(keys=a.route.keys + 1))
    with pytest.raises(ValueError, match="partition plans"):
        tkma.merge(a, rerouted)
    with pytest.raises(ValueError, match="layouts"):
        tkma.merge(a, _port_of(_ref_accel(seed=6, depth=2)))


def test_sketch_backend_defaults_to_width_class():
    assert tkma.sketch_backend(None) == "width_class"
    assert tkma.sketch_backend("flat") == "flat"
    with pytest.raises(ValueError, match="sketch backend"):
        tkma.sketch_backend("pallas")
