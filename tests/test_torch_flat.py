"""Port flat-pool kMatrix vs the JAX package's, and the interop format."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint.store import _flatten_with_paths
from repro.core import EdgeBatch as JBatch
from repro.core import KMatrix as JKMatrix
from repro.core import KMatrixAccel as JAccel
from repro.core import kmatrix as jkm
from repro.core import vertex_stats_from_sample as j_stats
from repro_torch import interop
from repro_torch.core import EdgeBatch, KMatrix
from repro_torch.core import kmatrix as tkm
from repro_torch.core import vertex_stats_from_sample as t_stats


def _random_stream(seed, n=4096, nodes=3000, turnstile=False):
    rng = np.random.default_rng(seed)
    src = rng.zipf(1.2, n).astype(np.int32) % nodes
    dst = rng.integers(0, nodes, n).astype(np.int32)
    w = rng.integers(-3 if turnstile else 1, 5, n).astype(np.int32)
    return src, dst, w


def _assert_same_state(port, ref):
    pl, ps = interop.export_state(port)
    rl, rs = interop.export_state(ref)
    assert ps == rs and sorted(pl) == sorted(rl)
    for k in rl:
        assert pl[k].dtype == rl[k].dtype, k
        np.testing.assert_array_equal(pl[k], rl[k], err_msg=k)


@pytest.mark.parametrize("kind", ["KMatrix", "KMatrixAccel"])
def test_export_keys_match_checkpoint_flattening(kind):
    src, dst, w = _random_stream(0)
    cls = {"KMatrix": JKMatrix, "KMatrixAccel": JAccel}[kind]
    ref = cls.create(bytes_budget=1 << 17, stats=j_stats(src, dst, w), depth=3)
    leaves, static = interop.export_state(ref)
    ckpt = _flatten_with_paths(ref)
    assert list(leaves) == list(ckpt)
    for k in ckpt:
        assert leaves[k].dtype == ckpt[k].dtype
        np.testing.assert_array_equal(leaves[k], ckpt[k])
    assert static["__type__"] == kind
    assert static[".route/.outlier"] == ref.route.outlier
    assert static[".conn_w"] == ref.conn_w
    port = interop.import_state(leaves, static, device="cpu")
    assert type(port).__name__ == kind
    assert port.hashes.a.dtype == torch.int64
    _assert_same_state(port, ref)
    back = interop.export_state(port)[0]
    assert list(back) == list(ckpt)


def test_import_rejects_malformed_state():
    src, dst, w = _random_stream(0)
    ref = JKMatrix.create(bytes_budget=1 << 16, stats=j_stats(src, dst, w),
                          depth=2)
    leaves, static = interop.export_state(ref)
    with pytest.raises(ValueError, match="unknown sketch type"):
        interop.import_state(leaves, {**static, "__type__": "CountMin"},
                             device="cpu")
    with pytest.raises(KeyError, match="conn"):
        interop.import_state({k: v for k, v in leaves.items() if k != ".conn"},
                             static, device="cpu")
    with pytest.raises(ValueError, match="unexpected"):
        interop.import_state({**leaves, ".pools/[0]": leaves[".pool"]},
                             static, device="cpu")
    with pytest.raises(KeyError, match="pool_size"):
        interop.import_state(leaves, {k: v for k, v in static.items()
                                      if k != ".pool_size"}, device="cpu")


@pytest.mark.parametrize("partitioner", ["banded", "greedy", "auto"])
def test_create_equals_reference(partitioner):
    src, dst, w = _random_stream(1)
    ref = JKMatrix.create(bytes_budget=200 * 1024, stats=j_stats(src, dst, w),
                          depth=5, seed=3, partitioner=partitioner)
    port = KMatrix.create(bytes_budget=200 * 1024, stats=t_stats(src, dst, w),
                          depth=5, seed=3, partitioner=partitioner,
                          device="cpu")
    _assert_same_state(port, ref)
    assert port.num_counters == ref.num_counters


@pytest.mark.parametrize("turnstile", [False, True])
def test_ingest_and_queries_equal_reference(turnstile):
    src, dst, w = _random_stream(2)
    ref = JKMatrix.create(bytes_budget=1 << 17, stats=j_stats(src, dst, w),
                          depth=4, seed=1)
    port = interop.import_state(*interop.export_state(ref), device="cpu")
    for seed in range(4):
        s, d, wt = _random_stream(10 + seed, turnstile=turnstile)
        ref = jkm.ingest(ref, JBatch.from_numpy(s, d, wt))
        out = tkm.ingest(port, EdgeBatch.from_numpy(s, d, wt, device="cpu"))
        assert out is port  # in place
    _assert_same_state(port, ref)
    rng = np.random.default_rng(4)
    qs = np.concatenate([s[:600], rng.integers(-10, 9000, 400)]).astype(np.int32)
    qd = np.concatenate([d[:600], rng.integers(0, 9000, 400)]).astype(np.int32)
    ts, td = torch.as_tensor(qs), torch.as_tensor(qd)
    js, jd = jnp.asarray(qs), jnp.asarray(qd)
    np.testing.assert_array_equal(tkm.edge_cells(port, ts, td).numpy(),
                                  np.asarray(jkm.edge_cells(ref, js, jd)))
    np.testing.assert_array_equal(tkm.edge_freq(port, ts, td).numpy(),
                                  np.asarray(jkm.edge_freq(ref, js, jd)))
    np.testing.assert_array_equal(tkm.node_out_freq(port, ts).numpy(),
                                  np.asarray(jkm.node_out_freq(ref, js)))
    # 2-D query shapes take the same path
    np.testing.assert_array_equal(
        tkm.edge_freq(port, ts.view(10, -1), td.view(10, -1)).numpy(),
        np.asarray(jkm.edge_freq(ref, js.reshape(10, -1), jd.reshape(10, -1))))


def test_empty_like_and_merge():
    src, dst, w = _random_stream(3)
    stats = t_stats(src, dst, w)
    a = KMatrix.create(bytes_budget=1 << 16, stats=stats, depth=3, seed=2,
                       device="cpu")
    tkm.ingest(a, EdgeBatch.from_numpy(src, dst, w, device="cpu"))
    e = tkm.empty_like(a)
    assert e.pool.data_ptr() != a.pool.data_ptr() and not e.pool.any()
    assert e.conn.data_ptr() != a.conn.data_ptr()
    tkm.ingest(e, EdgeBatch.from_numpy(src, dst, w, device="cpu"))
    m = tkm.merge(a, e)
    assert torch.equal(m.pool, 2 * a.pool) and torch.equal(m.conn, 2 * a.conn)
    with pytest.raises(ValueError, match="hash families"):
        tkm.merge(a, KMatrix.create(bytes_budget=1 << 16, stats=stats,
                                    depth=3, seed=9, device="cpu"))
    with pytest.raises(ValueError, match="partition plans"):
        tkm.merge(a, a.replace(route=a.route.replace(keys=a.route.keys + 1)))
    with pytest.raises(ValueError, match="layouts"):
        tkm.merge(a, KMatrix.create(bytes_budget=1 << 15, stats=stats,
                                    depth=3, seed=2, device="cpu"))
