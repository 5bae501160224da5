"""The port's matrix_lookup (its plain version, the CPU path of the wrapper)
and the P = 1 bindings of the matrix sketches vs the JAX package's Pallas
kernels in interpret mode and their oracles; the width-class kMatrix's
query wrappers (``kmatrix_lookup_edges``, ``kmatrix_node_out``) on the CPU
against the flat twin, their input checks, and the engine over them."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import EdgeBatch as JBatch
from repro.core import MatrixSketch as JMatrix
from repro.core import matrix_sketch as jms
from repro.kernels import matrix_lookup as j_matrix_lookup
from repro.kernels import ref as jref
from repro.kernels.ops import accel_matrix_edge_freq as j_accel_edge_freq
from repro.kernels.ops import accel_matrix_ingest as j_accel_ingest
from _kmatrix_classes import STRUCTURES, class_sketch, query_ids
from repro_torch.core import EdgeBatch, MatrixSketch
from repro_torch.core import kmatrix as tkm
from repro_torch.core import kmatrix_accel as tkma
from repro_torch.kernels import (
    kmatrix_lookup_edges,
    kmatrix_lookup_edges_plain,
    kmatrix_node_out,
    kmatrix_node_out_plain,
    matrix_lookup,
    matrix_lookup_plain,
)
from repro_torch.kernels.ops import accel_matrix_edge_freq, accel_matrix_ingest
from repro_torch.serving import QueryEngine, SketchRegistry, WorkloadMix, gates
from repro_torch.serving import engine as eng
from repro_torch.serving import synth_requests


def _inputs(d, p, w, c, seed):
    rng = np.random.default_rng(seed)
    pool = rng.integers(-50, 100, (d, p, w, w)).astype(np.int32)
    hi = rng.integers(0, w, (d, p, c)).astype(np.int32)
    hj = rng.integers(0, w, (d, p, c)).astype(np.int32)
    return pool, hi, hj


# the shapes of tests/test_kernels.py::test_matrix_lookup_matches_ref
@pytest.mark.parametrize("d,p,w,c,block", [
    (1, 1, 8, 32, 32),
    (4, 1, 64, 128, 64),
    (3, 2, 32, 64, 32),
])
def test_matrix_lookup_equals_pallas_and_ref(d, p, w, c, block):
    pool, hi, hj = _inputs(d, p, w, c, w + c)
    jargs = [jnp.asarray(x) for x in (pool, hi, hj)]
    expect = np.asarray(j_matrix_lookup(*jargs, block_q=block, interpret=True))
    np.testing.assert_array_equal(
        expect, np.asarray(jref.matrix_lookup_ref(*jargs)))
    targs = [torch.as_tensor(x) for x in (pool, hi, hj)]
    got = matrix_lookup(*targs)
    assert got.dtype == torch.int32 and got.shape == (p, c)
    np.testing.assert_array_equal(got.numpy(), expect)
    np.testing.assert_array_equal(matrix_lookup_plain(*targs).numpy(), expect)


@pytest.mark.parametrize("d,p,w,c", [(3, 1, 136, 1000), (2, 3, 16, 45),
                                     (7, 1, 5, 1)])
def test_matrix_lookup_any_query_count_equals_ref(d, p, w, c):
    """C need not be a multiple of any block: the port masks the ragged
    edge where the JAX package pads."""
    pool, hi, hj = _inputs(d, p, w, c, c)
    expect = np.asarray(jref.matrix_lookup_ref(
        *(jnp.asarray(x) for x in (pool, hi, hj))))
    got = matrix_lookup(*(torch.as_tensor(x) for x in (pool, hi, hj)))
    np.testing.assert_array_equal(got.numpy(), expect)


def test_matrix_lookup_rejects_bad_inputs():
    matrix_lookup.launches = 0
    pool = torch.zeros((2, 1, 8, 8), dtype=torch.int32)
    hi = torch.zeros((2, 1, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        matrix_lookup(pool, hi.long(), hi)
    with pytest.raises(TypeError):
        matrix_lookup(pool.float(), hi, hi)
    with pytest.raises(ValueError, match="hi/hj must be"):
        matrix_lookup(pool, hi, hi[:, :, :8])
    with pytest.raises(ValueError, match="hi/hj must be"):
        matrix_lookup(pool, hi[:1], hi[:1])
    with pytest.raises(ValueError, match="contiguous"):
        matrix_lookup(pool, hi[:, :, ::2], hi[:, :, ::2])
    with pytest.raises(ValueError, match="pool must be"):
        matrix_lookup(pool[:0], hi[:0], hi[:0])
    for bad in (-1, 8):
        oob = hi.clone()
        oob[1, 0, 3] = bad
        with pytest.raises(ValueError, match=r"\[0, 8\)"):
            matrix_lookup(pool, hi, oob)
    assert matrix_lookup.launches == 0


def _jax_and_port_sketch(seed=3, depth=3, budget=40_000):
    return (JMatrix.create(bytes_budget=budget, depth=depth, seed=seed),
            MatrixSketch.create(bytes_budget=budget, depth=depth, seed=seed,
                                device="cpu"))


@pytest.mark.parametrize("n", [256, 1000])
def test_accel_matrix_ingest_and_edge_freq_equal_jax(n):
    """The JAX bindings pad the batch and the queries to their blocks
    (``_pad_edges``); the port's take any count and return exactly C."""
    matrix_lookup.launches = 0
    rng = np.random.default_rng(n)
    src = rng.integers(0, 500, n).astype(np.int32)
    dst = rng.integers(0, 500, n).astype(np.int32)
    w = rng.integers(-2, 4, n).astype(np.int32)
    jsk, tsk = _jax_and_port_sketch()
    table = tsk.table
    for _ in range(2):
        jsk = j_accel_ingest(jsk, JBatch.from_numpy(src, dst, w))
        assert accel_matrix_ingest(
            tsk, EdgeBatch.from_numpy(src, dst, w, device="cpu")) is tsk
    assert tsk.table is table  # updated in place
    np.testing.assert_array_equal(tsk.table.numpy(), np.asarray(jsk.table))
    # the core scatter ingest of the JAX package agrees with its kernel
    core = jms.ingest(jms.ingest(_jax_and_port_sketch()[0],
                                 JBatch.from_numpy(src, dst, w)),
                      JBatch.from_numpy(src, dst, w))
    np.testing.assert_array_equal(np.asarray(core.table), np.asarray(jsk.table))
    qs, qd = src[: n - 7], dst[: n - 7]
    expect = np.asarray(j_accel_edge_freq(jsk, jnp.asarray(qs), jnp.asarray(qd)))
    got = accel_matrix_edge_freq(tsk, torch.as_tensor(qs), torch.as_tensor(qd))
    assert got.shape == (n - 7,)
    np.testing.assert_array_equal(got.numpy(), expect)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jms.edge_freq(jsk, jnp.asarray(qs),
                                              jnp.asarray(qd))))
    assert matrix_lookup.launches == 0


def test_port_is_exact_above_2_24_where_pallas_rounds():
    """The Pallas kernel reads cells through a float32 product, exact only
    below 2^24; the port's gather is exact at any count.  Below 2^24 the
    two agree (every other test here), above it they part."""
    pool = np.full((2, 1, 8, 8), (1 << 24) + 1, np.int32)
    pool[1] += 2
    hi = np.zeros((2, 1, 32), np.int32)
    pallas = np.asarray(j_matrix_lookup(*(jnp.asarray(x) for x in (pool, hi, hi)),
                                        block_q=32, interpret=True))
    assert (pallas == 1 << 24).all()
    got = matrix_lookup(*(torch.as_tensor(x) for x in (pool, hi, hi)))
    assert (got.numpy() == (1 << 24) + 1).all()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.matrix_lookup_ref(
        *(jnp.asarray(x) for x in (pool, hi, hi)))))


def _routed(sk):
    return dict(route=sk.route, part_class=sk.part_class,
                part_index=sk.part_index)


@pytest.mark.parametrize("near_2_31", [False, True],
                         ids=["small", "near_2_31"])
@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_kmatrix_lookups_on_cpu_equal_the_flat_twin(structure, near_2_31):
    """The CPU dispatch of both kMatrix query wrappers (their plain
    versions) on random sketches of each class structure equals the flat
    twin's ``kmatrix.edge_freq`` / ``node_out_freq``: routed, unseen,
    negative and zero ids, 2-D shapes, row sums that wrap; no launch."""
    kmatrix_lookup_edges.launches = kmatrix_node_out.launches = 0
    sk = class_sketch(structure, depth=3, seed=len(structure),
                      near_2_31=near_2_31)
    flat = tkma.to_flat_layout(sk)
    src = query_ids(sk, 330, 1).view(33, 10)
    dst = query_ids(sk, 330, 2).view(33, 10)
    est = tkma.edge_freq(sk, src, dst)
    assert est.shape == (33, 10) and est.dtype == torch.int32
    assert torch.equal(est, tkm.edge_freq(flat, src, dst))
    assert torch.equal(est, tkma.edge_freq(sk, src.long(), dst.long()))
    out = tkma.node_out_freq(sk, src)
    assert out.shape == (33, 10) and out.dtype == torch.int32
    assert torch.equal(out, tkm.node_out_freq(flat, src))
    flat_src, flat_dst = src.reshape(-1), dst.reshape(-1)
    assert torch.equal(kmatrix_lookup_edges_plain(
        sk.pools, sk.hashes.a, sk.hashes.b, flat_src, flat_dst, **_routed(sk)),
        est.reshape(-1))
    assert torch.equal(kmatrix_node_out(
        sk.pools, sk.hashes.a, sk.hashes.b, flat_src, **_routed(sk)),
        out.reshape(-1))
    if near_2_31:  # the int32 row sums wrapped
        assert bool((out < 0).any())
    assert kmatrix_lookup_edges.launches == kmatrix_node_out.launches == 0


@pytest.mark.parametrize("wrapper", [kmatrix_lookup_edges, kmatrix_node_out],
                         ids=lambda f: f.__name__)
def test_kmatrix_lookups_refuse_bad_inputs(wrapper):
    kmatrix_lookup_edges.launches = kmatrix_node_out.launches = 0
    sk = class_sketch("cell", depth=3, seed=5)
    ids = query_ids(sk, 64, 3)
    n_ids = 2 if wrapper is kmatrix_lookup_edges else 1

    def call(pools=sk.pools, a=sk.hashes.a, b=sk.hashes.b, ids=(ids,) * 2,
             **kw):
        return wrapper(pools, a, b, *ids[:n_ids], **{**_routed(sk), **kw})

    assert call().shape == (64,)
    with pytest.raises(TypeError, match="ids must be torch.int32"):
        call(ids=(ids.long(),) * 2)
    with pytest.raises(TypeError, match="a must be"):
        call(a=sk.hashes.a.int())
    with pytest.raises(TypeError, match=r"pools\[1\] must be"):
        call(pools=(sk.pools[0], sk.pools[1].long(), sk.pools[2]))
    with pytest.raises(TypeError, match="part_class must be"):
        call(part_class=sk.part_class.long())
    with pytest.raises(ValueError, match=r"ids must be \[n\]"):
        call(ids=(ids.view(8, 8),) * 2)
    with pytest.raises(ValueError, match="contiguous"):
        call(ids=(ids[::2],) * 2)
    with pytest.raises(ValueError, match="1 to 16"):
        call(pools=(sk.pools[0],) * 17)
    with pytest.raises(ValueError, match="1 to 16"):
        call(pools=())
    with pytest.raises(ValueError, match="power of two"):
        call(pools=(sk.pools[0][:, :, :12, :12].contiguous(),))
    with pytest.raises(ValueError, match="power of two"):
        call(pools=(sk.pools[0][:, :, :8].contiguous(),))
    with pytest.raises(ValueError, match=r"pools must be \[3,"):
        call(pools=(sk.pools[0][:2].contiguous(),))
    with pytest.raises(ValueError, match="outlier"):
        call(route=sk.route.replace(outlier=sk.part_class.shape[0]))
    with pytest.raises(ValueError, match="ids is on meta, pools on cpu"):
        call(ids=(ids.to("meta"),) * 2)
    meta = tuple(p.to("meta") for p in sk.pools)
    with pytest.raises(ValueError, match="cuda or cpu"):
        call(pools=meta, a=sk.hashes.a.to("meta"), b=sk.hashes.b.to("meta"),
             ids=(ids.to("meta"),) * 2,
             route=sk.route.replace(keys=sk.route.keys.to("meta"),
                                    part=sk.route.part.to("meta")),
             part_class=sk.part_class.to("meta"),
             part_index=sk.part_index.to("meta"))
    if wrapper is kmatrix_lookup_edges:
        with pytest.raises(ValueError, match=r"ids must be \[n\]"):
            call(ids=(ids, ids[:63]))
    assert kmatrix_lookup_edges.launches == kmatrix_node_out.launches == 0


def test_engine_on_a_cpu_kmatrix_snapshot_equals_direct_for_the_cells_mix():
    """``QueryEngine.execute`` on a CPU width-class kMatrix snapshot at the
    serving cell's budget and depth, under its mix (the loadgen's default:
    paths of 4, subgraphs of 3 edges, heavy sweeps of 16,384 ids, which the
    engine takes in chunks of 4,096), equals ``direct_answers``."""
    kmatrix_lookup_edges.launches = kmatrix_node_out.launches = 0
    tenant = SketchRegistry(depth=7, batch_size=4096, scale=0.03,
                            device="cpu").open("cit-HepPh", "kmatrix", 512)
    tenant.step(2)
    snap = tenant.publish()
    reqs = synth_requests(256, WorkloadMix(), n_nodes=tenant.stream.spec.n_nodes,
                          seed=7, heavy_universe=16384)
    assert {r.family for r in reqs} == set(eng.FAMILIES) - {eng.NODE_IN}
    got = [r.value for r in QueryEngine().execute(snap, reqs)]
    assert gates.mismatched_indices(got, eng.direct_answers(snap, reqs)) == []
    assert kmatrix_lookup_edges.launches == kmatrix_node_out.launches == 0
