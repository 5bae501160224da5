"""The port's matrix_lookup (its plain version, the CPU path of the wrapper)
and the P = 1 bindings of the matrix sketches vs the JAX package's Pallas
kernels in interpret mode and their oracles."""
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
from repro_torch.core import EdgeBatch, MatrixSketch
from repro_torch.kernels import matrix_lookup, matrix_lookup_plain
from repro_torch.kernels.ops import accel_matrix_edge_freq, accel_matrix_ingest


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
