"""Port kernels' plain versions (the CPU path of each wrapper) vs the JAX
package's Pallas kernels in interpret mode and their oracles."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import queries as jq
from repro.kernels import matrix_ingest as j_matrix_ingest
from repro.kernels import ref as jref
from repro.kernels import reach_step as j_reach_step
from repro.kernels.ops import accel_reach_closure as j_accel_reach_closure
from repro_torch.core import queries as tq
from repro_torch.kernels import matrix_ingest, matrix_ingest_plain, reach_step
from repro_torch.kernels.ops import accel_reach_closure


@pytest.mark.parametrize("d,p,w,c,block", [
    (1, 1, 8, 32, 32),
    (3, 1, 64, 128, 64),
    (2, 4, 16, 64, 32),
    (7, 3, 32, 256, 128),
])
def test_matrix_ingest_equals_pallas_and_ref(d, p, w, c, block):
    rng = np.random.default_rng(d * 100 + w)
    pool = rng.integers(-20, 50, (d, p, w, w)).astype(np.int32)
    hi = rng.integers(0, w, (d, p, c)).astype(np.int32)
    hj = rng.integers(0, w, (d, p, c)).astype(np.int32)
    wt = rng.integers(-2, 4, (p, c)).astype(np.int32)
    wt[:, c // 2:] = 0  # padding slots, as the dispatch leaves them
    args = [jnp.asarray(x) for x in (pool, hi, hj, wt)]
    expect = np.asarray(j_matrix_ingest(*args, block_b=block, interpret=True))
    np.testing.assert_array_equal(
        expect, np.asarray(jref.matrix_ingest_ref(*args)))
    port_pool = torch.as_tensor(pool.copy())
    out = matrix_ingest(port_pool, *(torch.as_tensor(x) for x in (hi, hj, wt)))
    assert out is port_pool  # in place
    np.testing.assert_array_equal(out.numpy(), expect)


def test_matrix_ingest_drops_out_of_range_slots():
    """Slots outside [0, w) are dropped, as the one-hot kernel drops them."""
    rng = np.random.default_rng(1)
    d, p, w, c = 2, 2, 16, 64
    pool = np.zeros((d, p, w, w), np.int32)
    hi = rng.integers(-3, w + 3, (d, p, c)).astype(np.int32)
    hj = rng.integers(-3, w + 3, (d, p, c)).astype(np.int32)
    wt = rng.integers(1, 3, (p, c)).astype(np.int32)
    expect = np.asarray(j_matrix_ingest(
        *(jnp.asarray(x) for x in (pool, hi, hj, wt)), block_b=32,
        interpret=True))
    got = matrix_ingest_plain(*(torch.as_tensor(x) for x in (pool, hi, hj, wt)))
    np.testing.assert_array_equal(got.numpy(), expect)


def test_matrix_ingest_rejects_bad_inputs():
    pool = torch.zeros((2, 1, 8, 8), dtype=torch.int32)
    hi = torch.zeros((2, 1, 16), dtype=torch.int32)
    wt = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        matrix_ingest(pool, hi.long(), hi, wt)
    with pytest.raises(ValueError):
        matrix_ingest(pool, hi, hi, wt[:, :8])
    with pytest.raises(ValueError):
        matrix_ingest(pool, hi[:, :, ::2], hi[:, :, ::2], wt[:, ::2])


@pytest.mark.parametrize("w,block,density", [(64, 32, 0.02), (256, 128, 0.01),
                                             (128, 64, 0.3)])
def test_reach_step_equals_pallas(w, block, density):
    rng = np.random.default_rng(w)
    layers = (rng.random((3, w, w)) < density).astype(np.float32)
    got = reach_step(torch.as_tensor(layers))
    for layer, out in zip(layers, got.numpy()):
        expect = np.asarray(j_reach_step(jnp.asarray(layer), block=block,
                                         interpret=True))
        np.testing.assert_array_equal(out, expect)
        np.testing.assert_array_equal(
            out, np.asarray(jref.reach_step_ref(jnp.asarray(layer))))


@pytest.mark.parametrize("w", [43, 64, 100])
def test_accel_reach_closure_equals_pallas(w):
    """The port masks the ragged edge; the JAX package pads to its block
    and crops — the closures are equal."""
    rng = np.random.default_rng(w)
    table = rng.integers(0, 3, (2, w, w)).astype(np.int32) \
        * (rng.random((2, w, w)) < 0.03)
    expect = np.asarray(j_accel_reach_closure(jnp.asarray(table), block=32))
    got = accel_reach_closure(torch.as_tensor(table))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("max_hops", [None, 1, 2, 5])
@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_build_closure_equals_reference_backends(max_hops, backend):
    rng = np.random.default_rng(9)
    w = 43
    table = (rng.integers(0, 3, (3, w, w)) * (rng.random((3, w, w)) < 0.04)
             ).astype(np.int32)
    got = tq.build_closure(torch.as_tensor(table), max_hops,
                           backend=backend).numpy()
    for ref_backend in ("pallas", "jnp"):
        expect = np.asarray(jq.build_closure(jnp.asarray(table), max_hops,
                                             backend=ref_backend))
        np.testing.assert_array_equal(got, expect)


def test_closure_steps_and_backend_resolution():
    for w in (1, 2, 3, 43, 64, 65, 1024):
        for hops in (None, 1, 3, 8):
            assert tq._closure_steps(w, hops) == jq._closure_steps(w, hops)
    assert tq._closure_steps(43, None) == 6
    assert tq.closure_backend(None) == "kernel"
    assert tq.closure_backend("plain") == "plain"
    with pytest.raises(ValueError, match="closure backend"):
        tq.closure_backend("pallas")
