"""Port vs JAX package: the paper's evaluation metrics (§V-C)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import metrics as jm
from repro_torch.core import metrics as tm


def _queries(seed=0, n=4000):
    rng = np.random.default_rng(seed)
    true = rng.integers(0, 50, n).astype(np.float64)
    est = (true + rng.integers(0, 20, n)).astype(np.int32)
    valid = rng.random(n) < 0.8
    return est, true, valid


@pytest.mark.parametrize("masked", [False, True])
def test_are_equal(masked):
    est, true, valid = _queries()
    jv = jnp.asarray(valid) if masked else None
    tv = torch.as_tensor(valid) if masked else None
    expect = float(jm.average_relative_error(jnp.asarray(est), jnp.asarray(true), jv))
    got = float(tm.average_relative_error(torch.as_tensor(est),
                                          torch.as_tensor(true), tv))
    assert abs(got - expect) <= 1e-6 * max(1.0, abs(expect))
    np.testing.assert_allclose(
        tm.relative_error(torch.as_tensor(est), torch.as_tensor(true)).numpy(),
        np.asarray(jm.relative_error(jnp.asarray(est), jnp.asarray(true))),
        rtol=1e-6)


@pytest.mark.parametrize("g0", [0.0, 5.0])
@pytest.mark.parametrize("masked", [False, True])
def test_neq_peq_equal(g0, masked):
    est, true, valid = _queries(1)
    jv = jnp.asarray(valid) if masked else None
    tv = torch.as_tensor(valid) if masked else None
    args_j = (jnp.asarray(est), jnp.asarray(true), g0, jv)
    args_t = (torch.as_tensor(est), torch.as_tensor(true), g0, tv)
    assert int(tm.effective_queries(*args_t)) == int(jm.effective_queries(*args_j))
    assert abs(float(tm.percent_effective_queries(*args_t))
               - float(jm.percent_effective_queries(*args_j))) <= 1e-4


def test_exact_frequencies_equal():
    rng = np.random.default_rng(2)
    src = rng.integers(-5, 300, 5000).astype(np.int32)
    dst = rng.integers(0, 300, 5000).astype(np.int32)
    w = rng.integers(1, 4, 5000).astype(np.int32)
    fm_t = tm.exact_edge_frequencies(src, dst, w)
    assert fm_t == jm.exact_edge_frequencies(src, dst, w)
    qs, qd = src[::7], dst[::-7]
    np.testing.assert_array_equal(tm.lookup_exact(fm_t, qs, qd),
                                  jm.lookup_exact(fm_t, qs, qd))
