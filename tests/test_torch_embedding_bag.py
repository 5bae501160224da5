"""The port's embedding_bag (its plain version, the CPU path of the wrapper)
vs the JAX package's Pallas kernel in interpret mode and its oracle."""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag as j_embedding_bag
from repro_torch.kernels import embedding_bag, embedding_bag_plain
from repro_torch.kernels import build, ops

# the module, which the package shadows with its wrapper of the same name
eb = importlib.import_module("repro_torch.kernels.embedding_bag")


def _inputs(v, d, b, f, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(0, v, (b, f)).astype(np.int32)
    wts = rng.normal(size=(b, f)).astype(np.float32)
    return table, idx, wts


@pytest.mark.parametrize("weighted", [False, True], ids=["sum", "weighted"])
@pytest.mark.parametrize("f", [2, 39])
@pytest.mark.parametrize("d", [1, 10, 128])
def test_plain_is_bit_equal_to_pallas(d, f, weighted):
    """Both sum f in order with one rounding per step (the weighted step a
    fused multiply-add), so they agree bit for bit."""
    table, idx, wts = _inputs(1000, d, 16, f, d * 100 + f)
    jw = jnp.asarray(wts) if weighted else None
    expect = np.asarray(j_embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                        jw, interpret=True))
    tw = torch.as_tensor(wts) if weighted else None
    args = (torch.as_tensor(table), torch.as_tensor(idx), tw)
    plain = embedding_bag_plain(*args)
    got = embedding_bag(*args)
    assert got.dtype == torch.float32 and got.shape == (16, d)
    np.testing.assert_array_equal(plain.numpy(), expect)
    np.testing.assert_array_equal(got.numpy(), expect)
    # the oracle sums as a tree: a few ulps apart on the long (F = 39)
    # bags, the tolerance of tests/test_kernels.py::test_embedding_bag_*
    oracle = np.asarray(jref.embedding_bag_ref(jnp.asarray(table),
                                               jnp.asarray(idx), jw))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)


def test_weighted_step_rounds_once_where_float64_rounds_twice():
    """acc + row * w with acc = row = 1 + 2^-23, w = 2^-24 (1 - 2^-23): the
    exact value lies just below a float32 midpoint, its float64 rounding
    on it.  A single rounding (Pallas, fmaf) gives 1 + 2^-23; rounding the
    float64 sum again gives 1 + 2^-22."""
    one_ulp = np.float32(1 + 2**-23)
    table = np.array([[one_ulp]], np.float32)
    idx = np.zeros((1, 2), np.int32)
    wts = np.array([[1.0, 2**-24 * (1 - 2**-23)]], np.float32)
    expect = np.asarray(j_embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                        jnp.asarray(wts), interpret=True))
    assert expect[0, 0] == one_ulp
    twice = np.float32(np.float64(one_ulp) + np.float64(one_ulp)
                       * np.float64(wts[0, 1]))
    assert twice != one_ulp
    got = embedding_bag(*(torch.as_tensor(x) for x in (table, idx, wts)))
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("b,f", [(0, 3), (4, 0), (1, 1)])
def test_empty_and_single_bags(b, f):
    table, idx, wts = _inputs(7, 3, b, f, 1)
    got = embedding_bag(torch.as_tensor(table), torch.as_tensor(idx))
    expect = table[idx].sum(axis=1) if f else np.zeros((b, 3), np.float32)
    assert got.shape == (b, 3)
    np.testing.assert_array_equal(got.numpy(), expect)


@pytest.mark.parametrize("bad", [-1, 50])
def test_cpu_range_check_raises(bad):
    table, idx, _ = _inputs(50, 4, 3, 5, 2)
    idx[1, 2] = bad
    embedding_bag.launches = 0
    with pytest.raises(ValueError, match=r"idx must lie in \[0, 50\)"):
        embedding_bag(torch.as_tensor(table), torch.as_tensor(idx))
    assert embedding_bag.launches == 0


def test_rejects_bad_inputs():
    table, idx, wts = (torch.as_tensor(x) for x in _inputs(20, 4, 3, 5, 3))
    with pytest.raises(TypeError, match="int32"):
        embedding_bag(table, idx.long())
    with pytest.raises(TypeError, match="float32"):
        embedding_bag(table.double(), idx)
    with pytest.raises(TypeError, match="weights must be float32"):
        embedding_bag(table, idx, wts.double())
    with pytest.raises(ValueError, match="weights must be"):
        embedding_bag(table, idx, wts[:, :2].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table.t().contiguous().t(), idx)
    with pytest.raises(ValueError, match=r"table must be \[V, D >= 1\]"):
        embedding_bag(table[:, :0], idx)
    with pytest.raises(ValueError, match=r"idx must be \[B, F\]"):
        embedding_bag(table, idx[0])
    with pytest.raises(NotImplementedError, match="no backward"):
        embedding_bag(table.requires_grad_(), idx)
    with torch.no_grad():
        assert embedding_bag(table, idx).shape == (3, 4)


def test_launch_counter_stays_zero_on_cpu_and_ops_reexports():
    assert ops.embedding_bag is embedding_bag
    embedding_bag.launches = 0
    table, idx, wts = (torch.as_tensor(x) for x in _inputs(30, 10, 8, 39, 4))
    embedding_bag(table, idx)
    embedding_bag(table, idx, wts)
    assert embedding_bag.launches == 0


@pytest.mark.parametrize("d,ptr,vec", [
    (1, 256, 1), (10, 256, 2), (10, 260, 1), (16, 256, 4), (16, 264, 2),
    (16, 260, 1), (128, 4096, 4), (3, 256, 1), (2, 8, 2)])
def test_bag_plan_vector_width_from_d_and_alignment(d, ptr, vec):
    """The widest of float4, float2, float that divides D and the table's
    alignment; any D and any 4-byte alignment keep the scalar path."""
    assert eb.bag_plan(512, 39, d, ptr, False)[0] == vec


@pytest.mark.parametrize("b,d", [(1, 10), (512, 1), (512, 10), (262_144, 1),
                                 (262_144, 10), (1_000_000, 10), (3, 1000),
                                 (7, 4096)])
def test_bag_plan_spreads_bags_over_the_card(b, d):
    vec, nb, threads, _, _ = eb.bag_plan(b, 39, d, 256, False)
    per_bag = d // vec
    assert threads % 32 == 0 and 32 <= threads <= eb.THREADS
    assert nb * per_bag <= max(eb.THREADS, per_bag)  # one pass, or one bag
    # a large batch fills its blocks; a small one takes the fewest bags a
    # block that still keep to one block per SM, so it spreads over them
    if nb < max(1, eb.THREADS // per_bag):
        assert -(-b // nb) <= build.SMS
        assert nb == 1 or -(-b // (nb - 1)) > build.SMS


@pytest.mark.parametrize("weighted", [False, True], ids=["sum", "weighted"])
@pytest.mark.parametrize("b,f,d", [(512, 39, 1), (262_144, 39, 1),
                                   (262_144, 64, 1), (40_000, 200, 1),
                                   (1000, 5000, 10), (5, 0, 3), (5, 1, 3),
                                   (262_144, 39, 10)])
def test_bag_plan_staging_fits_shared_memory(b, f, d, weighted):
    """Indices (and weights) of a block's bags are staged at an odd stride,
    in one chunk where they fit 48,000 bytes, else in chunks that do."""
    _, nb, _, fc, fs = eb.bag_plan(b, f, d, 256, weighted)
    words = 2 if weighted else 1
    assert fs % 2 == 1 and fs >= fc >= 1
    assert nb * fs * words <= eb.STAGE_WORDS
    if nb * (f | 1) * words <= eb.STAGE_WORDS:
        assert fc == max(f, 1)
    else:
        assert fc < f and nb * (fc + 2) * words > eb.STAGE_WORDS - nb * words
