"""Port vs JAX package: hash families, fastrange and the core types."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.common import hashing as jh
from repro.core import types as jtypes
from repro_torch.common import hashing as th
from repro_torch.core import types as ttypes

WIDTHS = (1, 7, 64, 2**31 - 1)


def _ids(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "random":
        return rng.integers(0, 2**31 - 1, 4096).astype(np.int32)
    if kind == "sequential":
        return np.arange(4096, dtype=np.int32)
    # negative ids map through astype(uint32), as the JAX package's do
    return np.concatenate([
        rng.integers(-2**31, 0, 4000).astype(np.int32),
        np.asarray([-1, -2**31, 0, 2**31 - 1], np.int32)])


@pytest.mark.parametrize("depth", [1, 3, 7])
@pytest.mark.parametrize("kind", ["random", "sequential", "negative"])
def test_mix_equals_reference(depth, kind):
    x = _ids(kind)
    ref = jh.HashFamily.create(11, depth)
    port = th.HashFamily.create(11, depth, device="cpu")
    expect = np.asarray(ref.mix(jnp.asarray(x)))
    got = port.mix(torch.as_tensor(x)).numpy()
    assert got.dtype == np.int64 and got.min() >= 0
    np.testing.assert_array_equal(got.astype(np.uint32), expect)
    np.testing.assert_array_equal(got, expect.astype(np.int64))


@pytest.mark.parametrize("depth", [1, 3, 7])
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("kind", ["random", "sequential", "negative"])
def test_hash_into_equals_numpy_oracle(depth, w, kind):
    """hash_into and fastrange equal np_hash_into (exact 64-bit product),
    and the JAX package's hash_into wherever its 16-bit limb product does
    not overflow uint32 (every w < 2^16, which covers all sketch widths)."""
    x = _ids(kind)
    a, b = jh.sample_hash_params(5, depth)
    port = th.HashFamily.create(5, depth, device="cpu")
    oracle = jh.np_hash_into(a, b, x, w)
    got = port.hash_into(torch.as_tensor(x), w).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(
        th.fastrange(port.mix(torch.as_tensor(x)), w).numpy(), oracle)
    np.testing.assert_array_equal(th.np_hash_into(a, b, x, w), oracle)
    if w < 2**16:
        ref = jh.HashFamily.create(5, depth)
        np.testing.assert_array_equal(
            got, np.asarray(ref.hash_into(jnp.asarray(x), w)))


def test_fastrange_tensor_widths_match_reference():
    """Per-element widths (the flat kMatrix's partition widths)."""
    rng = np.random.default_rng(3)
    h = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    w = rng.integers(1, 4096, 5000).astype(np.int32)
    expect = np.asarray(jh.fastrange(jnp.asarray(h), jnp.asarray(w)))
    got = th.fastrange(torch.as_tensor(h.astype(np.int64)), torch.as_tensor(w))
    np.testing.assert_array_equal(got.numpy(), expect)


def test_sample_params_and_families_match():
    for seed, d in [(0, 1), (3, 7)]:
        for x, y in zip(jh.sample_hash_params(seed, d),
                        th.sample_hash_params(seed, d)):
            np.testing.assert_array_equal(x, y)
    a = th.HashFamily.create(1, 3, device="cpu")
    assert th.families_match(a, th.HashFamily.create(1, 3, device="cpu"))
    assert not th.families_match(a, th.HashFamily.create(2, 3, device="cpu"))
    assert not th.families_match(a, th.HashFamily.create(1, 4, device="cpu"))


def test_edge_batch_and_vertex_stats_equal_reference():
    rng = np.random.default_rng(0)
    src = rng.zipf(1.3, 3000).astype(np.int32) % 500
    dst = rng.integers(0, 500, 3000).astype(np.int32)
    w = rng.integers(1, 4, 3000).astype(np.int32)
    jb = jtypes.EdgeBatch.from_numpy(src, dst, w)
    tb = ttypes.EdgeBatch.from_numpy(src, dst, w, device="cpu")
    for name in ("src", "dst", "weight"):
        t = getattr(tb, name)
        assert t.dtype == torch.int32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jb, name)))
    assert tb.size == jb.size
    ones = ttypes.EdgeBatch.from_numpy(src, dst, device="cpu")
    assert int(ones.weight.sum()) == len(src)
    js = jtypes.vertex_stats_from_sample(src, dst, w)
    ts = ttypes.vertex_stats_from_sample(src, dst, w)
    for name in ("vertex", "freq", "deg"):
        t = getattr(ts, name)
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(js, name)))
        assert t.dtype == {"vertex": torch.int32}.get(name, torch.float32)
