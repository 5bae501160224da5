"""Port vs JAX package: streams, reservoir sample, partition plans, routing."""
from dataclasses import astuple

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import partitioning as jpart
from repro.core import routing as jroute
from repro.core import vertex_stats_from_sample as j_stats
from repro.streams import DATASETS as J_DATASETS
from repro.streams import make_stream as j_make_stream
from repro.streams import sample_stream as j_sample_stream
from repro_torch.core import partitioning as tpart
from repro_torch.core import routing as troute
from repro_torch.core import vertex_stats_from_sample as t_stats
from repro_torch.streams import DATASETS, make_stream, sample_stream


@pytest.mark.parametrize("name", sorted(J_DATASETS))
def test_stream_batches_byte_equal(name):
    assert astuple(DATASETS[name]) == astuple(J_DATASETS[name])
    ref = j_make_stream(name, batch_size=1024, seed=3, scale=0.02)
    port = make_stream(name, batch_size=1024, seed=3, scale=0.02)
    assert astuple(port.spec) == astuple(ref.spec)
    assert port.num_batches == ref.num_batches
    for i in (0, port.num_batches // 2, port.num_batches - 1):
        for a, b in zip(port.batch_numpy(i), ref.batch_numpy(i)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    tb = port.batch(0, device="cpu")
    jb = ref.batch(0)
    for f in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)))
    for a, b in zip(port.all_edges_numpy(), ref.all_edges_numpy()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k,seed", [(500, 1), (30_000, 4)])
def test_sample_stream_equal(k, seed):
    ref = j_make_stream("cit-HepPh", batch_size=2048, seed=1, scale=0.05)
    port = make_stream("cit-HepPh", batch_size=2048, seed=1, scale=0.05)
    for a, b in zip(sample_stream(port, k, seed=seed),
                    j_sample_stream(ref, k, seed=seed)):
        np.testing.assert_array_equal(a, b)


def _sample(seed=2):
    stream = make_stream("cit-HepPh", batch_size=4096, seed=seed, scale=0.1)
    return sample_stream(stream, 5000, seed=seed + 1)


@pytest.mark.parametrize("partitioner", ["banded", "greedy", "auto"])
@pytest.mark.parametrize("total_width", [60, 250])
def test_plan_for_equal(partitioner, total_width):
    s, d, w = _sample()
    jp = jpart.plan_for(partitioner, j_stats(s, d, w), total_width, square=True)
    tp = tpart.plan_for(partitioner, t_stats(s, d, w), total_width, square=True)
    assert tp.widths == jp.widths and tp.outlier == jp.outlier
    np.testing.assert_array_equal(tp.route_keys, jp.route_keys)
    np.testing.assert_array_equal(tp.route_part, jp.route_part)
    for a, b in zip(tp.partitions, jp.partitions):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        assert a.expected_error == b.expected_error
    assert tpart.good_turing_outlier_share(np.asarray(t_stats(s, d, w).freq)) \
        == jpart.good_turing_outlier_share(np.asarray(j_stats(s, d, w).freq))


@pytest.mark.parametrize("partitioner", ["banded", "greedy"])
def test_route_lookup_equal(partitioner):
    s, d, w = _sample()
    jp = jpart.plan_for(partitioner, j_stats(s, d, w), 200, square=True)
    tp = tpart.plan_for(partitioner, t_stats(s, d, w), 200, square=True)
    jt, jsize = jroute.route_table_from_plan(jp, square=True)
    tt, tsize = troute.route_table_from_plan(tp, square=True, device="cpu")
    assert tsize == jsize
    assert (tt.outlier, tt.n_partitions, tt.max_width) == \
        (jt.outlier, jt.n_partitions, jt.max_width)
    for f in ("keys", "part", "offsets", "widths"):
        got = getattr(tt, f)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jt, f)))
    rng = np.random.default_rng(0)
    # sampled ids, unseen ids, and ids past both ends of the key table
    v = np.concatenate([s[:2000], rng.integers(0, 10_000, 2000),
                        np.asarray([-5, 0, 2**31 - 1])]).astype(np.int32)
    got = tt.lookup(torch.as_tensor(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jt.lookup(jnp.asarray(v))))
    assert troute.routes_match(tt, tt)
    other, _ = troute.route_table_from_plan(
        tpart.plan_for(partitioner, t_stats(*_sample(seed=5)), 200,
                       square=True), square=True, device="cpu")
    assert not troute.routes_match(tt, other)


def test_route_lookup_empty_keys_routes_to_outlier():
    plan = tpart.PartitionPlan(
        partitions=(tpart.Partition(np.empty(0, np.int32), 8, 0.0),),
        route_keys=np.empty(0, np.int32), route_part=np.empty(0, np.int32),
        outlier=0)
    table, size = troute.route_table_from_plan(plan, square=True, device="cpu")
    assert size == 64
    got = table.lookup(torch.tensor([[1, 2], [3, -4]], dtype=torch.int32))
    assert got.shape == (2, 2) and got.dtype == torch.int32
    assert (got == 0).all()
