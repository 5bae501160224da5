"""The port's sharded serving against the JAX package's: ``ShardPlan``
routing bits, shard stream views batch for batch, merged-vs-single-sketch
exactness, the scatter/gather engine for all five sketch kinds, the closure
cache keyed on the epoch vector, cross-shard conservation under the
runtime, sharded crash and resume, and the shard manifest.  CPU, small
sizes, every wait bounded."""
import dataclasses
import json
import os
import time

import numpy as np
import pytest

from repro.core.partitioning import ShardPlan as JPlan
from repro.runtime import Runtime as JRuntime
from repro.serving import ShardedQueryEngine as JShardedEngine
from repro.serving import ShardStreamView as JView
from repro.serving import QueryEngine as JEngine
from repro.serving import SketchRegistry as JRegistry
from repro.serving import attach_shards as jattach
from repro.serving import engine as jeng
from repro.serving import sharded_conservation as jconservation
from repro.serving import warm_ingest_shapes as jwarm
from repro.serving import write_shard_manifest as jwrite_manifest
from repro_torch import interop
from repro_torch.core.partitioning import ShardPlan
from repro_torch.runtime import Runtime
from repro_torch.serving import (
    QueryEngine,
    ShardedQueryEngine,
    ShardStreamView,
    SketchRegistry,
    attach_shards,
    gates,
    measure_sharded_ingest,
    mix_for_sketch,
    read_shard_manifest,
    sharded_conservation,
    sharded_direct_answers,
    synth_requests,
    warm_ingest_shapes,
    write_shard_manifest,
)
from repro_torch.serving import engine as eng

SMALL = dict(depth=3, batch_size=1024, scale=0.02)
# port kind -> (registry kind, JAX backend, port backend)
KINDS = {"kmatrix": ("kmatrix", "pallas", "width_class"),
         "countmin": ("countmin", "flat", "flat"),
         "gsketch": ("gsketch", "flat", "flat"),
         "tcm": ("tcm", "flat", "flat"),
         "gmatrix": ("gmatrix", "flat", "flat")}
WAIT_S = 60.0


def _wait(cond, timeout_s=WAIT_S, poll_s=0.005):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() >= deadline:
            raise TimeoutError("condition not met in time")
        time.sleep(poll_s)


def _registry(backend="width_class"):
    return SketchRegistry(**SMALL, sketch_backend=backend, device="cpu")


def _sharded(kind="kmatrix", n_shards=3, seed=0, shard_seed=0):
    """The same sharded tenant in both packages."""
    name, jb, tb = KINDS[kind]
    return (JRegistry(**SMALL, sketch_backend=jb).open_sharded(
                "cit-HepPh", name, 64, seed=seed, n_shards=n_shards,
                shard_seed=shard_seed),
            _registry(tb).open_sharded(
                "cit-HepPh", name, 64, seed=seed, n_shards=n_shards,
                shard_seed=shard_seed))


def _assert_same_sketch(port, ref):
    pl, ps = interop.export_state(port)
    rl, rs = interop.export_state(ref)
    assert ps == rs and sorted(pl) == sorted(rl)
    for k in rl:
        np.testing.assert_array_equal(pl[k], rl[k], err_msg=k)


def _single_replay(kind="kmatrix"):
    """Oracle: the whole stream ingested once into one unsharded sketch."""
    name, _, tb = KINDS[kind]
    t = _registry(tb).open("cit-HepPh", name, 64)
    return t, gates.replay_sketch(t.mod, t.mod.empty_like(t.snapshot.sketch),
                                  t.stream, t.stream.num_batches)


# ----------------------------------------------------------------- routing
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
def test_shard_plan_bits_equal_jax(k, seed):
    rng = np.random.default_rng(k * 10 + seed)
    v = np.concatenate([
        rng.integers(-(1 << 40), 1 << 40, 20_000),  # wraps as uint32
        rng.integers(-(1 << 31), 0, 5_000),  # negative ids
        rng.integers(1 << 31, 1 << 32, 5_000),  # ids >= 2^31
        np.arange(-5, 5)]).astype(np.int64)
    got, want = ShardPlan(k, seed=seed).shard_of(v), JPlan(k, seed=seed).shard_of(v)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() < k
    if k > 1:
        assert (np.bincount(got, minlength=k) > 0).all()
    plan, jplan = ShardPlan(k, seed=seed), JPlan(k, seed=seed)
    for x in (-1, -(1 << 31), (1 << 31) + 7, 12345):
        assert plan.shard_of_one(x) == jplan.shard_of_one(x) == int(
            plan.shard_of(np.asarray([x], np.int64))[0])


def test_shard_plan_refuses_zero_shards_and_reseeds():
    with pytest.raises(ValueError, match="n_shards"):
        ShardPlan(0)
    v = np.arange(10_000)
    assert not np.array_equal(ShardPlan(4, seed=3).shard_of(v),
                              ShardPlan(4, seed=4).shard_of(v))


def test_shard_views_equal_jax_batch_for_batch_and_partition_the_stream():
    jst, st = _sharded("gmatrix", n_shards=3)
    stream = st.stream
    total = 0
    for i in range(stream.num_batches):
        live = 0
        for s in range(3):
            got = st.shards[s].stream.batch_numpy(i)
            want = jst.shards[s].stream.batch_numpy(i)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype == np.int32
                np.testing.assert_array_equal(a, b)
            view = st.shards[s].stream
            assert len(got[0]) % view.granule == 0
            own = got[2] > 0
            assert (view.plan.shard_of(got[0][own]) == s).all()
            live += int(own.sum())
        assert live == int((stream.batch_numpy(i)[2] > 0).sum())
        total += live
    assert total == stream.spec.n_edges
    view = ShardStreamView(stream, ShardPlan(2), 1)
    jview = JView(stream, JPlan(2), 1)
    assert (view.granule, view.num_batches) == (jview.granule,
                                                jview.num_batches)
    with pytest.raises(ValueError, match="out of range"):
        ShardStreamView(stream, ShardPlan(2), 2)


def test_turnstile_deletions_are_dropped_by_shard_views_as_in_jax():
    """A shard view keeps only weight > 0 (the JAX package's behaviour,
    mirrored): a deletion an unsharded ingest applies is not routed."""

    class Turnstile:
        batch_size, num_batches, spec = 8, 1, None

        @staticmethod
        def batch_numpy(i):
            return (np.arange(8, dtype=np.int32), np.arange(8, dtype=np.int32),
                    np.array([1, -1, 2, 0, -3, 1, 1, 1], np.int32))

    base = Turnstile()
    got = [ShardStreamView(base, ShardPlan(2), s, min_bucket=8).batch_numpy(0)
           for s in range(2)]
    want = [JView(base, JPlan(2), s, min_bucket=8).batch_numpy(0)
            for s in range(2)]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert sum(int((g[2] < 0).sum()) for g in got) == 0
    assert sum(int(g[2].sum()) for g in got) == 6


# ------------------------------------------------- merged == single sketch
@pytest.mark.parametrize("kind", ["kmatrix", "gmatrix"])
def test_sharded_merge_equals_single_sketch_replay(kind):
    _, st = _sharded(kind)
    st.step(st.stream.num_batches)
    snap = st.publish()
    assert snap.n_edges == st.stream.spec.n_edges
    merged = st.merged_snapshot()
    _, oracle = _single_replay(kind)
    assert gates.layout_counters_equal(merged.sketch, oracle)
    assert merged.epoch == max(snap.epochs)


def test_open_sharded_is_idempotent_and_shards_share_layout():
    reg = _registry()
    a = reg.open_sharded("cit-HepPh", "kmatrix", 64, seed=0, n_shards=2)
    assert reg.open_sharded("cit-HepPh", "kmatrix", 64, seed=0,
                            n_shards=2) is a
    assert reg.open_sharded("cit-HepPh", "kmatrix", 64, seed=0, n_shards=2,
                            shard_seed=1) is not a
    sk0, sk1 = (s.snapshot.sketch for s in a.shards)
    leaves0, static0 = interop.export_state(sk0)
    leaves1, static1 = interop.export_state(sk1)
    assert static0 == static1
    for key in leaves0:
        if not key.startswith((".pools", ".conn", ".overflow")):
            np.testing.assert_array_equal(leaves0[key], leaves1[key])
    ids = [s.key.tenant_id for s in a.shards]
    assert ids == ["cit-HepPh/kmatrix/64kb/s0/shard0of2",
                   "cit-HepPh/kmatrix/64kb/s0/shard1of2"]
    assert [s.key.seed for s in a.shards] == [0, 0x9E3779B1]
    assert all(s.device.type == "cpu" for s in a.shards)
    # a shard's origin rebuilds that shard, with the same layout
    again = a.shards[1].origin.rebuild()
    assert again is not a.shards[1] and again.key == a.shards[1].key
    _assert_same_sketch(again.snapshot.sketch, sk1)
    assert dataclasses.asdict(a.shards[1].origin)["shard_index"] == 1


# --------------------------------------------------------- engine == oracle
def _requests(kind, n_nodes, n=96, seed=5):
    reqs = synth_requests(n, mix_for_sketch(KINDS[kind][0]), n_nodes=n_nodes,
                          seed=seed, heavy_universe=512, heavy_threshold=5.0)
    if kind in ("tcm", "gmatrix"):  # the kinds that answer node_in
        reqs += [eng.node_in(v) for v in range(0, n_nodes, 97)]
    if kind not in ("countmin", "gsketch"):
        reqs.append(eng.reach(1, 2, max_hops=2))
    return reqs


@pytest.mark.parametrize("kind", list(KINDS))
def test_sharded_engine_equals_direct_and_jax(kind):
    jst, st = _sharded(kind, n_shards=2)
    st.step(3), jst.step(3)
    snap, jsnap = st.publish(), jst.publish()
    for part, jpart in zip(snap.parts, jsnap.parts):
        _assert_same_sketch(part.sketch, jpart.sketch)
    reqs = _requests(kind, st.stream.spec.n_nodes)
    engine = ShardedQueryEngine(QueryEngine(min_bucket=8))
    results = engine.execute(snap, reqs)
    got = [r.value for r in results]
    assert gates.mismatched_indices(got, sharded_direct_answers(snap, reqs)) \
        == []
    jgot = [r.value for r in JShardedEngine(JEngine(min_bucket=8)).execute(
        jsnap, [jeng.Request(**dataclasses.asdict(r)) for r in reqs])]
    assert gates.mismatched_indices(got, jgot) == []
    assert {r.epoch for r in results} == {snap.epochs}
    heavy = [v for r, v in zip(reqs, got) if r.family == eng.HEAVY_NODES]
    assert all(len(v[0]) for v in heavy)


def test_sharded_reach_closure_cache_keys_on_epoch_vector():
    _, st = _sharded("kmatrix", n_shards=2)
    st.step(2)
    snap = st.publish()
    engine = ShardedQueryEngine(QueryEngine(min_bucket=8))
    reqs = [eng.reach(1, 9), eng.reach(4, 2)]
    engine.execute(snap, reqs)
    assert engine.closures.misses == 1
    engine.execute(snap, reqs)
    assert engine.closures.hits >= 1
    # ONE shard publishing invalidates (new epoch vector -> new key)
    st.shards[0].step(1)
    st.shards[0].publish()
    engine.execute(st.snapshot, reqs)
    assert engine.closures.misses == 2
    assert engine.stats["sharded_closure_misses"] == 2
    # the cached closure is the merged one: equal to the single sketch's
    st.step(st.stream.num_batches)
    snap = st.publish()
    single, oracle = _single_replay()
    from repro_torch.core import queries
    assert np.array_equal(
        engine._closure(snap, None).numpy(),
        queries.build_closure(queries.closure_layers(oracle)).numpy())


# ------------------------------------------------------- runtime + restore
def test_sharded_runtime_drain_conserves_and_publishes_as_jax():
    jst, st = _sharded("gmatrix")
    kw = dict(queue_capacity=4, publish_policy="every:2", reservoir_k=0,
              poll_s=0.01)
    rt, jrt = Runtime(**kw), JRuntime(**kw)
    handles, jhandles = attach_shards(rt, st), jattach(jrt, jst)
    for r in (rt, jrt):
        r.start()
        assert r.join_pumps(WAIT_S)
        r.stop(drain=True, timeout=WAIT_S)
    cons = sharded_conservation(handles, st.stream.spec.n_edges)
    jcons = jconservation(jhandles, jst.stream.spec.n_edges)
    assert cons == jcons and cons["conservation_ok"]
    assert cons["dropped_edges"] == 0
    assert sum(cons["per_shard_published"]) == st.stream.spec.n_edges
    _, oracle = _single_replay("gmatrix")
    assert gates.layout_counters_equal(st.merged_snapshot().sketch, oracle)
    _assert_same_sketch(st.merged_snapshot().sketch,
                        jst.merged_snapshot().sketch)


def test_measure_sharded_ingest_conserves():
    _, st = _sharded("kmatrix", n_shards=2)
    out = measure_sharded_ingest(st)
    assert out["conserved"] and out["backend"] == "thread"
    assert out["queued_edges"] == out["ingested_edges"] == \
        st.stream.spec.n_edges
    assert out["worker_states"] == ["stopped", "stopped"]
    _, oracle = _single_replay()
    assert gates.layout_counters_equal(st.merged_snapshot().sketch, oracle)


def test_warm_ingest_shapes_leaves_counters_and_counts_as_jax():
    jst, st = _sharded("gmatrix", n_shards=2)
    assert warm_ingest_shapes(st) == jwarm(jst)
    assert st.epochs == jst.epochs == (1, 1)
    assert st.snapshot.n_edges == 0
    assert all(int(s.snapshot.sketch.table.abs().sum()) == 0
               for s in st.shards)


def _crash_at_offsets(ckpt, offsets, registry_backend="width_class"):
    """Shards driven to different offsets from pre-filled queues (no pump,
    no timing), one checkpoint after each batch, then killed."""
    reg = _registry(registry_backend)
    st = reg.open_sharded("cit-HepPh", "kmatrix", 64, n_shards=len(offsets))
    rt = Runtime(queue_capacity=8, publish_policy="every:2", reservoir_k=0,
                 checkpoint_dir=ckpt, checkpoint_every=1, poll_s=0.01)
    handles = attach_shards(rt, st)
    rt.start(pumps=False)
    from repro_torch.runtime import QueueItem
    for h, n in zip(handles, offsets):
        for i in range(n):
            assert h.queue.put(QueueItem.from_arrays(
                i, *h.tenant.stream.batch_numpy(i)), timeout=5)
    for h, n in zip(handles, offsets):
        _wait(lambda: h.worker.metrics.checkpoints >= n)
    rt.kill()
    assert [s.offset for s in st.shards] == list(offsets)
    assert not any(h.worker.is_alive() for h in handles)
    return st


def test_sharded_crash_resume_conserves_and_serves_exactly(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _crash_at_offsets(ckpt, (1, 3, 5))
    manifest = read_shard_manifest(ckpt)
    assert manifest["n_shards"] == 3 and manifest["runtime_backend"] == \
        "thread"
    st = _registry().open_sharded("cit-HepPh", "kmatrix", 64,
                                  n_shards=manifest["n_shards"],
                                  shard_seed=manifest["shard_seed"])
    rt = Runtime(queue_capacity=4, publish_policy="every:2", reservoir_k=0,
                 checkpoint_dir=ckpt, poll_s=0.01)
    handles = attach_shards(rt, st, restore=True)
    assert [s.offset for s in st.shards] == [1, 3, 5]
    rt.start()
    assert rt.join_pumps(WAIT_S)
    rt.stop(drain=True, timeout=WAIT_S)
    cons = sharded_conservation(handles, st.stream.spec.n_edges)
    assert all(u == 0 for u in cons["per_shard_unaccounted"]), cons
    merged = st.merged_snapshot()
    _, oracle = _single_replay()
    assert gates.layout_counters_equal(merged.sketch, oracle)
    assert merged.n_edges == st.stream.spec.n_edges
    snap = st.snapshot
    reqs = _requests("kmatrix", st.stream.spec.n_nodes, n=32, seed=11)
    got = [r.value for r in ShardedQueryEngine(QueryEngine(min_bucket=8))
           .execute(snap, reqs)]
    assert gates.mismatched_indices(
        got, sharded_direct_answers(snap, reqs)) == []


def test_manifest_json_equals_jax_and_bad_manifests_are_refused(tmp_path):
    jst, st = _sharded("kmatrix", n_shards=2, shard_seed=5)
    write_shard_manifest(str(tmp_path / "port"), st)
    jwrite_manifest(str(tmp_path / "jax"), jst)
    port = (tmp_path / "port" / "shard_manifest.json").read_text()
    assert port == (tmp_path / "jax" / "shard_manifest.json").read_text()
    assert read_shard_manifest(str(tmp_path / "jax")) == json.loads(port)
    path = tmp_path / "port" / "shard_manifest.json"
    path.write_text(port[: len(port) // 2])
    with pytest.raises(ValueError, match="truncated or corrupt"):
        read_shard_manifest(str(tmp_path / "port"))
    path.write_text(json.dumps({"n_shards": 2}))
    with pytest.raises(ValueError, match="missing required keys"):
        read_shard_manifest(str(tmp_path / "port"))
    with pytest.raises(FileNotFoundError, match="no shard manifest"):
        read_shard_manifest(str(tmp_path / "nowhere"))


@pytest.mark.parametrize("n_shards,shard_seed", [(3, 0), (2, 1)])
def test_attach_shards_rejects_a_mismatched_manifest(tmp_path, n_shards,
                                                     shard_seed):
    ckpt = str(tmp_path / "ckpt")
    st = _registry("flat").open_sharded("cit-HepPh", "kmatrix", 64,
                                        n_shards=2)
    rt = Runtime(queue_capacity=4, publish_policy="every:2", reservoir_k=0,
                 checkpoint_dir=ckpt, checkpoint_every=1, poll_s=0.01)
    attach_shards(rt, st, max_batches=1)
    rt.start()
    assert rt.join_pumps(WAIT_S)
    rt.stop(drain=True, timeout=WAIT_S)
    assert sorted(os.listdir(ckpt))[-1] == "shard_manifest.json"
    other = _registry("flat").open_sharded("cit-HepPh", "kmatrix", 64,
                                           n_shards=n_shards,
                                           shard_seed=shard_seed)
    rt2 = Runtime(queue_capacity=4, reservoir_k=0, checkpoint_dir=ckpt,
                  poll_s=0.01)
    with pytest.raises(ValueError, match="manifest"):
        attach_shards(rt2, other, restore=True)
