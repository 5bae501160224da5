"""The port's serving tier against the JAX package's: registry, snapshot
buffers, the batched query engine, gates, the open-loop load generator and
the snapshot state carried across through interop.  The same streams and
requests go through both packages (the width-class kMatrix in the JAX
package's Pallas layout, in interpret mode); answers and counters must be
bit-equal.  Then the port's own hazards: its ingest writes in place, so no
published front may ever be written again."""
import dataclasses
import sys
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import EdgeBatch as JBatch
from repro.core import KMatrix as JKMatrix
from repro.core import kmatrix as jkm
from repro.core import vertex_stats_from_sample as j_stats
from repro.obs import hub as jhub
from repro.serving import QueryEngine as JEngine
from repro.serving import SketchRegistry as JRegistry
from repro.serving import SnapshotBuffer as JBuffer
from repro.serving import TenantKey as JKey
from repro.serving import engine as jeng
from repro.serving import gates as jgates
from repro.serving import loadgen as jload
from repro.serving.snapshot import StaleDelta as JStale
from repro_torch import interop
from repro_torch.core import EdgeBatch, KMatrix, MatrixSketch
from repro_torch.core import countmin, gsketch, kmatrix, kmatrix_accel, matrix_sketch
from repro_torch.core import vertex_stats_from_sample as t_stats
from repro_torch.obs import hub as thub
from repro_torch.serving import (
    OpenLoopLoadGen,
    QueryEngine,
    SketchRegistry,
    SnapshotBuffer,
    TenantKey,
    WorkloadMix,
    mix_for_sketch,
    synth_requests,
)
from repro_torch.serving import engine as eng
from repro_torch.serving import gates
from repro_torch.serving.registry import build_sketch
from repro_torch.serving.snapshot import DONE, StaleDelta, private_copy

SMALL = dict(depth=3, batch_size=1024, scale=0.02)
# sketch kinds as the port names them -> (registry kind, JAX backend, port
# backend); the width-class kMatrix is JAX's Pallas layout
KINDS = {
    "countmin": ("countmin", "flat", "flat"),
    "gsketch": ("gsketch", "flat", "flat"),
    "tcm": ("tcm", "flat", "flat"),
    "gmatrix": ("gmatrix", "flat", "flat"),
    "kmatrix": ("kmatrix", "pallas", "width_class"),
    "kmatrix-flat": ("kmatrix", "flat", "flat"),
}


@pytest.fixture(scope="module")
def registries():
    return ({b: JRegistry(**SMALL, sketch_backend=b) for b in ("flat", "pallas")},
            {b: SketchRegistry(**SMALL, sketch_backend=b, device="cpu")
             for b in ("flat", "width_class")})


def _open(registries, kind, seed, budget_kb=64):
    """The same tenant in both packages."""
    name, jb, tb = KINDS[kind]
    jregs, tregs = registries
    return (jregs[jb].open("cit-HepPh", name, budget_kb, seed=seed),
            tregs[tb].open("cit-HepPh", name, budget_kb, seed=seed))


@pytest.fixture(scope="module")
def registry(registries):
    return registries[1]["width_class"]


@pytest.fixture(scope="module")
def tenant(registry):
    t = registry.open("cit-HepPh", "kmatrix", 64, seed=0)
    t.step(2)
    t.publish()
    return t


def _values(results):
    return [r.value for r in results]


def _assert_same_state(port, ref):
    pl, ps = interop.export_state(port)
    rl, rs = interop.export_state(ref)
    assert ps == rs and sorted(pl) == sorted(rl)
    for k in rl:
        assert pl[k].dtype == rl[k].dtype, k
        np.testing.assert_array_equal(pl[k], rl[k], err_msg=k)


def _counters(sk) -> list[np.ndarray]:
    """Every tensor leaf of a sketch, copied to the host (export_state's
    arrays share memory with CPU tensors)."""
    return [x.copy() for x in interop.export_state(sk)[0].values()]


def _same_counters(a: list, b: list) -> bool:
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def _asdicts(reqs):
    return [dataclasses.asdict(r) for r in reqs]


def _jax_request(r):
    return jeng.Request(**dataclasses.asdict(r))


def _mixed_requests(kind, n_nodes, n=150, seed=2):
    reqs = synth_requests(n, mix_for_sketch(KINDS[kind][0]), n_nodes=n_nodes,
                          seed=seed, heavy_universe=min(n_nodes, 512),
                          heavy_threshold=50.0)
    if kind in ("tcm", "gmatrix"):  # the kinds that answer node_in
        reqs += [eng.node_in(v) for v in range(0, n_nodes, 97)]
    if kind not in ("countmin", "gsketch"):  # a bounded-hop closure too
        reqs.append(eng.reach(1, 2, max_hops=2))
    return reqs


# ---------------------------------------------------------------- registry
def test_registry_open_is_idempotent(registry, tenant):
    again = registry.open("cit-HepPh", "kmatrix", 64, seed=0)
    assert again is tenant
    assert TenantKey("cit-HepPh", "kmatrix", 64, 0) in registry
    assert registry.get(TenantKey("cit-HepPh", "kmatrix", 64, 0)) is tenant


def test_registry_multi_tenant_isolated_by_key(registry, tenant):
    other = registry.open("cit-HepPh", "gmatrix", 64, seed=0)
    assert other is not tenant
    assert other.key.tenant_id != tenant.key.tenant_id
    assert other.snapshot.tenant_id != tenant.snapshot.tenant_id
    assert len(registry) >= 2 and other in list(registry.tenants())


def test_registry_defaults_and_config_equal_jax():
    jreg, treg = JRegistry(), SketchRegistry()
    jconf, tconf = jreg.config(), treg.config()
    assert tconf.pop("device") == "cuda"
    assert tconf.pop("sketch_backend") == "width_class"
    jconf.pop("sketch_backend")
    assert tconf == jconf
    key = ("cit-HepPh", "gmatrix", 256, 3)
    assert TenantKey(*key).tenant_id == JKey(*key).tenant_id


def test_tenant_origin_rebuilds_the_same_layout_and_shards_wait(registry):
    """A tenant's origin rebuilds its layout; a shard's origin (sharding is
    ported now: nothing waits any more) rebuilds that shard of the sharded
    tenant, over the unsharded tenant's layout."""
    t = registry.open("cit-HepPh", "kmatrix", 64, seed=4)
    again = t.origin.rebuild()
    assert again is not t and again.key == t.key
    _assert_same_state(again.snapshot.sketch, t.snapshot.sketch)
    sharded = registry.open_sharded("cit-HepPh", "kmatrix", 64, seed=4,
                                    n_shards=2)
    shard = dataclasses.replace(t.origin, n_shards=2, shard_seed=0,
                                shard_index=1)
    assert sharded.shards[1].origin == shard
    rebuilt = shard.rebuild()
    assert rebuilt.key == sharded.shards[1].key and rebuilt.offset == 0
    assert rebuilt.key.tenant_id == t.key.tenant_id + "/shard1of2"
    _assert_same_state(rebuilt.snapshot.sketch,
                       t.mod.empty_like(t.snapshot.sketch))


@pytest.mark.parametrize("kind", ["kmatrix", "gmatrix"])
def test_tenant_step_consumes_stream_and_counts_edges_as_jax(registries, kind):
    jt, tt = _open(registries, kind, seed=3)
    assert tt.step(2) == jt.step(2) == 2
    snap, jsnap = tt.publish(), jt.publish()
    assert snap.epoch == jsnap.epoch == 1
    assert snap.n_edges == jsnap.n_edges == 2 * tt.stream.batch_size
    _assert_same_state(snap.sketch, jsnap.sketch)
    tt.step(100), jt.step(100)
    assert tt.exhausted and jt.exhausted
    snap, jsnap = tt.publish(), jt.publish()
    assert snap.n_edges == jsnap.n_edges == tt.stream.spec.n_edges
    _assert_same_state(snap.sketch, jsnap.sketch)
    assert tt.buffer.pending_edges == 0
    assert tt.buffer.overflow_edges == jt.buffer.overflow_edges


# ---------------------------------------------------------------- snapshots
def test_snapshot_isolation_under_live_ingest(registries):
    jt, t = _open(registries, "kmatrix", seed=5)
    t.step(1), jt.step(1)
    held, jheld = t.publish(), jt.publish()
    engine = QueryEngine()
    reqs = [eng.edge_freq(1, 2), eng.node_out(3), eng.reach(4, 9)]
    before = _values(engine.execute(held, reqs))
    assert before == _values(JEngine().execute(
        jheld, [_jax_request(r) for r in reqs]))
    counters = _counters(held.sketch)

    t.step(2)
    new = t.publish()
    assert new.epoch == held.epoch + 1
    assert before == _values(engine.execute(held, reqs)), \
        "held snapshot changed under ingest"
    assert _same_counters(counters, _counters(held.sketch))


def test_publish_epochs_are_monotonic_and_results_stamped(tenant):
    engine = QueryEngine()
    res = engine.execute(tenant.snapshot, [eng.edge_freq(0, 1)])
    assert res[0].epoch == tenant.snapshot.epoch


def _small_flat():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 50, 400).astype(np.int32)
    dst = rng.integers(0, 50, 400).astype(np.int32)
    jsk = JKMatrix.create(bytes_budget=1 << 14, stats=j_stats(src, dst),
                          depth=3, seed=1)
    tsk = KMatrix.create(bytes_budget=1 << 14, stats=t_stats(src, dst),
                         depth=3, seed=1, device="cpu")
    return src, dst, jsk, tsk


def test_delta_buffer_equals_all_at_once_ingest_and_jax():
    """front ⊕ delta publishing must equal ingesting everything into one
    sketch (counter additivity), and the JAX package's buffer."""
    src, dst, jsk, tsk = _small_flat()
    buf = SnapshotBuffer(tsk, kmatrix, tenant_id="t")
    jbuf = JBuffer(jsk, jkm, tenant_id="t")
    for lo in range(0, 400, 100):
        buf.ingest(EdgeBatch.from_numpy(src[lo:lo + 100], dst[lo:lo + 100],
                                        device="cpu"))
        jbuf.ingest(JBatch.from_numpy(src[lo:lo + 100], dst[lo:lo + 100]))
        buf.publish(), jbuf.publish()
    direct = kmatrix.ingest(kmatrix.empty_like(tsk),
                            EdgeBatch.from_numpy(src, dst, device="cpu"))
    assert torch.equal(buf.snapshot.sketch.pool, direct.pool)
    assert torch.equal(buf.snapshot.sketch.conn, direct.conn)
    assert buf.snapshot.epoch == jbuf.snapshot.epoch == 4
    assert buf.snapshot.n_edges == jbuf.snapshot.n_edges == 400
    _assert_same_state(buf.snapshot.sketch, jbuf.snapshot.sketch)
    assert int(tsk.pool.sum()) == 0, "the epoch-0 front was written"


def test_ingest_count_argument_and_the_pending_count_stay_on_device():
    src, dst, _, tsk = _small_flat()
    buf = SnapshotBuffer(tsk, kmatrix)
    w = np.where(np.arange(400) % 4 == 0, 0, 1).astype(np.int32)
    buf.ingest(EdgeBatch.from_numpy(src, dst, w, device="cpu"))
    assert isinstance(buf._pending, torch.Tensor)
    assert buf.pending_edges == 300
    buf.ingest(EdgeBatch.from_numpy(src, dst, device="cpu"), count=7)
    assert buf.pending_edges == 307
    assert buf.publish().n_edges == 307 and buf.pending_edges == 0
    # on the CPU every completion fence is already complete
    token = buf.dispatch_token()
    assert token is DONE and token.query()
    token.synchronize()


def test_adopt_published_delta_folds_exactly_and_gaps_are_stale():
    """A worker-side buffer with ``capture_publish_delta`` stashes exactly
    the per-epoch batch contribution; a parent folding those deltas epoch
    by epoch lands bit-identical to the worker's fronts and to the JAX
    package's — and a delta whose base epoch skips the parent's front
    raises ``StaleDelta`` without corrupting the front."""
    src, dst, jsk, tsk = _small_flat()
    child = SnapshotBuffer(tsk, kmatrix, tenant_id="t")
    child.capture_publish_delta = True
    parent = SnapshotBuffer(tsk, kmatrix, tenant_id="t")
    jchild = JBuffer(jsk, jkm, tenant_id="t")
    jchild.capture_publish_delta = True
    jparent = JBuffer(jsk, jkm, tenant_id="t")
    for lo in range(0, 300, 100):
        part = (src[lo:lo + 100], dst[lo:lo + 100])
        child.ingest(EdgeBatch.from_numpy(*part, device="cpu"))
        jchild.ingest(JBatch.from_numpy(*part))
        snap, jsnap = child.publish(), jchild.publish()
        delta = child.last_publish_delta
        stash = _counters(delta)
        parent.adopt_published(None, snap.epoch, snap.n_edges, delta=delta,
                               base_epoch=snap.epoch - 1)
        jparent.adopt_published(None, jsnap.epoch, jsnap.n_edges,
                                delta=jchild.last_publish_delta,
                                base_epoch=jsnap.epoch - 1)
        assert _same_counters(stash, _counters(delta)), \
            "adopt_published wrote into the incoming delta"
    direct = kmatrix.ingest(kmatrix.empty_like(tsk),
                            EdgeBatch.from_numpy(src[:300], dst[:300],
                                                 device="cpu"))
    assert torch.equal(parent.snapshot.sketch.pool, direct.pool)
    assert torch.equal(parent.snapshot.sketch.conn, direct.conn)
    assert parent.snapshot.epoch == 3
    assert parent.snapshot.n_edges == child.snapshot.n_edges
    _assert_same_state(parent.snapshot.sketch, jparent.snapshot.sketch)

    # ack gap: a delta based past (or before) the front must refuse to fold
    before = parent.snapshot
    for bad_base in (before.epoch + 1, before.epoch - 1):
        with pytest.raises(StaleDelta, match="full resync") as err:
            parent.adopt_published(None, bad_base + 1, 999,
                                   delta=child.last_publish_delta,
                                   base_epoch=bad_base)
        with pytest.raises(JStale) as jerr:
            jparent.adopt_published(None, bad_base + 1, 999,
                                    delta=jchild.last_publish_delta,
                                    base_epoch=bad_base)
        assert str(err.value) == str(jerr.value)
    assert parent.snapshot is before  # front untouched by the refusal

    # a full adopt (the resync) repairs the stream: counters keep matching
    child.ingest(EdgeBatch.from_numpy(src[:100], dst[:100], device="cpu"))
    resync = child.publish()
    parent.adopt_published(resync.sketch, resync.epoch, resync.n_edges)
    assert torch.equal(parent.snapshot.sketch.pool, child.snapshot.sketch.pool)


# ---------------------------------------------------------------- engine
@pytest.mark.parametrize("kind", list(KINDS))
def test_engine_equals_direct_and_jax_for_all_families(registries, kind):
    jt, t = _open(registries, kind, seed=1)
    t.step(2), jt.step(2)
    snap, jsnap = t.publish(), jt.publish()
    _assert_same_state(snap.sketch, jsnap.sketch)
    reqs = _mixed_requests(kind, t.stream.spec.n_nodes)
    families = {"countmin": 3, "gsketch": 3, "tcm": 7, "gmatrix": 7}
    assert len({r.family for r in reqs}) == families.get(kind, 6)
    got = _values(QueryEngine(min_bucket=16).execute(snap, reqs))
    assert gates.mismatched_indices(got, eng.direct_answers(snap, reqs)) == []
    jgot = _values(JEngine(min_bucket=16).execute(
        jsnap, [_jax_request(r) for r in reqs]))
    assert gates.mismatched_indices(got, jgot) == []
    assert any(isinstance(v, tuple) and len(v[0]) for v in got) == \
        (KINDS[kind][0] not in ("countmin", "gsketch"))


def test_engine_padding_odd_batch_sizes(tenant):
    engine = QueryEngine(min_bucket=4)
    for n in (1, 3, 5, 17):
        reqs = [eng.edge_freq(i, i + 1) for i in range(n)]
        got = _values(engine.execute(tenant.snapshot, reqs))
        assert got == eng.direct_answers(tenant.snapshot, reqs)


def _raises_like_jax(engine, jengine, snap, jsnap, reqs, match):
    with pytest.raises(ValueError, match=match) as err:
        engine.execute(snap, reqs)
    with pytest.raises(ValueError) as jerr:
        jengine.execute(jsnap, [_jax_request(r) for r in reqs])
    assert str(err.value) == str(jerr.value)


def test_engine_unsupported_family_raises_as_jax(registries):
    jt, t = _open(registries, "kmatrix", seed=0, budget_kb=32)
    t.step(1), jt.step(1)
    snap, jsnap = t.publish(), jt.publish()
    engine, jengine = QueryEngine(), JEngine()
    _raises_like_jax(engine, jengine, snap, jsnap, [eng.node_in(1)], "node_in")
    jcm, cm = _open(registries, "countmin", seed=0, budget_kb=16)
    cm.step(1), jcm.step(1)
    snap, jsnap = cm.publish(), jcm.publish()
    for r, match in ((eng.node_out(1), "node_out"), (eng.reach(1, 2), "reach"),
                     (eng.heavy_nodes(100, 5.0), "heavy_nodes")):
        _raises_like_jax(engine, jengine, snap, jsnap, [r], match)
    # edge-level families still work on countmin
    reqs = [eng.edge_freq(1, 2), eng.path_weight([1, 2, 3])]
    vals = _values(engine.execute(snap, reqs))
    assert vals == eng.direct_answers(snap, reqs)
    assert vals == _values(jengine.execute(jsnap, [_jax_request(r) for r in reqs]))


def test_closure_cache_hits_within_epoch_invalidates_across(registry):
    t = registry.open("cit-HepPh", "kmatrix", 64, seed=7)
    t.step(1)
    snap = t.publish()
    engine = QueryEngine()
    reqs = [eng.reach(1, 2), eng.reach(3, 4)]
    engine.execute(snap, reqs)
    assert engine.closures.misses == 1
    engine.execute(snap, reqs)
    assert engine.closures.hits == 1, "same epoch must hit the closure cache"
    t.step(1)
    snap2 = t.publish()
    engine.execute(snap2, reqs)
    assert engine.closures.misses == 2, "new epoch must rebuild the closure"
    assert engine.stats == {"batches_planned": 3, "closure_hits": 1,
                            "closure_misses": 2}


def test_closure_cache_keys_by_epoch_not_by_tensor_identity():
    """In-place ingest keeps a tensor's identity and data pointer; the
    cache must see the new epoch all the same."""
    src, dst, _, tsk = _small_flat()
    buf = SnapshotBuffer(tsk, kmatrix)
    engine = QueryEngine()
    reqs = [eng.reach(int(s), int(d)) for s, d in zip(src[:20], dst[:20])]
    empty = _values(engine.execute(buf.snapshot, reqs))
    assert empty == eng.direct_answers(buf.snapshot, reqs)
    assert not all(empty)  # only slots that collide are reachable
    buf.ingest(EdgeBatch.from_numpy(src, dst, device="cpu"))
    snap = buf.publish()
    got = _values(engine.execute(snap, reqs))
    assert all(got) and got == eng.direct_answers(snap, reqs)
    assert engine.closures.misses == 2


def test_engine_rejects_unknown_sketch_type():
    with pytest.raises(TypeError):
        eng.sketch_module(object())


def test_engine_splits_groups_larger_than_max_bucket(tenant):
    engine = QueryEngine(min_bucket=4, max_bucket=8)
    reqs = [eng.edge_freq(i, i + 1) for i in range(21)]
    got = _values(engine.execute(tenant.snapshot, reqs))
    assert got == eng.direct_answers(tenant.snapshot, reqs)
    assert engine.batches_planned == 3
    with pytest.raises(ValueError, match="split the path"):
        engine.execute(tenant.snapshot, [eng.path_weight(range(100))])
    with pytest.raises(ValueError, match="split the edge set"):
        engine.execute(tenant.snapshot,
                       [eng.subgraph_weight([(i, i) for i in range(9)])])


def test_anonymous_buffers_do_not_share_closure_cache():
    """Two hand-built buffers at the same epoch must not serve each other's
    cached closures."""
    rng = np.random.default_rng(2)
    src = rng.integers(0, 60, 300).astype(np.int32)
    dst = rng.integers(0, 60, 300).astype(np.int32)
    sk = KMatrix.create(bytes_budget=1 << 15, stats=t_stats(src, dst),
                        depth=3, seed=1, conn_frac=0.5, device="cpu")
    full = SnapshotBuffer(kmatrix.ingest(
        kmatrix.empty_like(sk), EdgeBatch.from_numpy(src, dst, device="cpu")),
        kmatrix)
    empty = SnapshotBuffer(sk, kmatrix)
    full.publish()
    empty.publish()
    assert full.snapshot.tenant_id != empty.snapshot.tenant_id
    engine = QueryEngine()
    reqs = [eng.reach(int(s), int(d)) for s, d in zip(src[:30], dst[:30])]
    assert all(_values(engine.execute(full.snapshot, reqs)))
    empty_vals = _values(engine.execute(empty.snapshot, reqs))
    # empty sketch has no edges: nothing beyond colliding slots is
    # reachable, which a shared cache entry from `full` would contradict
    assert empty_vals == eng.direct_answers(empty.snapshot, reqs)
    assert not all(empty_vals)


# ---------------------------------------------------------------- merges
def _stats(lo=0, hi=40, n=100, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(lo, hi, n).astype(np.int32)
    dst = rng.integers(lo, hi, n).astype(np.int32)
    return src, dst, t_stats(src, dst)


MODULES = [("kmatrix", kmatrix_accel), ("gmatrix", matrix_sketch),
           ("countmin", countmin), ("gsketch", gsketch)]


@pytest.mark.parametrize("name,mod", MODULES, ids=[m[0] for m in MODULES])
def test_merge_rejects_mismatched_hash_seeds(name, mod):
    *_, stats = _stats()
    a, _ = build_sketch(name, 1 << 14, stats, 3, seed=0, device="cpu")
    b, _ = build_sketch(name, 1 << 14, stats, 3, seed=1, device="cpu")
    with pytest.raises(ValueError, match="hash families"):
        mod.merge(a, b)


@pytest.mark.parametrize("backend", ["width_class", "flat"])
def test_merge_rejects_mismatched_partition_plans(backend):
    """Same budget/depth/seed but different bootstrap samples: layouts and
    hash families agree, routing does not — merge must refuse."""
    *_, stats_a = _stats(0, 100, 200)
    *_, stats_b = _stats(100, 200, 200)
    a, mod = build_sketch("kmatrix", 1 << 14, stats_a, 3, seed=1,
                          backend=backend, device="cpu")
    b, _ = build_sketch("kmatrix", 1 << 14, stats_b, 3, seed=1,
                        backend=backend, device="cpu")
    assert mod.empty_like(a).num_counters == mod.empty_like(b).num_counters
    with pytest.raises(ValueError, match="partition plans"):
        mod.merge(a, b)


def test_merge_accepts_same_seed_and_adds_counters_as_jax():
    from repro.core import MatrixSketch as JMatrix
    from repro.core import matrix_sketch as jms

    sk = MatrixSketch.create(bytes_budget=1 << 14, depth=3, seed=4, device="cpu")
    batch = EdgeBatch.from_numpy(np.asarray([1, 2], np.int32),
                                 np.asarray([2, 3], np.int32), device="cpu")
    a = matrix_sketch.ingest(matrix_sketch.empty_like(sk), batch)
    m = matrix_sketch.merge(a, a)
    assert torch.equal(m.table, 2 * a.table)
    assert m.table.data_ptr() != a.table.data_ptr()
    ja = jms.ingest(JMatrix.create(bytes_budget=1 << 14, depth=3, seed=4),
                    JBatch.from_numpy(np.asarray([1, 2], np.int32),
                                      np.asarray([2, 3], np.int32)))
    _assert_same_state(m, jms.merge(ja, ja))


@pytest.mark.parametrize("backend", ["width_class", "flat"])
def test_empty_like_zeroes_counters_and_keeps_hashes(backend):
    src, dst, stats = _stats(seed=1)
    sk, mod = build_sketch("kmatrix", 1 << 14, stats, 3, seed=2,
                           backend=backend, device="cpu")
    sk = mod.ingest(sk, EdgeBatch.from_numpy(src, dst, device="cpu"))
    z = mod.empty_like(sk)
    assert all(int(x.sum()) == 0 for x in getattr(z, "pools", (getattr(z, "pool", None),)))
    assert int(z.conn.sum()) == 0
    assert torch.equal(z.hashes.a, sk.hashes.a)
    # merging the zero delta back is the identity, into fresh storage
    m = mod.merge(sk, z)
    _assert_same_state(m, sk)
    assert m.conn.data_ptr() != sk.conn.data_ptr()


# ---------------------------------------------------------------- gates
def test_gates_equal_jax_on_answers_and_conservation():
    a = (np.asarray([1, 5]), np.asarray([9, 7]))
    got = [3, True, a, (np.asarray([1]), np.asarray([9]))]
    want = [3, False, a, a]
    assert gates.mismatched_indices(got, want) == \
        jgates.mismatched_indices(got, want) == [1, 3]
    assert gates.values_match(a, a) and not gates.values_match(1, 2)
    for args in [(90, 10, 100, 0), (90, 5, 100, [0, 5]), (100, 0, 100, [0, 0])]:
        assert gates.conservation_verdict(*args) == \
            jgates.conservation_verdict(*args)


@pytest.mark.parametrize("kind", ["kmatrix", "countmin", "gmatrix"])
def test_replay_exactness_equals_jax_and_leaves_template(registries, kind):
    jt, t = _open(registries, kind, seed=11)
    t.step(3), jt.step(3)
    snap, jsnap = t.publish(), jt.publish()
    template = t.mod.empty_like(snap.sketch)
    template = t.mod.ingest(template, t.stream.batch(5, device="cpu"))
    before = _counters(template)
    replay = gates.replay_sketch(t.mod, t.mod.empty_like(snap.sketch),
                                 t.stream, 3)
    assert _same_counters(before, _counters(template))
    dirty = gates.replay_sketch(t.mod, template, t.stream, 3)
    assert _same_counters(before, _counters(template)), \
        "replay_sketch wrote into its template"
    reqs = _mixed_requests(kind, t.stream.spec.n_nodes, n=60)
    verdict = gates.replay_exactness(snap, replay, reqs)
    jreplay = jgates.replay_sketch(jt.mod, jt.mod.empty_like(jsnap.sketch),
                                   jt.stream, 3)
    assert verdict == jgates.replay_exactness(
        jsnap, jreplay, [_jax_request(r) for r in reqs]) == {
        "counters_equal": True, "estimates_equal": True, "ok": True}
    assert gates.layout_counters_equal(snap.sketch, replay)
    assert not gates.layout_counters_equal(snap.sketch, dirty)
    _assert_same_state(replay, jreplay)


def test_layout_counters_equal_covers_gsketch_across_devices(registries):
    """The JAX package's gate reads a ``conn`` that gSketch lacks; the
    port's compares gSketch's pool alone."""
    _, t = _open(registries, "gsketch", seed=12)
    t.step(2)
    snap = t.publish()
    replay = gates.replay_sketch(t.mod, t.mod.empty_like(snap.sketch),
                                 t.stream, 2)
    assert gates.replay_exactness(snap, replay, [eng.edge_freq(1, 2)])["ok"]
    replay = gates.replay_sketch(t.mod, t.mod.empty_like(snap.sketch),
                                 t.stream, 1)
    assert not gates.layout_counters_equal(snap.sketch, replay)


# ---------------------------------------------------------------- hazards
def _held_front_cases(tt):
    """Operations that run after a front was handed out."""
    t_state = tt.buffer.state()
    return [
        ("ingest", lambda: tt.step(1)),
        ("publish", lambda: tt.publish()),
        ("load_state", lambda: tt.buffer.load_state(t_state)),
        ("adopt full", lambda: tt.buffer.adopt_published(
            private_copy(t_state["front"]), 99, 0)),
        ("adopt delta", lambda: tt.buffer.adopt_published(
            None, 100, 0, delta=tt.buffer.state()["front"], base_epoch=99)),
        ("ingest+publish", lambda: (tt.step(1), tt.publish())),
    ]


@pytest.mark.parametrize("kind", ["kmatrix", "gmatrix", "countmin"])
def test_held_front_is_never_written_again(registry, kind):
    t = registry.open("cit-HepPh", kind, 32, seed=21)
    t.step(1)
    held = t.publish()
    counters = _counters(held.sketch)
    reqs = [eng.edge_freq(1, 2), eng.path_weight([3, 4, 5])]
    answers = _values(QueryEngine().execute(held, reqs))
    for what, op in _held_front_cases(t):
        op()
        assert _same_counters(counters, _counters(held.sketch)), what
        assert answers == _values(QueryEngine().execute(held, reqs)), what
    assert t.snapshot is not held


def test_capture_stash_and_state_delta_survive_the_next_ingest(registry):
    t = registry.open("cit-HepPh", "kmatrix", 32, seed=22)
    t.buffer.capture_publish_delta = True
    t.step(1)
    t.publish()
    stash = t.buffer.last_publish_delta
    stash_counters = _counters(stash)
    assert any(x.any() for x in stash_counters)
    t.step(1)
    state = t.buffer.state()
    state_counters = _counters(state["delta"])
    pending = int(state["pending"])
    assert pending == t.stream.batch_size
    t.step(2)
    assert _same_counters(stash_counters, _counters(stash)), \
        "the capture stash was written by the next ingest"
    assert _same_counters(state_counters, _counters(state["delta"])), \
        "state()'s delta was written by the next ingest"
    assert int(state["pending"]) == pending
    assert t.buffer.pending_edges == 3 * t.stream.batch_size


def test_concurrent_ingest_publish_and_state_lose_no_update():
    """Writers ingest into one buffer while another thread publishes and a
    third reads ``state()``: every update lands exactly once, and each
    published epoch's counters stay as they were published."""
    src, dst, _, tsk = _small_flat()
    buf = SnapshotBuffer(tsk, kmatrix)
    batch = EdgeBatch.from_numpy(src, dst, device="cpu")
    n_writers, per_writer = 6, 25
    held, errors = [], []
    done = threading.Event()

    def write():
        for _ in range(per_writer):
            buf.ingest(batch)

    def publish():
        while not done.is_set():
            snap = buf.publish()
            held.append((snap, _counters(snap.sketch)))

    def read_state():
        while not done.is_set():
            st = buf.state()
            if int(st["pending"]) < 0:
                errors.append(st)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        writers = [threading.Thread(target=write) for _ in range(n_writers)]
        others = [threading.Thread(target=publish),
                  threading.Thread(target=read_state)]
        for t in writers + others:
            t.start()
        for t in writers:
            t.join(timeout=120)
        done.set()
        for t in others:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in writers + others)
    finally:
        sys.setswitchinterval(interval)
    final = buf.publish()
    total = n_writers * per_writer
    assert final.n_edges == total * len(src) and not errors
    want = kmatrix.ingest(kmatrix.empty_like(tsk), batch)
    assert torch.equal(final.sketch.pool, want.pool * total)
    assert all(_same_counters(c, _counters(snap.sketch)) for snap, c in held)


def test_load_state_copies_what_it_is_given(registry):
    t = registry.open("cit-HepPh", "gmatrix", 32, seed=23)
    t.step(2)
    t.publish()
    t.step(1)
    state = t.buffer.state()
    counters = [_counters(state["front"]), _counters(state["delta"])]
    other = registry.open("cit-HepPh", "gmatrix", 32, seed=24)
    other.buffer.load_state(state)
    assert other.snapshot.sketch.table.data_ptr() != \
        state["front"].table.data_ptr()
    other.stream, other.offset = t.stream, t.offset
    other.step(2)
    other.publish()
    assert _same_counters(counters[0], _counters(state["front"]))
    assert _same_counters(counters[1], _counters(state["delta"]))
    t.step(2)
    _assert_same_state(t.publish().sketch, other.snapshot.sketch)
    assert other.snapshot.n_edges == t.snapshot.n_edges


@pytest.mark.parametrize("kind", ["kmatrix", "tcm"])
def test_jax_state_carried_through_interop_answers_as_jax(registries, kind):
    """A JAX tenant's published front and pending delta, loaded into a port
    tenant, answers as the JAX tenant does — before and after the rest of
    the stream — and the port's state goes back the other way."""
    jt, t = _open(registries, kind, seed=31)
    jt.step(2)
    jt.publish()
    jt.step(1)  # pending in the delta
    carried = interop.snapshot_state_from_jax(jt.buffer.state(), device="cpu")
    assert carried["pending"] == jt.buffer.pending_edges == t.stream.batch_size
    t.buffer.load_state(carried)
    t.offset = jt.offset
    reqs = _mixed_requests(kind, t.stream.spec.n_nodes, n=80, seed=4)
    jreqs = [_jax_request(r) for r in reqs]
    for _ in range(2):
        assert t.epoch == jt.epoch
        _assert_same_state(t.snapshot.sketch, jt.snapshot.sketch)
        assert gates.mismatched_indices(
            _values(QueryEngine().execute(t.snapshot, reqs)),
            _values(JEngine().execute(jt.snapshot, jreqs))) == []
        t.step(100), jt.step(100)
        t.publish(), jt.publish()
    assert t.snapshot.n_edges == jt.snapshot.n_edges == t.stream.spec.n_edges

    # back: the port's state into a JAX buffer through sketch templates
    t.step(0)
    back = interop.snapshot_state_to_jax(t.buffer.state())
    jbuf = JBuffer(jt.mod.empty_like(jt.snapshot.sketch), jt.mod)
    jbuf.load_state({
        "front": _fill(jt.snapshot.sketch, back["front"][0]),
        "delta": _fill(jt.snapshot.sketch, back["delta"][0]),
        **{k: back[k] for k in ("pending", "epoch", "n_edges")}})
    _assert_same_state(t.snapshot.sketch, jbuf.snapshot.sketch)
    assert jbuf.epoch == t.epoch and jbuf.pending_edges == 0


def _fill(template, leaves):
    """A JAX sketch with ``template``'s structure holding ``leaves`` (keyed
    as the JAX checkpoint store keys them)."""
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    return jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(leaves["/".join(str(p) for p in path)])
        for path, _ in paths])


# ---------------------------------------------------------------- loadgen
@pytest.mark.parametrize("kind,seed", [("kmatrix", 0), ("countmin", 7),
                                       ("gmatrix", 99)])
def test_synth_requests_equal_jax(kind, seed):
    kw = dict(n_nodes=1727, seed=seed, heavy_universe=1024,
              heavy_threshold=100.0)
    reqs = synth_requests(300, mix_for_sketch(kind), **kw)
    jreqs = jload.synth_requests(300, jload.mix_for_sketch(kind), **kw)
    assert _asdicts(reqs) == _asdicts(jreqs)
    assert dataclasses.asdict(mix_for_sketch(kind)) == \
        dataclasses.asdict(jload.mix_for_sketch(kind))


def test_loadgen_open_loop_reports_latency_and_families(tenant):
    engine = QueryEngine(min_bucket=16)
    n_nodes = tenant.stream.spec.n_nodes
    reqs = synth_requests(60, WorkloadMix(), n_nodes=n_nodes, seed=4,
                          heavy_universe=min(n_nodes, 256),
                          heavy_threshold=50.0)
    lg = OpenLoopLoadGen(target_qps=5000.0, batch_max=32)
    ticks = [0]

    def tick():
        ticks[0] += 1

    report = lg.run(engine, lambda: tenant.snapshot, reqs,
                    between_batches=tick)
    assert report.n_requests == 60
    assert report.achieved_qps > 0
    assert report.p99_ms >= report.p50_ms >= 0
    assert sum(report.family_counts.values()) == 60
    assert set(report.family_counts) == {r.family for r in reqs}
    assert len(report.family_counts) == 6
    assert ticks[0] == report.n_batches
    assert report.latency_hist["count"] == 60
    jfields = {f.name for f in dataclasses.fields(jload.LoadReport)}
    assert {f.name for f in dataclasses.fields(report)} == jfields
    assert "achieved_qps" in report.to_json()


def test_workload_mix_normalizes_and_validates():
    mix = WorkloadMix(edge_freq=2.0, reach=2.0, node_out=0.0,
                      path_weight=0.0, subgraph_weight=0.0, heavy_nodes=0.0)
    norm = mix.normalized()
    assert norm["edge_freq"] == pytest.approx(0.5)
    reqs = synth_requests(40, mix, n_nodes=100, seed=0)
    assert {r.family for r in reqs} <= {"edge_freq", "reach"}


def test_hub_is_a_copy_whose_states_fold_into_jax():
    thub.reset_hub(), jhub.reset_hub()
    values = [1e-6, 3e-4, 0.02, 0.5, 7.0]
    th, jh = thub.get_hub(), jhub.get_hub()
    for hub in (th, jh):
        hub.counter("c", "help", family="reach").inc(3)
        hub.gauge("g").set(2.5)
        hub.histogram("h", family="reach").observe_many(values)
    assert th.state() == jh.state()
    assert thub.LADDERS == jhub.LADDERS
    jh.adopt("port", th.state())
    merged = jh.merged_state()
    assert merged["counters"][0][2] == 6
    assert thub.render_prometheus(th.state()) == jhub.render_prometheus(jh.state())
    hs = th.histogram("h", family="reach").state()
    assert thub.hist_summary(hs) == jhub.hist_summary(hs)
    assert thub.merge_hist_states(hs, hs) == jhub.merge_hist_states(hs, hs)
    thub.reset_hub(), jhub.reset_hub()
