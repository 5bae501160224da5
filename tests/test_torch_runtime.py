"""The port's background ingest runtime against the JAX package's: queues
and backpressure, publish policies, ``preaggregate_edges``, the reservoir's
checkpoint state, worker drains with and without dedup, and checkpoints
that each package restores from the other.  Everything runs on the CPU at
small sizes; every wait is bounded (a hung worker fails the test, it does
not hang the run)."""
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.net import wire as jwire
from repro.runtime import BoundedEdgeQueue as JQueue
from repro.runtime import QueueItem as JItem
from repro.runtime import Runtime as JRuntime
from repro.runtime import make_policy as jmake_policy
from repro.runtime import metrics as jmetrics
from repro.runtime import restore_worker_state as jrestore
from repro.runtime.worker import preaggregate_edges as jpreaggregate
from repro.serving import SketchRegistry as JRegistry
from repro.streams.reservoir import Reservoir as JReservoir
from repro_torch import interop
from repro_torch.kernels import build
from repro_torch.obs import get_hub, profile, reset_hub
from repro_torch.runtime import (
    BoundedEdgeQueue,
    EveryNBatches,
    QueueDrainWatermark,
    QueueItem,
    Runtime,
    WallClockInterval,
    WorkerFailure,
    make_policy,
    resolve_backend,
    restore_worker_state,
)
from repro_torch.runtime import metrics as tmetrics
from repro_torch.net.wire import WireError, decode_message
from repro_torch.runtime.worker import preaggregate_edges
from repro_torch.serving import SketchRegistry, gates
from repro_torch.streams.reservoir import Reservoir

SMALL = dict(depth=3, batch_size=1024, scale=0.02)
# port kind -> (registry kind, JAX backend, port backend)
KINDS = {"kmatrix": ("kmatrix", "pallas", "width_class"),
         "kmatrix-flat": ("kmatrix", "flat", "flat"),
         "gmatrix": ("gmatrix", "flat", "flat")}
WAIT_S = 60.0


def _wait(cond, timeout_s=WAIT_S, poll_s=0.005):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() >= deadline:
            raise TimeoutError("condition not met in time")
        time.sleep(poll_s)


def _item(offset, n=8, n_pad=0, seed=0, cls=QueueItem):
    rng = np.random.default_rng(seed + offset)
    src = rng.integers(0, 100, n + n_pad).astype(np.int32)
    dst = rng.integers(0, 100, n + n_pad).astype(np.int32)
    w = np.concatenate([np.ones(n, np.int32), np.zeros(n_pad, np.int32)])
    return cls.from_arrays(offset, src, dst, w, trace_id=f"t{offset}")


def _tenants(kind, seed=0, budget_kb=64):
    """The same fresh tenant in both packages."""
    name, jb, tb = KINDS[kind]
    return (JRegistry(**SMALL, sketch_backend=jb).open(
                "cit-HepPh", name, budget_kb, seed=seed),
            SketchRegistry(**SMALL, sketch_backend=tb, device="cpu").open(
                "cit-HepPh", name, budget_kb, seed=seed))


def _assert_same_sketch(port, ref):
    pl, ps = interop.export_state(port)
    rl, rs = interop.export_state(ref)
    assert ps == rs and sorted(pl) == sorted(rl)
    for k in rl:
        np.testing.assert_array_equal(pl[k], rl[k], err_msg=k)


def _replay(tenant):
    t = tenant
    return gates.replay_sketch(t.mod, t.mod.empty_like(t.snapshot.sketch),
                               t.stream, t.stream.num_batches)


# ------------------------------------------------------ preaggregate_edges
@pytest.mark.parametrize("seed", range(4))
def test_preaggregate_edges_equals_jax_on_turnstile_input(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    src = rng.integers(-3, 40, n).astype(np.int32)  # negative ids too
    dst = rng.integers(0, 40, n).astype(np.int32)
    w = rng.integers(-3, 4, n).astype(np.int32)
    # (ids outside the random ranges) a group whose sum wraps int32, and a
    # pair whose weights cancel
    big = np.iinfo(np.int32).max
    src[:4], dst[:4], w[:4] = 45, 45, [big, big, big, 5]
    src[4:6], dst[4:6], w[4:6] = -7, 50, [9, -9]
    got = preaggregate_edges(src, dst, w)
    want = jpreaggregate(src, dst, w)
    for g, x in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, x)
    # the oracle: a Python wrap-add chain per (src, dst) pair
    sums: dict = {}
    for s, d, x in zip(src.tolist(), dst.tolist(), w.tolist()):
        sums[(s, d)] = (sums.get((s, d), 0) + x + 2**31) % 2**32 - 2**31
    live = {k: v for k, v in sums.items() if v}
    assert dict(zip(zip(got[0].tolist(), got[1].tolist()),
                    got[2].tolist())) == live
    assert (-7, 50) not in live and live[(45, 45)] == (3 * big + 5 + 2**31) \
        % 2**32 - 2**31


def test_preaggregate_edges_of_padding_only_is_empty():
    z = np.zeros(16, np.int32)
    assert all(a.size == 0 and a.dtype == np.int32
               for a in preaggregate_edges(z, z, z))


# ------------------------------------------------------------------ queues
def test_queue_item_counts_only_nonpadding_edges_as_jax():
    it, jit = _item(0, n=5, n_pad=3), _item(0, n=5, n_pad=3, cls=JItem)
    assert it.n_edges == jit.n_edges == 5


def test_queue_block_policy_blocks_until_consumed():
    q = BoundedEdgeQueue(2, "block")
    assert q.put(_item(0)) and q.put(_item(1))
    assert not q.put(_item(2), timeout=0.05), "full queue must block/timeout"
    got = []
    consumer = threading.Thread(target=lambda: got.append(q.get(timeout=5)))
    consumer.start()
    assert q.put(_item(2), timeout=5), "put must unblock once space frees"
    consumer.join(timeout=10)
    assert not consumer.is_alive()
    assert got[0].offset == 0, "FIFO"
    assert q.dropped_batches == 0


@pytest.mark.parametrize("policy", ["block", "drop_oldest", "spill"])
def test_queue_accounting_equals_jax(policy, tmp_path):
    """The same puts and gets through both packages' queues: the same items
    come out in the same order and the stats agree field for field."""
    kw = ({"spill_dir": str(tmp_path / "port")} if policy == "spill" else {})
    jkw = ({"spill_dir": str(tmp_path / "jax")} if policy == "spill" else {})
    q, jq = BoundedEdgeQueue(2, policy, **kw), JQueue(2, policy, **jkw)
    for i in range(5):
        timeout = 0.01 if policy == "block" else None
        assert q.put(_item(i, n=8 - i), timeout=timeout) == jq.put(
            _item(i, n=8 - i, cls=JItem), timeout=timeout)
    assert q.stats() == jq.stats()
    out = [q.get(timeout=1) for _ in range(q.depth())]
    jout = [jq.get(timeout=1) for _ in range(jq.depth())]
    assert [o.offset for o in out] == [o.offset for o in jout]
    for a, b in zip(out, jout):
        assert a.trace_id == b.trace_id and a.n_edges == b.n_edges
        np.testing.assert_array_equal(a.src, b.src)
        np.testing.assert_array_equal(a.weight, b.weight)
    assert q.get(timeout=0.01) is None and jq.get(timeout=0.01) is None
    assert q.stats() == jq.stats()
    stats = q.stats()
    assert stats["accepted_edges"] - stats["dropped_edges"] == \
        sum(o.n_edges for o in out)


def test_spill_files_are_the_jax_wire_frames(tmp_path):
    q = BoundedEdgeQueue(1, "spill", spill_dir=str(tmp_path / "spill"))
    items = [_item(i, n=4, n_pad=2) for i in range(3)]
    for it in items:
        assert q.put(it)
    files = sorted((tmp_path / "spill").glob("spill_*.kmx"))
    assert len(files) == 2
    for f, it in zip(files, items[1:]):
        data = f.read_bytes()
        assert data == jwire.encode_item_frame(it, on_wire=False)
        kind, off, src, dst, w, n_edges, trace = jwire.decode_message(
            data, on_wire=False)
        assert (off, n_edges, trace) == (it.offset, 4, it.trace_id)
    # a frame the JAX codec wrote reads back here, wide dtypes included
    wide = JItem.from_arrays(9, np.arange(5, dtype=np.int64),
                             np.arange(5, dtype=np.int32),
                             np.array([1, 2, 0, 1, 70000], np.int64),
                             trace_id="w")
    _, off, src, dst, w, n_edges, trace = decode_message(
        jwire.encode_item_frame(wide, on_wire=False), on_wire=False)
    assert (off, n_edges, trace, w.dtype) == (9, 4, "w", np.int64)
    np.testing.assert_array_equal(w, wide.weight)
    assert [q.get(timeout=1).offset for _ in range(3)] == [0, 1, 2]


@pytest.mark.parametrize("cut", ["truncated", "magic", "ragged"])
def test_torn_spill_frame_is_refused(cut):
    frame = bytearray(jwire.encode_item_frame(_item(0, n=4), on_wire=False))
    if cut == "truncated":
        frame = frame[:-3]
    elif cut == "magic":
        frame[:4] = b"XXXX"
    else:  # n_dst one larger than n_src
        frame[12 + 16 + 4:12 + 16 + 8] = (5).to_bytes(4, "big")
    with pytest.raises(WireError):
        decode_message(bytes(frame), on_wire=False)


def test_queue_close_unblocks_producer_and_consumer():
    q = BoundedEdgeQueue(1, "block")
    assert q.put(_item(0))
    results = {}
    prod = threading.Thread(target=lambda: results.setdefault(
        "put", q.put(_item(1))))
    prod.start()
    time.sleep(0.05)
    q.close()
    prod.join(timeout=10)
    assert not prod.is_alive() and results["put"] is False
    assert q.get(timeout=1).offset == 0  # closing keeps queued work
    assert q.get(timeout=1) is None


@pytest.mark.parametrize("args,match", [
    ((4, "yolo"), "policy"), ((4, "spill"), "spill_dir"),
    ((0, "block"), "capacity")])
def test_queue_rejects_bad_config_as_jax(args, match):
    with pytest.raises(ValueError, match=match):
        BoundedEdgeQueue(*args)
    with pytest.raises(ValueError, match=match):
        JQueue(*args)


# ---------------------------------------------------------------- policies
DECISIONS = [(0, 0.0, 0), (2, 0.0, 3), (3, 1.0, 3), (5, 9.0, 0), (1, 10.5, 0),
             (4, 11.0, 9), (1, 30.0, 1), (64, 31.0, 5), (2, 32.0, 0)]


@pytest.mark.parametrize("spec", ["every:3", "every", "interval:10",
                                  "drain", "drain:2"])
def test_policies_parse_and_decide_as_jax(spec):
    p, jp = make_policy(spec), jmake_policy(spec)
    assert type(p).__name__ == type(jp).__name__
    for batches, now, depth in DECISIONS:
        kw = dict(batches_since_publish=batches, now=now, queue_depth=depth)
        got, want = p.should_publish(**kw), jp.should_publish(**kw)
        assert got == want, (spec, kw)
        if got:
            p.note_published(now), jp.note_published(now)


@pytest.mark.parametrize("spec", ["sometimes", "every:0", "interval:0",
                                  "drain:-1", "every:x"])
def test_bad_policy_specs_raise_as_jax(spec):
    with pytest.raises(ValueError) as port:
        make_policy(spec)
    with pytest.raises(ValueError) as ref:
        jmake_policy(spec)
    assert str(port.value) == str(ref.value)


def test_make_policy_accepts_instances_and_factories():
    inst = EveryNBatches(2)
    assert make_policy(inst) is inst
    assert isinstance(make_policy(lambda: WallClockInterval(1.0)),
                      WallClockInterval)
    assert make_policy("drain:2").watermark == 2
    with pytest.raises(TypeError, match="factory"):
        make_policy(lambda: object())
    assert QueueDrainWatermark(0, max_batches=4).should_publish(
        batches_since_publish=4, now=0.0, queue_depth=9)


def test_worker_metrics_snapshot_has_the_jax_keys():
    stats = BoundedEdgeQueue(2).stats()
    m, jm = tmetrics.WorkerMetrics(), jmetrics.WorkerMetrics()
    for x in (m, jm):
        x.note_ingest(10, 1.0)
        x.note_ingest(6, 2.0)
        x.note_publish(0.002, 2.5)
        x.note_dedup(16, 9)
    snap = m.snapshot(queue_stats=stats, state="running", epoch=3, now=4.0)
    assert snap == jm.snapshot(queue_stats=stats, state="running", epoch=3,
                               now=4.0)


# --------------------------------------------------------------- reservoir
def test_reservoir_state_dict_round_trips_and_its_json_equals_jax():
    stream = SketchRegistry(**SMALL, device="cpu").open(
        "cit-HepPh", "gmatrix", 64).stream
    res, jres = Reservoir(100, seed=5), JReservoir(100, seed=5)
    for i in range(3):
        res.offer_batch(*stream.batch_numpy(i))
        jres.offer_batch(*stream.batch_numpy(i))
    state, jstate = res.state_dict(), jres.state_dict()
    assert json.dumps(state["rng_state"]) == json.dumps(jstate["rng_state"])
    assert (state["k"], state["seen"]) == (jstate["k"], jstate["seen"])
    for key in ("src", "dst", "w"):
        np.testing.assert_array_equal(state[key], jstate[key])
    # a fresh sampler loaded from JSON continues exactly as the original
    again = Reservoir(100, seed=99)
    again.load_state_dict({**jstate, "rng_state": json.loads(
        json.dumps(jstate["rng_state"]))})
    for i in range(3, 6):
        res.offer_batch(*stream.batch_numpy(i))
        again.offer_batch(*stream.batch_numpy(i))
    for a, b in zip(res.sample, again.sample):
        np.testing.assert_array_equal(a, b)
    assert again.seen == res.seen
    with pytest.raises(ValueError, match="size mismatch"):
        Reservoir(7).load_state_dict(state)


# ----------------------------------------------------------------- workers
def _turnstile_items(n_nodes, n_items=6, n=256, seed=3, cls=QueueItem):
    """Items with repeated pairs and weights in [-2, 4): deletions, zero
    padding and pairs whose weights cancel."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_items):
        src = rng.integers(0, min(n_nodes, 60), n).astype(np.int32)
        dst = rng.integers(0, min(n_nodes, 60), n).astype(np.int32)
        w = rng.integers(-2, 4, n).astype(np.int32)
        out.append(cls.from_arrays(i, src, dst, w))
    return out


def _drain_prefilled(runtime, tenant, items):
    """Attach without a pump, fill the queue, then start: the worker's
    coalesced groups are then fixed by the queue's contents alone."""
    handle = runtime.attach(tenant, pump=False)
    for it in items:
        assert handle.queue.put(it, timeout=5)
    runtime.start()
    t0 = time.monotonic()
    report = runtime.stop(drain=True, timeout=WAIT_S)
    assert time.monotonic() - t0 < WAIT_S and not handle.worker.is_alive()
    return handle, report[tenant.key.tenant_id]


@pytest.mark.parametrize("dedup", [False, True], ids=["plain", "dedup"])
@pytest.mark.parametrize("kind", ["kmatrix", "gmatrix"])
def test_worker_drain_equals_jax_on_turnstile_items(kind, dedup):
    jt, t = _tenants(kind, seed=2)
    n_nodes = t.stream.spec.n_nodes
    kw = dict(queue_capacity=16, publish_policy="every:3", reservoir_k=32,
              poll_s=0.01, coalesce_batches=3, coalesce_target=1024,
              dedup=dedup)
    handle, rep = _drain_prefilled(Runtime(**kw), t,
                                   _turnstile_items(n_nodes))
    jhandle, jrep = _drain_prefilled(
        JRuntime(**kw), jt, _turnstile_items(n_nodes, cls=JItem))
    assert rep["state"] == jrep["state"] == "stopped"
    _assert_same_sketch(t.snapshot.sketch, jt.snapshot.sketch)
    assert (t.snapshot.epoch, t.snapshot.n_edges) == (
        jt.snapshot.epoch, jt.snapshot.n_edges)
    for key in ("ingested_batches", "ingested_edges", "publishes",
                "dedup_raw_rows", "dedup_unique_rows", "overflow_edges",
                "dropped_edges", "unaccounted_edges", "published_edges"):
        assert rep[key] == jrep[key], key
    assert rep["unaccounted_edges"] == 0
    for a, b in zip(handle.worker.reservoir.sample,
                    jhandle.worker.reservoir.sample):
        np.testing.assert_array_equal(a, b)


def test_dedup_equals_no_dedup_on_an_insert_only_stream():
    """cit-HepPh's weights are all 1, so summing duplicate pairs before the
    width-class ingest keeps every pool bit-equal."""
    fronts = []
    for dedup in (False, True):
        t = SketchRegistry(**SMALL, device="cpu").open("cit-HepPh",
                                                       "kmatrix", 64)
        items = [QueueItem.from_arrays(i, *t.stream.batch_numpy(i))
                 for i in range(t.stream.num_batches)]
        _, rep = _drain_prefilled(Runtime(
            queue_capacity=len(items) + 1, publish_policy="every:4",
            reservoir_k=0, poll_s=0.01, coalesce_batches=4,
            coalesce_target=2048, dedup=dedup), t, items)
        assert rep["unaccounted_edges"] == 0
        assert (rep["dedup_raw_rows"] > rep["dedup_unique_rows"]) == dedup
        fronts.append(t.snapshot)
    assert gates.layout_counters_equal(fronts[0].sketch, fronts[1].sketch)
    assert fronts[0].n_edges == fronts[1].n_edges == t.stream.spec.n_edges
    assert gates.layout_counters_equal(fronts[1].sketch, _replay(t))


@pytest.mark.parametrize("policy", ["block", "drop_oldest", "spill"])
def test_runtime_drain_conserves_every_edge(policy, tmp_path):
    reg = SketchRegistry(**SMALL, sketch_backend="flat", device="cpu")
    t = reg.open("cit-HepPh", "kmatrix", 64, seed=1)
    rt = Runtime(queue_capacity=2, backpressure=policy,
                 spill_dir=str(tmp_path / "spill"), publish_policy="every:2",
                 reservoir_k=64, poll_s=0.01)
    rt.attach(t)
    rt.start()
    assert rt.join_pumps(WAIT_S)
    rep = rt.stop(drain=True, timeout=WAIT_S)[t.key.tenant_id]
    assert rep["state"] == "stopped" and rep["pump_done"]
    assert rep["unaccounted_edges"] == 0
    assert rep["offered_edges"] == t.stream.spec.n_edges
    assert rep["published_edges"] + rep["dropped_edges"] == \
        t.stream.spec.n_edges
    if rep["dropped_edges"] == 0:
        assert gates.layout_counters_equal(t.snapshot.sketch, _replay(t))


def test_worker_failure_surfaces_at_stop():
    reg = SketchRegistry(**SMALL, sketch_backend="flat", device="cpu")
    t = reg.open("cit-HepPh", "kmatrix", 64, seed=5)
    rt = Runtime(queue_capacity=4, publish_policy="every:2", reservoir_k=0,
                 poll_s=0.01)
    handle = rt.attach(t, max_batches=3)

    def explode(batch, count=None):
        raise RuntimeError("CUDA error: an illegal memory access")

    t.buffer.ingest = explode
    rt.start()
    handle.worker.join(timeout=WAIT_S)
    assert not handle.worker.is_alive()
    assert rt.health()[t.key.tenant_id]["state"] == "failed"
    with pytest.raises(WorkerFailure, match="illegal memory access") as exc:
        rt.stop(drain=True, timeout=WAIT_S)
    assert exc.value.report[t.key.tenant_id]["state"] == "failed"
    assert "Traceback" in exc.value.failures[0]["traceback"]


def test_runtime_attach_is_idempotent_and_post_start_attach_fails():
    reg = SketchRegistry(**SMALL, sketch_backend="flat", device="cpu")
    t = reg.open("cit-HepPh", "kmatrix", 64, seed=8)
    rt = Runtime(queue_capacity=4, reservoir_k=0, poll_s=0.01)
    h1 = rt.attach(t, max_batches=1)
    assert rt.attach(t) is h1
    rt.start()
    with pytest.raises(RuntimeError, match="before start"):
        rt.attach(reg.open("cit-HepPh", "gmatrix", 64, seed=8))
    assert rt.join_pumps(WAIT_S)
    rt.stop(drain=True, timeout=WAIT_S)
    assert not h1.worker.is_alive()


@pytest.mark.parametrize("spec", ["process", "socket",
                                  "socket:127.0.0.1:7733"])
def test_remote_backends_name_roadmap_item_12(spec):
    """The remote backends resolve as the JAX package's do (refused by name
    before the network tier was ported; the test keeps its name)."""
    from repro.runtime import resolve_backend as jresolve
    from repro_torch.net.backend import SocketBackend
    from repro_torch.runtime import ProcessBackend

    cls = ProcessBackend if spec == "process" else SocketBackend
    for backend in (resolve_backend(spec), Runtime(backend=spec).backend):
        assert type(backend) is cls and backend.remote
        ref = jresolve(spec)
        assert backend.name == ref.name == spec.split(":")[0]
        assert backend.publish_mode == ref.publish_mode == "delta"
        if cls is SocketBackend:
            assert backend.addresses == ref.addresses
    with pytest.raises(ValueError, match="unknown runtime backend"):
        resolve_backend("fibers")
    assert resolve_backend(None).name == "thread"


# ------------------------------------------------------------- checkpoints
def _crash_at(runtime, tenant, n_batches):
    """Ingest the first ``n_batches`` (one checkpoint after each), then kill
    like a crash: no final publish, no final checkpoint."""
    handle = runtime.attach(tenant, max_batches=n_batches)
    runtime.start()
    assert runtime.join_pumps(WAIT_S)
    _wait(lambda: handle.worker.metrics.checkpoints >= n_batches)
    runtime.kill()
    assert not handle.worker.is_alive()
    assert tenant.offset == n_batches < tenant.stream.num_batches
    return handle


def _resume(runtime_cls, tenant, ckpt, reservoir_k):
    rt = runtime_cls(queue_capacity=4, publish_policy="every:2",
                     reservoir_k=reservoir_k, checkpoint_dir=ckpt,
                     poll_s=0.01)
    handle = rt.attach(tenant, restore=True)
    rt.start()
    assert rt.join_pumps(WAIT_S)
    rep = rt.stop(drain=True, timeout=WAIT_S)[tenant.key.tenant_id]
    assert rep["unaccounted_edges"] == 0 and rep["state"] == "stopped"
    return handle


def _full_pass_reservoir(tenant, k):
    ref = Reservoir(k, seed=tenant.key.seed ^ 0xC0FFEE)
    for i in range(tenant.stream.num_batches):
        ref.offer_batch(*tenant.stream.batch_numpy(i))
    return ref.sample


@pytest.mark.parametrize("kind", ["kmatrix", "kmatrix-flat"])
def test_crash_and_restore_resumes_bit_exactly(kind, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _, t_a = _tenants(kind)
    _crash_at(Runtime(queue_capacity=2, publish_policy="every:2",
                      reservoir_k=128, checkpoint_dir=ckpt,
                      checkpoint_every=1, poll_s=0.01), t_a, 3)
    _, t_b = _tenants(kind)
    handle = _resume(Runtime, t_b, ckpt, 128)
    assert t_b.snapshot.n_edges == t_b.stream.spec.n_edges
    assert gates.layout_counters_equal(t_b.snapshot.sketch, _replay(t_b))
    for got, want in zip(handle.worker.reservoir.sample,
                         _full_pass_reservoir(t_b, 128)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["kmatrix", "gmatrix"])
def test_checkpoints_restore_across_packages(kind, tmp_path):
    """The JAX worker's checkpoint restores into the port (buffer state and
    reservoir equal to JAX's own restore) and the port's into JAX; each
    side then drains the rest of the stream to the full replay."""
    for writer in ("jax", "port"):
        ckpt = str(tmp_path / writer)
        jt_a, t_a = _tenants(kind)
        if writer == "jax":
            _crash_at(JRuntime(queue_capacity=2, publish_policy="every:2",
                               reservoir_k=64, checkpoint_dir=ckpt,
                               checkpoint_every=1, poll_s=0.01), jt_a, 2)
        else:
            _crash_at(Runtime(queue_capacity=2, publish_policy="every:2",
                              reservoir_k=64, checkpoint_dir=ckpt,
                              checkpoint_every=1, poll_s=0.01), t_a, 2)
        jt, t = _tenants(kind)
        tdir = Runtime()._tenant_dir(ckpt, t)
        assert tdir == JRuntime()._tenant_dir(ckpt, jt)
        res, jres = (Reservoir(64, seed=t.key.seed ^ 0xC0FFEE),
                     JReservoir(64, seed=jt.key.seed ^ 0xC0FFEE))
        meta, jmeta = restore_worker_state(t, tdir, res), jrestore(
            jt, tdir, jres)
        assert meta["extra"] == jmeta["extra"] and t.offset == jt.offset == 2
        assert meta["filled_from_template"] == jmeta["filled_from_template"] \
            == []
        state, jstate = t.buffer.state(), jt.buffer.state()
        _assert_same_sketch(state["front"], jstate["front"])
        _assert_same_sketch(state["delta"], jstate["delta"])
        assert [int(state[k]) for k in ("pending", "epoch", "n_edges")] == \
            [int(jstate[k]) for k in ("pending", "epoch", "n_edges")]
        assert json.dumps(res.state_dict()["rng_state"]) == json.dumps(
            jres.state_dict()["rng_state"])
        for a, b in zip(res.sample, jres.sample):
            np.testing.assert_array_equal(a, b)
        # the reader resumes from the other's checkpoint to the full replay
        _, t_c = _tenants(kind)
        _resume(Runtime, t_c, ckpt, 64)
        assert t_c.snapshot.n_edges == t_c.stream.spec.n_edges
        assert gates.layout_counters_equal(t_c.snapshot.sketch, _replay(t_c))


def test_restore_refuses_a_foreign_tenant_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _, t = _tenants("kmatrix-flat")
    rt = Runtime(queue_capacity=4, publish_policy="every:2", reservoir_k=64,
                 checkpoint_dir=ckpt, checkpoint_every=1, poll_s=0.01)
    rt.attach(t, max_batches=2)
    rt.start()
    assert rt.join_pumps(WAIT_S)
    rt.stop(drain=True, timeout=WAIT_S)
    _, other = _tenants("kmatrix-flat", seed=9)
    with pytest.raises(ValueError, match="belongs to tenant"):
        restore_worker_state(other, rt._tenant_dir(ckpt, t),
                             Reservoir(64, seed=9 ^ 0xC0FFEE))


def test_restored_pending_delta_publishes_on_drain(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _, t_a = _tenants("kmatrix-flat")
    rt_a = Runtime(queue_capacity=4, publish_policy="every:100000",
                   reservoir_k=0, checkpoint_dir=ckpt, checkpoint_every=1,
                   poll_s=0.01)
    handle = rt_a.attach(t_a)
    rt_a.start()
    _wait(lambda: handle.worker.metrics.checkpoints
          >= t_a.stream.num_batches)
    rt_a.kill()
    assert t_a.snapshot.n_edges == 0
    _, t_b = _tenants("kmatrix-flat")
    rt_b = Runtime(queue_capacity=4, publish_policy="every:100000",
                   reservoir_k=0, checkpoint_dir=ckpt, poll_s=0.01)
    rt_b.attach(t_b, restore=True)
    assert t_b.offset == t_b.stream.num_batches
    rt_b.start()
    assert rt_b.join_pumps(WAIT_S)
    rep = rt_b.stop(drain=True, timeout=WAIT_S)[t_b.key.tenant_id]
    assert t_b.snapshot.n_edges == t_b.stream.spec.n_edges
    assert rep["unaccounted_edges"] == 0


# ------------------------------------------------------ threads and traces
def test_launch_counts_stay_exact_under_racing_threads():
    """``count_launch`` is the wrappers' one increment: many threads with a
    tiny switch interval lose no count (``+= 1`` alone would)."""

    def fake_kernel():
        pass

    fake_kernel.launches = 0
    per_thread, n_threads = 2000, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            build.count_launch(fake_kernel) for _ in range(per_thread)])
            for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert fake_kernel.launches == per_thread * n_threads


def test_trace_chain_and_span_log(tmp_path):
    from repro_torch.obs import get_trace_log, reset_trace_log

    reset_trace_log()
    _, t = _tenants("kmatrix-flat")
    rt = Runtime(queue_capacity=4, publish_policy="every:2", reservoir_k=0,
                 poll_s=0.01)
    rt.attach(t, max_batches=3)
    rt.start()
    assert rt.join_pumps(WAIT_S)
    rt.stop(drain=True, timeout=WAIT_S)
    log = get_trace_log()
    traces = {e["trace"] for e in log.events()}
    assert len(traces) == 3
    assert all(log.chain(tid) == ["enqueue", "dispatch", "publish"]
               for tid in traces)
    path = tmp_path / "spans.jsonl"
    assert log.dump_jsonl(str(path)) == 9
    assert len(path.read_text().splitlines()) == 9


def test_profile_hooks_record_nothing_when_off(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda site: calls.append(site))
    monkeypatch.delenv("REPRO_PROFILE", raising=False)
    profile._reset_for_tests()
    reset_hub()
    with profile.profile_span("ingest"):
        pass
    assert profile.profile_call("x", lambda a: a + 1, 1) == 2
    assert calls == [] and get_hub().state()["hists"] == []
    monkeypatch.undo()
    monkeypatch.setenv("REPRO_PROFILE", "1")
    profile._reset_for_tests()
    try:
        with profile.profile_span("ingest"):
            pass
        assert profile.profile_call("x", torch.ones, 3).sum() == 3
        sites = sorted(labels["site"] for name, labels, _ in
                       get_hub().state()["hists"]
                       if name == "repro_profile_seconds")
        assert sites == ["ingest", "x"]
    finally:
        monkeypatch.delenv("REPRO_PROFILE")
        profile._reset_for_tests()


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_closure_build_is_a_profiled_site(monkeypatch, backend):
    """As in the JAX package, the closure build is the profiled call site:
    ``query.closure`` (the backend in the span's args) with REPRO_PROFILE=1,
    nothing without it; the closure is the same either way."""
    from repro_torch.core.queries import build_closure

    layers = torch.as_tensor(np.random.default_rng(3).integers(
        0, 2, size=(2, 9, 9)), dtype=torch.int32)
    monkeypatch.delenv("REPRO_PROFILE", raising=False)
    profile._reset_for_tests()
    reset_hub()
    off = build_closure(layers, backend=backend)
    assert get_hub().state()["hists"] == []
    monkeypatch.setenv("REPRO_PROFILE", "1")
    profile._reset_for_tests()
    try:
        on = build_closure(layers, backend=backend)
        sites = [labels["site"] for name, labels, _ in
                 get_hub().state()["hists"]
                 if name == "repro_profile_seconds"]
        assert sites == ["query.closure"]
        assert torch.equal(on, off)
    finally:
        monkeypatch.delenv("REPRO_PROFILE")
        profile._reset_for_tests()
