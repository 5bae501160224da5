"""The port's process execution backend against the thread backend and the
JAX package's process backend: the sketch's leaf order, spawn children
that rebuild the tenant on the CPU and ship publishes back (delta and
full), a stale delta answered by a resync, a killed child, checkpoints
written by the child and restored, and two process shards.  Every child
is spawned (never forked) and every wait is bounded."""
import json
import os
import signal
import time

import jax
import numpy as np
import pytest

from repro.runtime import Runtime as JRuntime
from repro.serving import SketchRegistry as JRegistry
from repro_torch import interop
from repro_torch.obs import get_hub, reset_hub
from repro_torch.runtime import ProcessBackend, Runtime, WorkerFailure
from repro_torch.runtime.backend import LAUNCH_REPORT_ENV
from repro_torch.serving import SketchRegistry, attach_shards, gates
from repro_torch.serving import sharded_conservation
from repro_torch.serving.snapshot import SnapshotBuffer, StaleDelta

SMALL = dict(depth=3, batch_size=1024, scale=0.02)
WAIT_S = 120.0
# port kind -> (registry kind, JAX layout, port layout)
KINDS = {"kmatrix": ("kmatrix", "pallas", "width_class"),
         "kmatrix-flat": ("kmatrix", "flat", "flat"),
         "gmatrix": ("gmatrix", "flat", "flat"),
         "tcm": ("tcm", "flat", "flat"),
         "countmin": ("countmin", "flat", "flat"),
         "gsketch": ("gsketch", "flat", "flat")}


def _wait(cond, timeout_s=WAIT_S, poll_s=0.01):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() >= deadline:
            raise TimeoutError("condition not met in time")
        time.sleep(poll_s)


def _tenant(kind="gmatrix", seed=2, warm=2):
    t = SketchRegistry(**SMALL, sketch_backend="flat", device="cpu").open(
        "cit-HepPh", kind, 64, seed=seed)
    t.step(warm)
    t.publish()
    return t


# ------------------------------------------------------------ leaf order
@pytest.mark.parametrize("kind", [*KINDS, "shard"])
def test_tree_leaves_are_jax_tree_leaves(kind):
    """``interop.tree_leaves`` gives ``jax.tree_util.tree_leaves`` of the JAX
    twin, in order and dtype; ``tree_unflatten`` inverts it."""
    name, jb, tb = KINDS.get(kind, ("kmatrix", "flat", "flat"))
    reg = SketchRegistry(**SMALL, sketch_backend=tb, device="cpu")
    jreg = JRegistry(**SMALL, sketch_backend=jb)
    if kind == "shard":
        t = reg.open_sharded("cit-HepPh", name, 64, n_shards=2).shards[1]
        j = jreg.open_sharded("cit-HepPh", name, 64, n_shards=2).shards[1]
    else:
        t, j = (r.open("cit-HepPh", name, 64, seed=3) for r in (reg, jreg))
    t.step(2), j.step(2)
    t.publish(), j.publish()
    for mine, ref in ((t.snapshot.sketch, j.snapshot.sketch),
                      (t.buffer.state()["delta"], j.buffer.state()["delta"])):
        got = interop.tree_leaves(mine)
        want = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref)]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    back = interop.tree_unflatten(t.snapshot.sketch, [
        np.asarray(x) for x in jax.tree_util.tree_leaves(j.snapshot.sketch)])
    assert gates.layout_counters_equal(back, t.snapshot.sketch)
    assert interop.export_state(back)[1] == interop.export_state(
        t.snapshot.sketch)[1]


def test_tree_unflatten_refuses_leaves_that_do_not_fit():
    sk = _tenant().snapshot.sketch
    leaves = interop.tree_leaves(sk)
    with pytest.raises(ValueError, match="too few"):
        interop.tree_unflatten(sk, leaves[:-1])
    with pytest.raises(ValueError, match="more leaves"):
        interop.tree_unflatten(sk, leaves + leaves[:1])
    with pytest.raises(ValueError, match="shape"):
        interop.tree_unflatten(sk, [leaves[0][:1], *leaves[1:]])
    with pytest.raises(ValueError, match="dtype"):
        interop.tree_unflatten(sk, [leaves[0].astype(np.float32),
                                    *leaves[1:]])


# -------------------------------------------------------- process drains
def _drain(tenant, backend, *, runtime_cls=Runtime, **kw):
    rt = runtime_cls(queue_capacity=8, publish_policy="every:3", poll_s=0.01,
                     backend=backend, **kw)
    handle = rt.attach(tenant)
    rt.start(pumps=False)
    assert rt.wait_ready()
    rt.start_pumps()
    assert rt.join_pumps(WAIT_S)
    report = rt.stop(drain=True, timeout=WAIT_S)[tenant.key.tenant_id]
    return report, handle


def _publish_bytes() -> float:
    return sum(v for n, _, v in get_hub().state()["counters"]
               if n == "publish_bytes")


@pytest.fixture(scope="module")
def runs():
    out = {}
    t = _tenant()
    out["thread"] = (t, *_drain(t, "thread"))
    for mode in ("delta", "full"):
        reset_hub()
        t = _tenant()
        out[mode] = (t, *_drain(t, ProcessBackend(publish_mode=mode)))
        out[f"{mode} bytes"] = _publish_bytes()
    jt = JRegistry(**SMALL, sketch_backend="flat").open(
        "cit-HepPh", "gmatrix", 64, seed=2)
    jt.step(2)
    jt.publish()
    out["jax"] = (jt, *_drain(jt, "process", runtime_cls=JRuntime))
    return out


@pytest.mark.parametrize("mode", ["delta", "full"])
def test_process_front_equals_thread_and_jax_with_conservation(runs, mode):
    tenant, report, handle = runs[mode]
    thread = runs["thread"][0].snapshot.sketch
    jax_front = interop.import_state(
        *interop.export_state(runs["jax"][0].snapshot.sketch), device="cpu")
    assert report["unaccounted_edges"] == 0 and report["state"] == "stopped"
    assert report == {**report, "dropped_edges": 0}
    assert tenant.snapshot.n_edges == tenant.stream.spec.n_edges
    assert gates.layout_counters_equal(tenant.snapshot.sketch, thread)
    assert gates.layout_counters_equal(tenant.snapshot.sketch, jax_front)
    jreport = runs["jax"][1]
    for key in ("offered_edges", "ingested_edges", "published_edges",
                "unaccounted_edges", "state"):
        assert report[key] == jreport[key], key
    # the child ran in its own process, and its publishes came back
    assert handle.worker.process.pid != os.getpid()
    assert handle.worker.process.exitcode == 0
    assert tenant.snapshot.epoch == runs["jax"][0].snapshot.epoch


def test_delta_publishes_ship_fewer_bytes_than_full(runs):
    assert 0 < runs["delta bytes"] < runs["full bytes"]


def test_stale_delta_resyncs_and_a_full_publish_catches_up(monkeypatch,
                                                           runs):
    adopt, seen = SnapshotBuffer.adopt_published, []

    def stale_once(self, sketch, epoch, n_edges, *, delta=None,
                   base_epoch=None):
        seen.append("delta" if delta is not None else "full")
        if delta is not None and seen.count("delta") == 1:
            raise StaleDelta("a lost delta")
        return adopt(self, sketch, epoch, n_edges, delta=delta,
                     base_epoch=base_epoch)

    monkeypatch.setattr(SnapshotBuffer, "adopt_published", stale_once)
    t = _tenant()
    # a publish per batch, the batches paced, so the resync reaches the
    # child before its next publish (a resync that arrives after the final
    # drain publish is never answered, in the JAX package as here)
    rt = Runtime(queue_capacity=8, publish_policy="every:1", poll_s=0.01,
                 backend="process")
    rt.attach(t, throttle_s=0.05)
    rt.start(pumps=False)
    assert rt.wait_ready()
    rt.start_pumps()
    assert rt.join_pumps(WAIT_S)
    report = rt.stop(drain=True, timeout=WAIT_S)[t.key.tenant_id]
    first = seen.index("delta")
    assert "full" in seen[first + 1:], seen  # the resync's full publish
    assert report["unaccounted_edges"] == 0
    assert gates.layout_counters_equal(t.snapshot.sketch,
                                       runs["thread"][0].snapshot.sketch)


def test_a_stopped_child_reports_its_launches_and_ingests(tmp_path,
                                                         monkeypatch):
    """With ``LAUNCH_REPORT_ENV`` naming a directory, the child leaves its
    kernel launches and its buffer's ingest calls there when it stops: one
    warm batch and every batch after the parent's two.  On the CPU every
    wrapper takes its plain version, so no kernel is launched."""
    monkeypatch.setenv(LAUNCH_REPORT_ENV, str(tmp_path))
    t = _tenant()
    report, handle = _drain(t, "process")
    assert report["state"] == "stopped"
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == 1, files
    rep = json.loads(files[0].read_text())
    assert rep["pid"] == handle.worker.process.pid != os.getpid()
    assert rep["buffer_ingests"] == 1 + t.stream.num_batches - 2
    assert set(rep["launches"]) >= {"matrix_ingest_edges", "reach_closure"}
    assert not any(rep["launches"].values())


def test_killed_child_is_a_worker_failure_with_the_accounting():
    t = _tenant(kind="kmatrix")
    rt = Runtime(queue_capacity=4, publish_policy="every:1", poll_s=0.01,
                 backend="process")
    handle = rt.attach(t, throttle_s=0.05)
    rt.start(pumps=False)
    assert rt.wait_ready()
    rt.start_pumps()
    _wait(lambda: t.snapshot.epoch >= 3)
    os.kill(handle.worker.process.pid, signal.SIGKILL)
    _wait(lambda: not handle.worker.is_alive())
    with pytest.raises(WorkerFailure, match="exited unexpectedly") as exc:
        rt.stop(drain=True, timeout=WAIT_S)
    rep = exc.value.report[t.key.tenant_id]
    assert rep["state"] == "failed"
    assert rep["published_edges"] == t.snapshot.n_edges > 0
    assert rep["offered_edges"] >= rep["ingested_edges"] > 0


def test_checkpoint_and_restore_through_the_child(tmp_path, runs):
    t = _tenant()
    rt = Runtime(queue_capacity=8, publish_policy="every:2", poll_s=0.01,
                 backend="process", checkpoint_dir=str(tmp_path),
                 checkpoint_every=2)
    handle = rt.attach(t, max_batches=6)
    rt.start(pumps=False)
    assert rt.wait_ready()
    rt.start_pumps()
    assert rt.join_pumps(WAIT_S)
    _wait(lambda: handle.worker.metrics_snapshot()["checkpoints"] >= 3)
    path = handle.worker.checkpoint()  # synchronous, written by the child
    assert os.path.exists(path)
    rt.kill()
    assert not handle.worker.is_alive()
    # restored in a fresh registry on the thread backend, then drained: a
    # checkpoint the child wrote is a thread worker's checkpoint
    t2 = SketchRegistry(**SMALL, sketch_backend="flat", device="cpu").open(
        "cit-HepPh", "gmatrix", 64, seed=2)
    rt2 = Runtime(queue_capacity=8, publish_policy="every:2", poll_s=0.01,
                  checkpoint_dir=str(tmp_path))
    rt2.attach(t2, restore=True)
    assert t2.offset == 8  # 2 warm batches + the 6 the child ingested
    rt2.start()
    assert rt2.join_pumps(WAIT_S)
    rt2.stop(drain=True, timeout=WAIT_S)
    assert t2.snapshot.n_edges == t2.stream.spec.n_edges
    assert gates.layout_counters_equal(t2.snapshot.sketch,
                                       runs["thread"][0].snapshot.sketch)


def test_two_process_shards_are_exact():
    reg = SketchRegistry(**SMALL, sketch_backend="flat", device="cpu")
    st = reg.open_sharded("cit-HepPh", "kmatrix", 64, seed=4, n_shards=2)
    rt = Runtime(queue_capacity=8, publish_policy="every:2", poll_s=0.01,
                 backend="process", coalesce_batches=4,
                 coalesce_target=st.stream.batch_size)
    handles = attach_shards(rt, st)
    rt.start(pumps=False)
    assert rt.wait_ready()
    rt.start_pumps()
    assert rt.join_pumps(WAIT_S)
    rt.stop(drain=True, timeout=WAIT_S)
    cons = sharded_conservation(handles, st.stream.spec.n_edges)
    assert cons["conservation_ok"]
    pids = {h.worker.process.pid for h in handles}
    assert len(pids) == 2 and os.getpid() not in pids
    merged = st.merged_snapshot()
    replay = gates.replay_sketch(st.mod, st.mod.empty_like(merged.sketch),
                                 st.stream, st.stream.num_batches)
    assert merged.n_edges == st.stream.spec.n_edges
    assert gates.layout_counters_equal(merged.sketch, replay)
