"""repro_torch.analysis.witness: the lock-order witness's unit tests on the
port's witness, the publish guard on the port's ``SnapshotBuffer``, the
check that no published front is written again (raw-pointer writes
included), and the runner ``python -m repro_torch.analysis.witness`` over
the port's threaded serving runs."""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from repro_torch.analysis import witness as witness_mod
from repro_torch.core import KMatrix, kmatrix, vertex_stats_from_sample
from repro_torch.core.types import EdgeBatch
from repro_torch.serving.snapshot import SnapshotBuffer

REPO = Path(__file__).resolve().parents[1]


def _wlock(w, site):
    return witness_mod.WitnessedLock(witness_mod._REAL_LOCK(), site, w)


# ====================================================== dynamic witness
def test_witness_records_inversion_across_threads():
    w = witness_mod.LockWitness()
    a = _wlock(w, "repro_torch/x.py:1")
    b = _wlock(w, "repro_torch/x.py:2")

    def fwd():
        with a:
            with b:
                pass

    def rev():
        with b:
            with a:
                pass

    t = threading.Thread(target=fwd)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert w.report()["cycles"] == []  # one order alone is fine
    t = threading.Thread(target=rev)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    rep = w.report()
    assert len(rep["cycles"]) == 1
    assert set(rep["cycles"][0]["cycle"]) == {"repro_torch/x.py:1",
                                              "repro_torch/x.py:2"}
    assert "fwd" in rep["cycles"][0]["reverse"] \
        or "rev" in rep["cycles"][0]["forward"]
    assert w.render_violations()  # human-readable, non-empty
    assert w.violated(rep)


def test_witness_consistent_order_is_clean():
    w = witness_mod.LockWitness()
    a = _wlock(w, "repro_torch/x.py:1")
    b = _wlock(w, "repro_torch/x.py:2")
    for _ in range(3):
        with a:
            with b:
                pass
    rep = w.report()
    assert rep["cycles"] == [] and rep["edges"] == 1
    assert not w.violated(rep)


def test_witness_rlock_reentry_is_not_a_cycle():
    w = witness_mod.LockWitness()
    r = witness_mod.WitnessedRLock(witness_mod._REAL_RLOCK(),
                                   "repro_torch/x.py:9", w)
    with r:
        with r:
            pass
    assert w.report()["cycles"] == []


def test_witness_same_site_pairs_skipped():
    # two instances of one class share an allocation site; instance-level
    # order is invisible at site granularity — documented blind spot
    w = witness_mod.LockWitness()
    a = _wlock(w, "repro_torch/x.py:5")
    b = _wlock(w, "repro_torch/x.py:5")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    rep = w.report()
    assert rep["cycles"] == [] and rep["edges"] == 0


def test_witness_condition_wait_keeps_stack_exact():
    # Condition built on a witnessed RLock: wait() releases through the
    # proxy (no _release_save forwarded), so the waiter's held stack must
    # be empty while it waits and after the cv block — a stale cv entry
    # would fabricate a cv->other edge below and close a false cycle
    # against the notifier's other->cv order.
    w = witness_mod.LockWitness()
    inner = witness_mod.WitnessedRLock(witness_mod._REAL_RLOCK(),
                                       "repro_torch/q.py:1", w)
    cv = threading.Condition(inner)
    other = _wlock(w, "repro_torch/q.py:2")
    ready = threading.Event()
    done = threading.Event()

    def waiter():
        with cv:
            ready.set()  # notifier can't take cv until wait() releases it
            cv.wait(timeout=5.0)
        with other:  # stack must be clean here: no phantom cv->other edge
            done.set()

    t = threading.Thread(target=waiter)
    t.start()
    assert ready.wait(timeout=5.0)
    with other:
        with cv:  # edge other->cv, the legal order
            cv.notify_all()
    t.join(timeout=10)
    assert not t.is_alive() and done.is_set()
    rep = w.report()
    assert rep["cycles"] == []
    assert ("repro_torch/q.py:1", "repro_torch/q.py:2") not in \
        {tuple(e) for e in w._evidence}


def test_allocation_site_tracks_only_port_code():
    w = witness_mod.install()
    try:
        # a lock this test file allocates is not the port's: raw
        assert not isinstance(threading.Lock(), witness_mod.WitnessedLock)
        buf = _buffer()
        assert isinstance(buf._lock, witness_mod.WitnessedLock)
        assert buf._lock.site.startswith("repro_torch/serving/snapshot.py:")
        assert witness_mod.get_witness() is w
    finally:
        witness_mod.uninstall()
    assert threading.Lock is witness_mod._REAL_LOCK


# ========================================== publishes and published fronts
def _buffer() -> SnapshotBuffer:
    rng = np.random.default_rng(0)
    src = rng.integers(0, 20, 50).astype(np.int32)
    dst = rng.integers(0, 20, 50).astype(np.int32)
    sk = KMatrix.create(bytes_budget=1 << 12,
                        stats=vertex_stats_from_sample(src, dst),
                        depth=2, seed=1, device="cpu")
    return SnapshotBuffer(sk, kmatrix, tenant_id="wtest")


def _batch(seed: int) -> EdgeBatch:
    rng = np.random.default_rng(seed)
    return EdgeBatch.from_numpy(rng.integers(0, 20, 64).astype(np.int32),
                                rng.integers(0, 20, 64).astype(np.int32),
                                device="cpu")


@pytest.fixture
def guarded():
    w = witness_mod.LockWitness()
    witness_mod.guard_publishes(w)
    try:
        yield w
    finally:
        witness_mod._unguard_publishes()


def test_witness_unlocked_publish_guard(guarded):
    w = guarded
    buf = _buffer()
    # a legal publish stores _front under _lock: no violation
    buf.ingest(_batch(1))
    buf.publish()
    legal = len(w.report()["unlocked_publishes"])
    # a raw store outside the lock must be caught
    buf._front = buf.snapshot
    assert len(w.report()["unlocked_publishes"]) == legal + 1


def test_live_fronts_kept_unwritten_are_clean(guarded):
    w = guarded
    buf = _buffer()
    held = []
    for i in range(4):
        buf.ingest(_batch(i))
        held.append(buf.publish())
    rep = w.report()
    assert rep["fronts_written"] == [] and not w.violated(rep)
    assert len(w._fronts) == 4  # every held front is watched


def test_front_written_after_publish_is_reported(guarded):
    w = guarded
    buf = _buffer()
    buf.ingest(_batch(1))
    held = buf.publish()
    held.sketch.pool.add_(1)  # a write into a handed-out front
    buf.ingest(_batch(2))
    buf.publish()  # the next publish checks the live fronts
    rep = w.report()
    assert len(rep["fronts_written"]) == 1
    seen = rep["fronts_written"][0]
    assert seen["epoch"] == held.epoch == 1 and ".pool" in seen["tensors"]
    assert seen["seen_at"] == "the publish of epoch 2"
    assert "front of epoch 1 written after publish" in w.render_violations()
    assert w.violated(rep)


def test_raw_pointer_write_is_seen_where_version_is_not(guarded):
    """The card's ingest kernel writes through a raw pointer (ctypes),
    which never bumps ``_version``; the byte comparison still sees it."""
    w = guarded
    buf = _buffer()
    buf.ingest(_batch(1))
    held = buf.publish()
    conn = held.sketch.conn
    version = conn._version
    one = ctypes.c_int32(7)
    ctypes.memmove(conn.data_ptr(), ctypes.addressof(one), 4)
    assert conn._version == version
    rep = w.report()  # report time checks every live front too
    assert [f["tensors"] for f in rep["fronts_written"]] == [[".conn"]]
    assert rep["fronts_written"][0]["seen_at"] == "report"


def test_dropped_fronts_are_not_watched(guarded):
    w = guarded
    buf = _buffer()
    for i in range(3):
        buf.ingest(_batch(i))
        buf.publish()
    # only the current front is alive: earlier copies were released
    w.report()
    assert [rec.epoch for rec in w._fronts] == [3]


# ================================================================ runner
def _run(args, tmp_path, timeout=180, extra_path=None):
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), *([str(extra_path)] if extra_path else [])])}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.witness", *args],
        capture_output=True, text=True, env=env, timeout=timeout,
        cwd=tmp_path)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("lock witness: ")]
    assert lines, proc.stdout[-2000:] + proc.stderr[-2000:]
    return proc, json.loads(lines[-1][len("lock witness: "):])


SERVE = ["repro_torch.launch.query_serve", "--device", "cpu", "--scale",
         "0.05", "--n-requests", "400", "--qps", "2000",
         "--background-ingest"]


@pytest.mark.parametrize("extra", [[], ["--shards", "2"]],
                         ids=["background", "sharded"])
def test_runner_over_threaded_serving_is_clean(extra, tmp_path):
    proc, rep = _run([*SERVE, *extra], tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert rep["sites"] > 0 and rep["edges"] > 0
    assert rep["cycles"] == rep["unlocked_publishes"] \
        == rep["fronts_written"] == rep["rc"] == 0
    assert '"conservation_ok": true' in proc.stdout or \
        '"unaccounted_edges": 0' in proc.stdout


_FIXTURE = '''
import numpy as np

from repro_torch.core import KMatrix, kmatrix, vertex_stats_from_sample
from repro_torch.core.types import EdgeBatch
from repro_torch.runtime.queueing import BoundedEdgeQueue
from repro_torch.serving.snapshot import SnapshotBuffer

rng = np.random.default_rng(0)
src = rng.integers(0, 20, 50).astype(np.int32)
dst = rng.integers(0, 20, 50).astype(np.int32)
sk = KMatrix.create(bytes_budget=1 << 12,
                    stats=vertex_stats_from_sample(src, dst), depth=2,
                    seed=1, device="cpu")
buf = SnapshotBuffer(sk, kmatrix, tenant_id="fixture")
buf.ingest(EdgeBatch.from_numpy(src, dst, device="cpu"))
held = buf.publish()
MODE = "{mode}"
if MODE == "write":
    held.sketch.pool.add_(1)
elif MODE == "invert":
    q = BoundedEdgeQueue(4)
    with buf._lock:
        with q._cv:
            pass
    with q._cv:
        with buf._lock:
            pass
buf.ingest(EdgeBatch.from_numpy(dst, src, device="cpu"))
buf.publish()
'''


@pytest.mark.parametrize("mode,key", [("clean", None),
                                      ("write", "fronts_written"),
                                      ("invert", "cycles")])
def test_runner_exits_1_on_a_violation(mode, key, tmp_path):
    (tmp_path / "witness_fixture.py").write_text(_FIXTURE.format(mode=mode))
    proc, rep = _run(["witness_fixture"], tmp_path, timeout=120,
                     extra_path=tmp_path)
    if key is None:
        assert proc.returncode == 0 and rep["fronts_written"] == 0, \
            proc.stderr[-3000:]
        return
    assert proc.returncode == 1 and rep[key] == 1, proc.stderr[-3000:]
    assert rep["rc"] == 0  # the module itself ran to its end
    assert ("written after publish" if mode == "write"
            else "lock-order cycle") in proc.stderr


def test_runner_passes_the_modules_exit_code(tmp_path):
    (tmp_path / "exits_three.py").write_text("raise SystemExit(3)\n")
    proc, rep = _run(["exits_three"], tmp_path, timeout=60,
                     extra_path=tmp_path)
    assert proc.returncode == 3 and rep["rc"] == 3


def test_runner_needs_a_module():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.witness"],
        capture_output=True, text=True, timeout=60,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert proc.returncode == 2 and "usage" in proc.stderr
