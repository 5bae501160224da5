"""The port's checkpoint store and the driver's --ckpt-dir/--resume, against
the JAX package's store on the same on-disk layout: a checkpoint of every
sketch kind written by either package restores in the other with its
counters and estimates unchanged, and a resumed run is bit-equal to an
uninterrupted one."""
import contextlib
import io
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.launch.stream_ingest as j_driver
from repro.checkpoint import store as jstore
from repro.core import EdgeBatch as JBatch
from repro.core import vertex_stats_from_sample as j_stats
from repro.serving.registry import build_sketch as j_build
from repro.streams import make_stream as j_make_stream
from repro_torch import interop
from repro_torch.checkpoint import store
from repro_torch.core import EdgeBatch
from repro_torch.core import vertex_stats_from_sample as t_stats
from repro_torch.launch import stream_ingest as t_driver
from repro_torch.serving.registry import build_sketch as t_build
from test_torch_flat import _assert_same_state
from repro_torch.streams import make_stream

# (kind, port layout, JAX layout); the port's width_class is JAX's pallas
KINDS = [("countmin", None, None), ("gsketch", None, None),
         ("tcm", None, None), ("gmatrix", None, None),
         ("kmatrix", "flat", "flat"), ("kmatrix", "width_class", "pallas")]
KIND_IDS = [k + (f"-{t}" if t else "") for k, t, _ in KINDS]


def _stream(seed, n=2500, nodes=1500):
    rng = np.random.default_rng(seed)
    src = rng.zipf(1.3, n).astype(np.int32) % nodes
    dst = rng.integers(0, nodes, n).astype(np.int32)
    return src, dst, rng.integers(1, 4, n).astype(np.int32)


def _sketches(kind, t_backend, j_backend):
    """Empty JAX and port sketches of one kind, on one sample and seed."""
    s, d, w = _stream(0)
    jsk, jmod = j_build(kind, 40 * 1024, j_stats(s, d, w), 3, 5,
                        backend=j_backend)
    tsk, tmod = t_build(kind, 40 * 1024, t_stats(s, d, w), 3, 5,
                        backend=t_backend, device="cpu")
    return jsk, jmod, tsk, tmod


@pytest.mark.parametrize("kind,t_backend,j_backend", KINDS, ids=KIND_IDS)
def test_checkpoints_cross_between_packages(tmp_path, kind, t_backend,
                                            j_backend):
    jsk, jmod, tsk, tmod = _sketches(kind, t_backend, j_backend)
    src, dst, w = _stream(1)
    jfull = jmod.ingest(jsk, JBatch.from_numpy(src, dst, w))
    tfull = tmod.ingest(tmod.empty_like(tsk),
                        EdgeBatch.from_numpy(src, dst, w, device="cpu"))
    qs, qd = src[::2], dst[::2]
    expect = np.asarray(jmod.edge_freq(jfull, jnp.asarray(qs), jnp.asarray(qd)))

    # JAX writes, the port restores into an empty template
    jstore.save(str(tmp_path / "jax"), 7, jfull, extra={"stream_offset": 7})
    got, meta = store.restore(str(tmp_path / "jax"), tmod.empty_like(tsk))
    assert meta["step"] == 7 and meta["extra"] == {"stream_offset": 7}
    assert meta["filled_from_template"] == []
    assert got.hashes.a.dtype == torch.int64
    _assert_same_state(got, jfull)
    np.testing.assert_array_equal(
        tmod.edge_freq(got, torch.as_tensor(qs), torch.as_tensor(qd)).numpy(),
        expect)

    # the port writes, JAX restores into an empty template
    store.save(str(tmp_path / "port"), 7, tfull, extra={"stream_offset": 7})
    back, jmeta = jstore.restore(str(tmp_path / "port"), jmod.empty_like(jsk))
    back = jax.tree.map(jnp.asarray, back)  # the JAX store returns numpy leaves
    assert jmeta["filled_from_template"] == []
    _assert_same_state(tfull, back)
    np.testing.assert_array_equal(
        np.asarray(jmod.edge_freq(back, jnp.asarray(qs), jnp.asarray(qd))),
        expect)
    assert store.read_meta(str(tmp_path / "port")) == \
        jstore.read_meta(str(tmp_path / "jax"))


def test_layout_pruning_and_atomicity(tmp_path):
    _, _, tsk, tmod = _sketches("gsketch", None, None)
    tmod.ingest(tsk, EdgeBatch.from_numpy(*_stream(2), device="cpu"))
    d = str(tmp_path)
    assert store.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        store.restore(d, tsk)
    with pytest.raises(FileNotFoundError):
        store.read_meta(d)
    for step in (3, 6, 9, 12):
        path = store.save(d, step, tsk, extra={"stream_offset": step}, keep=2)
        assert path == os.path.join(d, f"step_{step:010d}")
    assert sorted(os.listdir(d)) == ["step_0000000009", "step_0000000012"]
    assert store.latest_step(d) == 12
    meta = store.read_meta(d, 9)
    leaves, _ = interop.export_state(tsk)
    assert meta == {"step": 9, "extra": {"stream_offset": 9},
                    "leaf_keys": sorted(leaves)}
    with np.load(os.path.join(d, "step_0000000012", "leaves.npz")) as data:
        assert sorted(data.files) == sorted(leaves)
        assert data[".hashes/.a"].dtype == np.uint32
        np.testing.assert_array_equal(data[".pool"], tsk.pool.numpy())
    # a save that fails leaves no temporary directory behind
    with pytest.raises(TypeError):
        store.save(d, 15, object())
    assert sorted(os.listdir(d)) == ["step_0000000009", "step_0000000012"]


def test_restore_fills_missing_leaves_and_refuses_wrong_shapes(tmp_path):
    _, _, tsk, tmod = _sketches("kmatrix", "width_class", "pallas")
    tmod.ingest(tsk, EdgeBatch.from_numpy(*_stream(3), device="cpu"))
    tsk.overflow.fill_(4)
    path = store.save(str(tmp_path), 1, tsk)
    npz = os.path.join(path, "leaves.npz")
    with np.load(npz) as data:
        leaves = {k: data[k] for k in data.files}
    # a checkpoint written before the overflow tally existed
    np.savez(npz, **{k: v for k, v in leaves.items() if k != ".overflow"})
    template = tmod.empty_like(tsk)
    got, meta = store.restore(str(tmp_path), template)
    assert meta["filled_from_template"] == [".overflow"]
    assert int(got.overflow) == 0
    for a, b in zip(got.pools, tsk.pools):
        assert torch.equal(a, b)
    np.savez(npz, **{**leaves, ".conn": leaves[".conn"][:1]})
    with pytest.raises(ValueError, match="conn"):
        store.restore(str(tmp_path), template)


def test_iter_from_equals_reference():
    stream = make_stream("cit-HepPh", batch_size=2048, scale=0.02, seed=3)
    jstream = j_make_stream("cit-HepPh", batch_size=2048, scale=0.02, seed=3)
    got = list(stream.iter_from(2, device="cpu"))
    expect = list(jstream.iter_from(2))
    assert [i for i, _ in got] == [i for i, _ in expect] == list(
        range(2, stream.num_batches))
    for (_, b), (_, jb) in zip(got, expect):
        for f in ("src", "dst", "weight"):
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(jb, f)))


FLAGS = ["--scale", "0.03", "--budget-kb", "64", "--depth", "3",
         "--eval-queries", "500", "--batch-size", "2048", "--steps-per-ckpt",
         "4"]


def _port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = t_driver.inline_main(t_driver.build_parser().parse_args(
            [*FLAGS, *argv, "--device", "cpu"]))
    return out.getvalue(), run


@pytest.mark.parametrize("kind", ["gmatrix", "kmatrix"])
def test_driver_resume_is_bit_equal_to_uninterrupted(tmp_path, kind):
    """7 batches with a checkpoint every 4: the whole run writes step 4,
    and a resumed run restores it and ingests batches 4..6 only."""
    ckpt = str(tmp_path)
    out, whole = _port(["--sketch", kind, "--ckpt-dir", ckpt])
    assert whole["batches"] == 7 and store.latest_step(ckpt) == 4
    assert store.read_meta(ckpt)["extra"] == {"stream_offset": 4, "seed": 0}
    out2, resumed = _port(["--sketch", kind, "--ckpt-dir", ckpt, "--resume"])
    assert "resumed from batch 4" in out2
    assert resumed["batches"] == 3
    assert resumed["n_edges"] == whole["n_edges"] - 4 * 2048
    _assert_same_state(resumed["sketch"], whole["sketch"])
    assert resumed["ARE"] == whole["ARE"]
    assert out2.strip().splitlines()[-1] == out.strip().splitlines()[-1]
    _, fresh = _port(["--sketch", kind, "--ckpt-dir", str(tmp_path / "none"),
                      "--resume"])
    assert fresh["batches"] == 7
    _assert_same_state(fresh["sketch"], whole["sketch"])


def test_jax_driver_resumes_from_the_port_checkpoint(tmp_path, monkeypatch):
    ckpt = str(tmp_path)
    out, whole = _port(["--sketch", "gmatrix", "--ckpt-dir", ckpt])
    monkeypatch.setattr("sys.argv", ["stream_ingest", *FLAGS, "--sketch",
                                     "gmatrix", "--ckpt-dir", ckpt, "--resume"])
    ref = io.StringIO()
    with contextlib.redirect_stdout(ref):
        j_driver.main()
    assert "resumed from batch 4" in ref.getvalue()
    assert json.loads(ref.getvalue().strip().splitlines()[-1]) == \
        json.loads(out.strip().splitlines()[-1])
