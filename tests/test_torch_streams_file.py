"""Port vs JAX package: the edge-list ``FileStream``, the paper pipeline fed
from a file, and the rest of the reference's public surface: the core
helpers (``EdgeBatch.pad_to``, ``RouteTable.routed_bytes``,
``total_expected_error``, ``PARTITIONERS``, ``tree_size_bytes``) and the
aliases (``kernels.ops``, ``kmatrix_accel_edge_freq``,
``resolve_sketch_backend``, ``recsys.fm``).  Every file is written under
``tmp_path`` from a numpy seed."""
import contextlib
import dataclasses
import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.launch.stream_ingest as j_driver
import test_torch_slice
from repro.common import struct as jstruct
from repro.core import KMatrixAccel as JKMatrixAccel
from repro.core import partitioning as jpart
from repro.core import routing as jroute
from repro.core import vertex_stats_from_sample as j_stats
from repro.core.types import EdgeBatch as JEdgeBatch
from repro.streams import FileStream as JFileStream
from repro_torch import interop
from repro_torch.common import HashFamily, tree_size_bytes
from repro_torch.core import EdgeBatch, KMatrixAccel
from repro_torch.core import partitioning as tpart
from repro_torch.core import routing as troute
from repro_torch.core import total_expected_error
from repro_torch.core import vertex_stats_from_sample as t_stats
from repro_torch.launch import stream_ingest as t_driver
from repro_torch.streams import FileStream, make_stream

SNAP_HEADER = ("# Directed graph (each unordered pair of nodes is saved once)\n"
               "# Nodes: {n} Edges: {m}\n# FromNodeId\tToNodeId\n")


def _edges(n: int, seed: int, hi: int = 500):
    rng = np.random.default_rng(seed)
    return rng.integers(0, hi, n), rng.integers(0, hi, n)


def _write(path, src, dst, *, sep="\t", header=True):
    lines = "".join(f"{a}{sep}{b}\n" for a, b in zip(src, dst))
    text = SNAP_HEADER.format(n=int(max(src.max(), dst.max())) + 1,
                              m=len(src)) if header else ""
    path.write_text(text + lines)
    return str(path)


FILES = {
    "snap_tabs": lambda p: _write(p, *_edges(9_000, 1)),
    "spaces": lambda p: _write(p, *_edges(60, 2), sep=" ", header=False),
    "one_line": lambda p: _write(p, np.asarray([7]), np.asarray([3]),
                                 header=False),
}


@pytest.mark.parametrize("batch_size", [1, 7, 8192])
@pytest.mark.parametrize("kind", sorted(FILES))
def test_file_stream_equals_the_reference(tmp_path, kind, batch_size):
    path = FILES[kind](tmp_path / f"{kind}.txt")
    port = FileStream(path, batch_size=batch_size)
    ref = JFileStream(path, batch_size=batch_size)
    assert dataclasses.astuple(port.spec) == dataclasses.astuple(ref.spec)
    assert port.num_batches == ref.num_batches
    for i in range(port.num_batches):
        for a, b in zip(port.batch_numpy(i), ref.batch_numpy(i)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    last = port.batch_numpy(port.num_batches - 1)
    padded = port.num_batches * batch_size - port.spec.n_edges
    assert int((last[2] == 0).sum()) == padded
    offset = max(0, port.num_batches - 3)
    got = list(port.iter_from(offset, device="cpu"))
    expect = list(ref.iter_from(offset))
    assert [i for i, _ in got] == [i for i, _ in expect]
    for (_, tb), (_, jb) in zip(got, expect):
        for f in ("src", "dst", "weight"):
            assert getattr(tb, f).device.type == "cpu"
            np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                          np.asarray(getattr(jb, f)))
    for a, b in zip(port.all_edges_numpy(), ref.all_edges_numpy()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        port.batch_numpy(port.num_batches)


def test_file_stream_replays_the_generator(tmp_path):
    """A file written from the generator's matched stream gives its
    batches back bit for bit (what phase P of the smoke holds on the card)."""
    gen = make_stream("cit-HepPh", batch_size=2048, scale=0.03)
    src, dst, _ = gen.all_edges_numpy()
    path = _write(tmp_path / "cit.txt", src, dst)
    fs = FileStream(path, batch_size=2048)
    assert fs.num_batches == gen.num_batches
    for i in range(fs.num_batches):
        for a, b in zip(fs.batch_numpy(i), gen.batch_numpy(i)):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("value,wrapped", [(3_000_000_000, -1_294_967_296),
                                           (2**31, -2**31), (-5, -5)])
def test_ids_outside_int32_raise_where_the_reference_wraps(tmp_path, value,
                                                           wrapped):
    """ROADMAP C: the reference casts int64 ids with ``astype(np.int32)``
    (a large id wraps, a negative one stays) and derives ``n_nodes`` from
    what it got; the port refuses the file, naming the value."""
    path = _write(tmp_path / "ids.txt", np.asarray([1, value, 4]),
                  np.asarray([2, 3, 9]))
    ref = JFileStream(path)
    assert ref.all_edges_numpy()[0][1] == wrapped
    assert ref.spec.n_nodes == 10  # the wrapped id is not counted
    with pytest.raises(ValueError, match=f"vertex id {value} on edge 1"):
        FileStream(path)


@pytest.mark.parametrize("n_edges", [4, 3], ids=["multiple", "remainder"])
def test_past_the_last_batch_the_port_raises_where_the_reference_pads_or_fails(
        tmp_path, n_edges):
    """ROADMAP C: the reference does not check ``i`` against
    ``num_batches``.  Where the edge count is a multiple of the batch size
    it returns an all-padding batch at ``i = num_batches``; otherwise numpy
    raises ``ValueError`` (negative dimensions).  The port raises
    ``IndexError`` in both cases."""
    path = _write(tmp_path / "edges.txt", np.arange(n_edges),
                  np.arange(n_edges) + 1, header=False)
    ref, port = JFileStream(path, batch_size=2), FileStream(path, batch_size=2)
    assert ref.num_batches == port.num_batches == 2
    if n_edges % 2 == 0:
        for col in ref.batch_numpy(2):
            assert col.dtype == np.int32 and col.tolist() == [0, 0]
    else:
        with pytest.raises(ValueError, match="negative dimensions"):
            ref.batch_numpy(2)
    with pytest.raises(IndexError):
        port.batch_numpy(2)
    with pytest.raises(IndexError):
        port.batch(2, device="cpu")


@pytest.mark.parametrize("text", ["", "# only a comment\n"])
def test_a_file_without_edges_raises_in_both(tmp_path, text):
    path = tmp_path / "empty.txt"
    path.write_text(text)
    with pytest.warns(UserWarning), pytest.raises(IndexError):
        JFileStream(str(path))
    with pytest.raises(ValueError, match="no edges"):
        FileStream(str(path))


def test_file_stream_batches_default_to_the_card(tmp_path):
    fs = FileStream(FILES["spaces"](tmp_path / "s.txt"), batch_size=7)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the batch lands on it")
    with pytest.raises((AssertionError, RuntimeError)):
        fs.batch(0)
    with pytest.raises((AssertionError, RuntimeError)):
        next(iter(fs))


@pytest.mark.parametrize("n", [0, 5, 16])
def test_pad_to_equals_the_reference(n):
    src, dst = _edges(n, 3)
    w = np.arange(n, dtype=np.int64) - 2  # turnstile weights, cast to int32
    port = EdgeBatch.pad_to(src.astype(np.int32), dst.astype(np.int32), w, 16,
                            device="cpu")
    ref = JEdgeBatch.pad_to(src.astype(np.int32), dst.astype(np.int32), w, 16)
    for f in ("src", "dst", "weight"):
        got = getattr(port, f)
        assert got.dtype == torch.int32 and got.shape == (16,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, f)))


def test_pad_to_refuses_more_edges_than_slots():
    src = np.arange(5, dtype=np.int32)
    with pytest.raises(AssertionError):
        JEdgeBatch.pad_to(src, src, src, 4)
    with pytest.raises(ValueError, match="5 edges do not fit a batch of 4"):
        EdgeBatch.pad_to(src, src, src, 4, device="cpu")


def _stats():
    stream = make_stream("cit-HepPh", batch_size=4096, seed=2, scale=0.1)
    s, d, w = stream.batch_numpy(0)
    return s, d, w


@pytest.mark.parametrize("total_width", [60, 250])
@pytest.mark.parametrize("name", ["greedy", "banded", "auto"])
def test_partitioners_and_their_errors_equal_the_reference(name, total_width):
    assert list(tpart.PARTITIONERS) == list(jpart.PARTITIONERS)
    s, d, w = _stats()
    jp = jpart.PARTITIONERS[name](j_stats(s, d, w), total_width, square=True)
    tp = tpart.PARTITIONERS[name](t_stats(s, d, w), total_width, square=True)
    assert tp.widths == jp.widths and tp.outlier == jp.outlier
    np.testing.assert_array_equal(tp.route_keys, jp.route_keys)
    np.testing.assert_array_equal(tp.route_part, jp.route_part)
    assert total_expected_error(tp) == jpart.total_expected_error(jp)
    # plan_for reaches the same function with its knobs: one plan
    via = tpart.plan_for(name, t_stats(s, d, w), total_width, square=True)
    jvia = jpart.plan_for(name, j_stats(s, d, w), total_width, square=True)
    assert via.widths == jvia.widths
    assert total_expected_error(via) == jpart.total_expected_error(jvia)


def test_plan_for_refuses_an_unknown_partitioner():
    s, d, w = _stats()
    for mod, stats in ((jpart, j_stats(s, d, w)), (tpart, t_stats(s, d, w))):
        with pytest.raises(ValueError, match="unknown partitioner 'bands'"):
            mod.plan_for("bands", stats, 60, square=True)


@pytest.mark.parametrize("total_width", [60, 250])
@pytest.mark.parametrize("square", [True, False])
def test_routed_bytes_equal_the_reference(total_width, square):
    s, d, w = _stats()
    jt, _ = jroute.route_table_from_plan(
        jpart.plan_for("banded", j_stats(s, d, w), total_width, square=square),
        square=square)
    tt, _ = troute.route_table_from_plan(
        tpart.plan_for("banded", t_stats(s, d, w), total_width, square=square),
        square=square, device="cpu")
    assert tt.routed_bytes == jt.routed_bytes > 0
    assert isinstance(tt.routed_bytes, int)


def test_tree_size_bytes_equals_the_reference():
    """Equal states, equal bytes: batches, stats, route tables and nested
    containers of them.  A sketch differs by its hash parameters only: the
    port holds them as int64, the JAX package as uint32."""
    s, d, w = _stats()
    jb, tb = JEdgeBatch.from_numpy(s, d, w), EdgeBatch.from_numpy(
        s, d, w, device="cpu")
    js, ts = j_stats(s, d, w), t_stats(s, d, w)
    jt, _ = jroute.route_table_from_plan(
        jpart.plan_for("banded", js, 60, square=True), square=True)
    tt, _ = troute.route_table_from_plan(
        tpart.plan_for("banded", ts, 60, square=True), square=True,
        device="cpu")
    rows = np.ones((3, 5), np.float32)
    jtree = {"batch": jb, "stats": [js, (jt, None)], "rows": jnp.asarray(rows)}
    ttree = {"batch": tb, "stats": [ts, (tt, None)],
             "rows": torch.as_tensor(rows)}
    for a, b in ((tb, jb), (ts, js), (tt, jt), (ttree, jtree)):
        assert tree_size_bytes(a) == jstruct.tree_size_bytes(b) > 0
    sk = KMatrixAccel.create(bytes_budget=1 << 16, stats=ts, depth=3,
                             device="cpu")
    jsk = JKMatrixAccel.create(bytes_budget=1 << 16, stats=js, depth=3)
    pl, _ = interop.export_state(sk)
    rl, _ = interop.export_state(jsk)
    assert all(np.array_equal(pl[k], rl[k]) for k in rl)  # equal states
    hashes = [getattr(sk, f.name) for f in dataclasses.fields(sk)
              if isinstance(getattr(sk, f.name), HashFamily)]
    extra = sum(h.a.numel() + h.b.numel() for h in hashes) * 4
    assert tree_size_bytes(sk) == jstruct.tree_size_bytes(jsk) + extra


def _file_of(tmp_path, flags):
    """The generator's stream at ``flags``' scale written as a SNAP file."""
    args = t_driver.build_parser().parse_args([*flags, "--device", "cpu"])
    gen = make_stream(args.dataset, batch_size=args.batch_size, seed=args.seed,
                      scale=args.scale)
    src, dst, _ = gen.all_edges_numpy()
    return _write(tmp_path / "stream.txt", src, dst), args


def test_main_path_fed_from_a_file_three_ways(tmp_path, monkeypatch):
    """The slice's main path at --scale 0.03 (width-class kMatrix): the port
    fed from the file, the JAX driver fed from the same file (its
    ``make_stream`` replaced by its own ``FileStream``; Pallas in interpret
    mode), and the port fed from the generator: the counters bit-equal
    three ways, the ARE equal between the two port runs and within 1e-6 of
    JAX's."""
    flags = test_torch_slice.FLAGS
    path, args = _file_of(tmp_path, flags)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        from_file = t_driver.run_pipeline(
            args, FileStream(path, batch_size=args.batch_size))
        from_gen = t_driver.inline_main(args)
    assert "stream: stream.txt nodes=" in out.getvalue()
    monkeypatch.setattr(j_driver, "make_stream", lambda name, **kw: JFileStream(
        path, batch_size=kw["batch_size"]))
    _, ref = test_torch_slice._run_reference(monkeypatch)
    assert type(from_file["sketch"]).__name__ == "KMatrixAccel"
    assert from_file["n_edges"] == from_gen["n_edges"] == \
        from_gen["stream"].spec.n_edges
    fl, fs = interop.export_state(from_file["sketch"])
    for other in (from_gen["sketch"], ref["sketch"]):
        ol, os_ = interop.export_state(other)
        assert os_ == fs and sorted(ol) == sorted(fl)
        for k in fl:
            np.testing.assert_array_equal(fl[k], ol[k], err_msg=k)
    assert from_file["ARE"] == from_gen["ARE"]
    assert abs(from_file["ARE"] - ref["ARE"]) <= 1e-6


def test_aliases_name_what_the_reference_names():
    import importlib

    import repro.kernels as jkernels
    import repro.models.recsys as jrecsys
    import repro.serving.registry as jregistry
    import repro_torch.kernels as tkernels
    import repro_torch.models.recsys as trecsys
    import repro_torch.serving.registry as tregistry
    from repro.core import kmatrix_accel as jkma
    from repro_torch.core import kmatrix_accel as tkma

    assert tkernels.ops is importlib.import_module("repro_torch.kernels.ops")
    assert "ops" in tkernels.__all__ and jkernels.ops.__name__.endswith(".ops")
    with pytest.raises(AttributeError, match="no attribute 'nothing'"):
        tkernels.nothing  # noqa: B018
    assert tkernels.ops.kmatrix_accel_edge_freq is tkma.edge_freq
    assert jkernels.ops.kmatrix_accel_edge_freq is jkma.edge_freq
    assert trecsys.fm.forward_with_kernel.__module__ == trecsys.fm.__name__
    assert jrecsys.fm.forward_with_kernel.__module__ == jrecsys.fm.__name__
    # the layout resolver: the port names the width-class layout as its own
    # default (the reference's "pallas" off the TPU is "flat"; ROADMAP C)
    assert tregistry.resolve_sketch_backend(None) == "width_class"
    assert tregistry.resolve_sketch_backend("flat") == \
        jregistry.resolve_sketch_backend("flat") == "flat"
    for resolve in (tregistry.resolve_sketch_backend,
                    jregistry.resolve_sketch_backend):
        with pytest.raises(ValueError, match="unknown sketch backend 'tpu'"):
            resolve("tpu")
