"""The slice end to end: the port's stream_ingest driver on the CPU vs the
JAX package's driver on the same flags (width-class layout, Pallas ingest
in interpret mode): the same JSON line, the same counters, the same
reachability answers."""
import contextlib
import io
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.launch.stream_ingest as j_driver
from repro.core import EdgeBatch as JBatch
from repro.core import queries as jq
from repro.core import vertex_stats_from_sample as j_stats
from repro.serving.registry import build_sketch as j_build
from repro_torch import interop
from repro_torch.core import EdgeBatch
from repro_torch.core import queries as tq
from repro_torch.core import vertex_stats_from_sample as t_stats
from repro_torch.kernels.reach_closure import CLOSURE_MAX_W
from repro_torch.launch import stream_ingest as t_driver
from repro_torch.serving.registry import build_sketch as t_build
from repro_torch.streams import make_stream, sample_stream

FLAGS = ["--scale", "0.03", "--budget-kb", "64", "--depth", "3",
         "--eval-queries", "500"]


def _run_reference(monkeypatch):
    """Run the reference driver; capture its printout, its final sketch
    (the tree it waits on) and its unrounded ARE."""
    seen = {}
    block = jax.block_until_ready

    def capture_block(tree):
        seen["sketch"] = tree
        return block(tree)

    are_fn = j_driver.average_relative_error

    def capture_are(est, true):
        seen["ARE"] = float(are_fn(est, true))
        return are_fn(est, true)

    monkeypatch.setattr(jax, "block_until_ready", capture_block)
    monkeypatch.setattr(j_driver, "average_relative_error", capture_are)
    monkeypatch.setattr("sys.argv", ["stream_ingest", *FLAGS,
                                     "--sketch-backend", "pallas"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_driver.main()
    return out.getvalue(), seen


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    try:
        ref_out, ref = _run_reference(mp)
    finally:
        mp.undo()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port = t_driver.inline_main(
            t_driver.build_parser().parse_args([*FLAGS, "--device", "cpu"]))
    return ref_out, ref, out.getvalue(), port


def test_json_line_and_are_equal(runs):
    ref_out, ref, port_out, port = runs
    ref_line = json.loads(ref_out.strip().splitlines()[-1])
    port_line = json.loads(port_out.strip().splitlines()[-1])
    assert port_line == ref_line
    assert abs(port["ARE"] - ref["ARE"]) <= 1e-6
    assert port_out.splitlines()[0] == ref_out.splitlines()[0]  # stream line
    assert port["n_edges"] == port["stream"].spec.n_edges


def test_counters_equal(runs):
    _, ref, _, port = runs
    assert type(port["sketch"]).__name__ == type(ref["sketch"]).__name__ \
        == "KMatrixAccel"
    pl, ps = interop.export_state(port["sketch"])
    rl, rs = interop.export_state(ref["sketch"])
    assert ps == rs and sorted(pl) == sorted(rl)
    for k in rl:
        np.testing.assert_array_equal(pl[k], rl[k], err_msg=k)


@pytest.mark.parametrize("max_hops", [None, 2])
def test_reachability_answers_equal(runs, max_hops):
    _, ref, _, port = runs
    jsk, tsk = ref["sketch"], port["sketch"]
    rng = np.random.default_rng(5)
    n = port["stream"].spec.n_nodes
    qs = rng.integers(0, n, 2000).astype(np.int32)
    qd = rng.integers(0, n, 2000).astype(np.int32)
    jclosure = jq.build_closure(jq.closure_layers(jsk), max_hops)
    expect = np.asarray(jq.reachability_from_closure(
        jclosure, jq.reach_cells(jsk, jnp.asarray(qs)),
        jq.reach_cells(jsk, jnp.asarray(qd))))
    tclosure = tq.build_closure(tq.closure_layers(tsk), max_hops)
    np.testing.assert_array_equal(tclosure.numpy(), np.asarray(jclosure))
    got = tq.reachability_from_closure(
        tclosure, tq.reach_cells(tsk, torch.as_tensor(qs)),
        tq.reach_cells(tsk, torch.as_tensor(qd))).numpy()
    np.testing.assert_array_equal(got, expect)
    assert got.any()  # the 23-wide conn matrix of this small sketch is dense


# sketches fed a prefix of the small stream's first batch, sparse enough that
# about two pairs in five are reachable: the kMatrix's 23-wide conn (one
# reach_closure where the kernels run) and a 295-wide gMatrix table (wider
# than CLOSURE_MAX_W: the reach_step cascade)
SPARSE = {"kmatrix conn w=23": ("kmatrix", 64, 100),
          "gmatrix table w=295": ("gmatrix", 1024, 3000)}


@pytest.mark.parametrize("case", sorted(SPARSE))
def test_reachability_answers_equal_on_both_outcomes(case):
    """Both answers common (each at least 10% of the pairs): the port's
    closure and answers equal JAX's, so neither "all reachable" nor "none"
    would pass."""
    kind, kb, prefix = SPARSE[case]
    stream = make_stream("cit-HepPh", batch_size=8192, scale=0.03)
    stats = sample_stream(stream, 30_000, seed=1)
    backend = {"kmatrix": ("pallas", "width_class")}.get(kind, (None, None))
    jsk, jmod = j_build(kind, kb * 1024, j_stats(*stats), 3, 0,
                        backend=backend[0])
    tsk, tmod = t_build(kind, kb * 1024, t_stats(*stats), 3, 0,
                        backend=backend[1], device="cpu")
    src, dst, w = stream.batch_numpy(0)
    w = np.where(np.arange(w.size) < prefix, w, 0).astype(np.int32)
    jsk = jmod.ingest(jsk, JBatch.from_numpy(src, dst, w))
    tsk = tmod.ingest(tsk, EdgeBatch.from_numpy(src, dst, w, device="cpu"))
    width = tq.closure_layers(tsk).shape[-1]
    assert (width <= CLOSURE_MAX_W) == (kind == "kmatrix")
    jclosure = jq.build_closure(jq.closure_layers(jsk))
    tclosure = tq.build_closure(tq.closure_layers(tsk))
    np.testing.assert_array_equal(tclosure.numpy(), np.asarray(jclosure))
    rng = np.random.default_rng(5)
    qs = rng.integers(0, stream.spec.n_nodes, 2000).astype(np.int32)
    qd = rng.integers(0, stream.spec.n_nodes, 2000).astype(np.int32)
    expect = np.asarray(jq.reachability_from_closure(
        jclosure, jq.reach_cells(jsk, jnp.asarray(qs)),
        jq.reach_cells(jsk, jnp.asarray(qd))))
    got = tq.reachability_from_closure(
        tclosure, tq.reach_cells(tsk, torch.as_tensor(qs)),
        tq.reach_cells(tsk, torch.as_tensor(qd))).numpy()
    np.testing.assert_array_equal(got, expect)
    reachable = int(got.sum())
    assert 200 <= reachable <= 1800, reachable
