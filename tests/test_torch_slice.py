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
from repro.core import queries as jq
from repro_torch import interop
from repro_torch.core import queries as tq
from repro_torch.launch import stream_ingest as t_driver

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
