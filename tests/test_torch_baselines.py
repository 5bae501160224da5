"""The paper's baselines in the port (CountMin, gSketch, TCM, gMatrix), the
rest of the query surface, and the driver's --sketch kinds, against the JAX
package on the same inputs (made with numpy from a seed).  Counters and
estimates are compared exactly; the ARE to 1e-6 (summation order)."""
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
from repro_torch.core import EdgeBatch
from repro_torch.core import queries as tq
from repro_torch.core import vertex_stats_from_sample as t_stats
from repro_torch.kernels import matrix_ingest, matrix_lookup
from repro_torch.launch import stream_ingest as t_driver
from repro_torch.serving.registry import build_sketch as t_build
from test_torch_flat import _assert_same_state

BASELINES = ["countmin", "gsketch", "tcm", "gmatrix"]
BUDGET = 48 * 1024
DEPTH = 3


def _random_stream(seed, n=3000, nodes=2000, turnstile=False):
    rng = np.random.default_rng(seed)
    src = rng.zipf(1.3, n).astype(np.int32) % nodes
    dst = rng.integers(0, nodes, n).astype(np.int32)
    w = rng.integers(-3 if turnstile else 1, 5, n).astype(np.int32)
    return src, dst, w


def _pair(kind, seed=0, sample_seed=11):
    """The JAX sketch and the port's (on the CPU) of one kind, built from
    the same sample and seed."""
    s, d, w = _random_stream(sample_seed)
    jsk, jmod = j_build(kind, BUDGET, j_stats(s, d, w), DEPTH, seed)
    tsk, tmod = t_build(kind, BUDGET, t_stats(s, d, w), DEPTH, seed,
                        device="cpu")
    return jsk, jmod, tsk, tmod


def _ingest_both(jsk, jmod, tsk, tmod, src, dst, w, batch=1000):
    for lo in range(0, len(src), batch):
        part = (src[lo:lo + batch], dst[lo:lo + batch], w[lo:lo + batch])
        jsk = jmod.ingest(jsk, JBatch.from_numpy(*part))
        tsk = tmod.ingest(tsk, EdgeBatch.from_numpy(*part, device="cpu"))
    return jsk, tsk


@pytest.mark.parametrize("turnstile", [False, True], ids=["insert", "turnstile"])
@pytest.mark.parametrize("kind", BASELINES)
def test_counters_and_estimates_equal_reference(kind, turnstile):
    matrix_ingest.launches = matrix_lookup.launches = 0
    jsk, jmod, tsk, tmod = _pair(kind)
    _assert_same_state(tsk, jsk)  # the empty sketches: layout, hashes, routes
    counters = tsk.table if hasattr(tsk, "table") else tsk.pool
    src, dst, w = _random_stream(1, turnstile=turnstile)
    jsk, tsk_out = _ingest_both(jsk, jmod, tsk, tmod, src, dst, w)
    assert tsk_out is tsk and (tsk.table if hasattr(tsk, "table")
                               else tsk.pool) is counters  # in place
    _assert_same_state(tsk, jsk)
    if turnstile:
        assert (counters < 0).any()
    qs, qd = src[::3], dst[::3]
    np.testing.assert_array_equal(
        tmod.edge_freq(tsk, torch.as_tensor(qs), torch.as_tensor(qd)).numpy(),
        np.asarray(jmod.edge_freq(jsk, jnp.asarray(qs), jnp.asarray(qd))))
    if kind in ("tcm", "gmatrix"):
        v = np.arange(0, 2000, 7, dtype=np.int32).reshape(2, -1)  # any shape
        for fn in ("node_out_freq", "node_in_freq"):
            np.testing.assert_array_equal(
                getattr(tmod, fn)(tsk, torch.as_tensor(v)).numpy(),
                np.asarray(getattr(jmod, fn)(jsk, jnp.asarray(v))), err_msg=fn)
        est = tmod.edge_freq(tsk, torch.as_tensor(qs.reshape(-1, 2)[:10]),
                             torch.as_tensor(qd.reshape(-1, 2)[:10]))
        assert est.shape == (10, 2)
    assert matrix_ingest.launches == matrix_lookup.launches == 0


@pytest.mark.parametrize("kind", BASELINES)
def test_merge_equals_reference_and_refuses_mismatches(kind):
    jsk, jmod, tsk, tmod = _pair(kind)
    parts = [_random_stream(s) for s in (2, 3)]
    ja, ta = _ingest_both(jsk, jmod, tsk, tmod, *parts[0])
    jb, tb = _ingest_both(jmod.empty_like(jsk), jmod, tmod.empty_like(tsk),
                          tmod, *parts[1])
    merged = tmod.merge(ta, tb)
    _assert_same_state(merged, jmod.merge(ja, jb))
    counters = "table" if hasattr(ta, "table") else "pool"
    assert getattr(merged, counters) is not getattr(ta, counters)
    # merge of the halves == one sketch of the whole stream
    whole = _ingest_both(jsk, jmod, tmod.empty_like(tsk), tmod,
                         *(np.concatenate(x) for x in zip(*parts)))[1]
    _assert_same_state(merged, whole)

    other_seed = _pair(kind, seed=1)[2]
    with pytest.raises(ValueError, match="hash families"):
        tmod.merge(ta, other_seed)
    with pytest.raises(ValueError, match="hash families"):
        jmod.merge(ja, _pair(kind, seed=1)[0])
    smaller = t_build(kind, BUDGET // 2, t_stats(*_random_stream(11)), DEPTH,
                      0, device="cpu")[0]
    with pytest.raises(ValueError, match="different layouts"):
        tmod.merge(ta, smaller)
    if kind == "gsketch":
        other_plan = _pair(kind, sample_seed=12)[2]
        assert other_plan.pool_size == ta.pool_size  # same layout, new plan
        with pytest.raises(ValueError, match="partition plans"):
            tmod.merge(ta, other_plan)


@pytest.fixture(scope="module")
def gmatrix_pair():
    jsk, jmod, tsk, tmod = _pair("gmatrix")
    src, dst, w = _random_stream(4, n=6000)
    jsk, tsk = _ingest_both(jsk, jmod, tsk, tmod, src, dst, w)
    return jsk, jmod, tsk, tmod, src, dst


@pytest.mark.parametrize("universe,chunk", [(2000, 65536), (2000, 256),
                                            (1024, 256)])
@pytest.mark.parametrize("agg,threshold", [("node_out_freq", 58.0),
                                           ("node_in_freq", 201.5)])
def test_heavy_nodes_equal_reference(gmatrix_pair, universe, chunk, agg,
                                     threshold):
    """Thresholds near each aggregate's median: hits and misses both."""
    jsk, jmod, tsk, tmod, _, _ = gmatrix_pair
    jids, jfreqs = jq.heavy_nodes(lambda v: getattr(jmod, agg)(jsk, v),
                                  universe, threshold, chunk=chunk)
    ids, freqs = tq.heavy_nodes(lambda v: getattr(tmod, agg)(tsk, v),
                                universe, threshold, chunk=chunk, device="cpu")
    # the padding contract: length rounded up to chunk, -1 ids on misses
    assert ids.shape == freqs.shape == (-(-universe // chunk) * chunk,)
    assert ids.dtype == torch.int32 and freqs.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(freqs.numpy(), np.asarray(jfreqs))
    hit = ids.numpy() >= 0
    assert hit.any() and (~hit).any()
    assert (freqs.numpy()[~hit] == 0).all()


@pytest.mark.parametrize("kind", ["countmin", "gmatrix"])
def test_edge_set_queries_equal_reference(kind, gmatrix_pair):
    if kind == "gmatrix":
        jsk, jmod, tsk, tmod, src, dst = gmatrix_pair
    else:
        jsk, jmod, tsk, tmod = _pair(kind)
        src, dst, w = _random_stream(4, n=6000)
        jsk, tsk = _ingest_both(jsk, jmod, tsk, tmod, src, dst, w)

    def jf(s, d):
        return jmod.edge_freq(jsk, s, d)

    def tf(s, d):
        return tmod.edge_freq(tsk, s, d)

    cs, cd = src[:500], dst[:500]
    for threshold in (1.0, 3.0, 8.5):
        got = tq.heavy_edges(tf, torch.as_tensor(cs), torch.as_tensor(cd),
                             threshold)
        expect = jq.heavy_edges(jf, jnp.asarray(cs), jnp.asarray(cd), threshold)
        for g, e in zip(got, expect):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))
    path = np.concatenate([src[:20], dst[:1]])
    got = tq.path_weight(tf, torch.as_tensor(path))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(jq.path_weight(jf, jnp.asarray(path)))
    got = tq.subgraph_weight(tf, torch.as_tensor(cs), torch.as_tensor(cd))
    assert int(got) == int(jq.subgraph_weight(jf, jnp.asarray(cs),
                                              jnp.asarray(cd)))


@pytest.mark.parametrize("max_hops", [None, 1, 3])
def test_matrix_sketch_reachability_equals_reference(gmatrix_pair, max_hops):
    jsk, _, tsk, _, src, dst = gmatrix_pair
    rng = np.random.default_rng(8)
    qs = rng.integers(0, 2000, 3000).astype(np.int32)
    qd = rng.integers(0, 2000, 3000).astype(np.int32)
    expect = np.asarray(jq.reachability(jsk, jnp.asarray(qs), jnp.asarray(qd),
                                        max_hops))
    got = tq.reachability(tsk, torch.as_tensor(qs), torch.as_tensor(qd),
                          max_hops).numpy()
    np.testing.assert_array_equal(got, expect)
    assert tq.closure_layers(tsk) is tsk.table
    np.testing.assert_array_equal(
        tq.reach_cells(tsk, torch.as_tensor(qs)).numpy(),
        np.asarray(jq.reach_cells(jsk, jnp.asarray(qs))))
    # the edges themselves are always reachable: one-sided error
    assert tq.reachability(tsk, torch.as_tensor(src), torch.as_tensor(dst),
                           max_hops).all()


@pytest.mark.parametrize("kind", ["countmin", "gsketch"])
def test_type_one_sketches_refuse_reachability(kind):
    jsk, _, tsk, _ = _pair(kind)
    v = torch.arange(4, dtype=torch.int32)
    for fn in (tq.closure_layers, lambda sk: tq.reach_cells(sk, v)):
        with pytest.raises(ValueError, match="not answerable"):
            fn(tsk)
    with pytest.raises(ValueError, match="not answerable"):
        jq.closure_layers(jsk)


def test_kmatrix_reachability_equals_reference():
    s, d, w = _random_stream(5)
    qs, qd = s[:400], d[:400]
    expect = None
    for backend, j_backend in (("width_class", "pallas"), ("flat", "flat")):
        jsk, jmod = j_build("kmatrix", BUDGET, j_stats(s, d, w), DEPTH, 0,
                            backend=j_backend)
        tsk, tmod = t_build("kmatrix", BUDGET, t_stats(s, d, w), DEPTH, 0,
                            backend=backend, device="cpu")
        jsk, tsk = _ingest_both(jsk, jmod, tsk, tmod, s, d, w)
        got = tq.kmatrix_reachability(tsk, torch.as_tensor(qs),
                                      torch.as_tensor(qd)).numpy()
        ref = np.asarray(jq.kmatrix_reachability(jsk, jnp.asarray(qs),
                                                 jnp.asarray(qd)))
        np.testing.assert_array_equal(got, ref)
        expect = got if expect is None else expect
        np.testing.assert_array_equal(got, expect)  # layouts agree


# --------------------------------------------------------------- driver --

FLAGS = ["--scale", "0.03", "--budget-kb", "64", "--depth", "3",
         "--eval-queries", "500"]
# the port's kmatrix layout is named width_class; the JAX package's pallas
DRIVER_CASES = [(k, None, None) for k in BASELINES] + [
    ("kmatrix", "flat", "flat")]


def _run_reference(argv):
    """Run the JAX driver; capture its printout, its final sketch (the
    tree it waits on last) and its unrounded ARE."""
    seen = {}
    mp = pytest.MonkeyPatch()
    block = jax.block_until_ready
    are_fn = j_driver.average_relative_error

    def capture_block(tree):
        seen["sketch"] = tree
        return block(tree)

    def capture_are(est, true):
        seen["ARE"] = float(are_fn(est, true))
        return are_fn(est, true)

    try:
        mp.setattr(jax, "block_until_ready", capture_block)
        mp.setattr(j_driver, "average_relative_error", capture_are)
        mp.setattr("sys.argv", ["stream_ingest", *argv])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            j_driver.main()
    finally:
        mp.undo()
    return out.getvalue(), seen


@pytest.mark.parametrize("kind,t_backend,j_backend", DRIVER_CASES,
                         ids=[c[0] + (f"-{c[1]}" if c[1] else "")
                              for c in DRIVER_CASES])
def test_driver_line_and_counters_equal_reference(kind, t_backend, j_backend):
    """``--sketch <kind>``: the same JSON line, ARE and counters.  For the
    matrix sketches the run goes through matrix_ingest and matrix_lookup
    (plain versions here, on CPU tensors)."""
    argv = [*FLAGS, "--sketch", kind]
    ref_out, ref = _run_reference(
        argv + (["--sketch-backend", j_backend] if j_backend else []))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port = t_driver.inline_main(t_driver.build_parser().parse_args(
            argv + (["--sketch-backend", t_backend] if t_backend else [])
            + ["--device", "cpu"]))
    ref_line = json.loads(ref_out.strip().splitlines()[-1])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == ref_line
    assert ref_line["sketch"] == kind
    assert abs(port["ARE"] - ref["ARE"]) <= 1e-6
    assert port["n_edges"] == port["stream"].spec.n_edges
    _assert_same_state(port["sketch"], ref["sketch"])
