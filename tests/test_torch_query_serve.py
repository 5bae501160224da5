"""The port's query_serve driver on the CPU against the JAX package's on the
same flags, in its cooperative, background (``--background-ingest``) and
sharded (``--shards 2 --background-ingest``) modes: the JAX summary keys
plus ``device``, equal deterministic fields, bit-equal final counters; and
every flag parses, and every flag error reads, as the JAX driver's."""
import contextlib
import io
import json
import signal
import threading

import numpy as np
import pytest

import repro.launch.query_serve as j_driver
import repro.serving as j_serving
from repro_torch import interop
from repro_torch.launch import query_serve as t_driver
from repro_torch.serving import (QueryEngine, gates, sharded_direct_answers,
                                 synth_requests)
from repro_torch.serving import engine as eng

FLAGS = ["--scale", "0.03", "--budget-kb", "64", "--depth", "3",
         "--n-requests", "300", "--qps", "2000"]
# the port's kmatrix layout by default is JAX's Pallas (width-class) layout
KINDS = {"kmatrix": ["--sketch-backend", "pallas"], "gmatrix": [],
         "countmin": []}
DETERMINISTIC = ("driver", "dataset", "sketch", "budget_kb", "offered_qps",
                 "n_requests", "total_edges", "ingest_mode")


def _run_reference(kind, monkeypatch):
    """The JAX driver's summary line and its final tenant."""
    seen = {}
    serve = j_driver.cooperative_serve

    def capture(args, tenant, engine, requests):
        seen["tenant"] = tenant
        return serve(args, tenant, engine, requests)

    monkeypatch.setattr(j_driver, "cooperative_serve", capture)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_driver._run(j_driver.parse_args(
            [*FLAGS, "--sketch", kind, *KINDS[kind]]))
    return json.loads(out.getvalue().strip().splitlines()[-1]), seen["tenant"]


@pytest.fixture(scope="module", params=list(KINDS))
def runs(request):
    kind = request.param
    mp = pytest.MonkeyPatch()
    try:
        ref, ref_tenant = _run_reference(kind, mp)
    finally:
        mp.undo()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port = t_driver._run(t_driver.parse_args(
            [*FLAGS, "--sketch", kind, "--device", "cpu"]))
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return ref, ref_tenant, line, port


def test_summary_has_the_jax_keys_and_equal_deterministic_fields(runs):
    ref, _, line, port = runs
    assert line == port["summary"]
    assert set(line) == set(ref) | {"device"} and line["device"] == "cpu"
    assert set(line["latency_hist"]) == set(ref["latency_hist"])
    for key in DETERMINISTIC:
        assert line[key] == ref[key], key
    assert line["total_edges"] == port["tenant"].stream.spec.n_edges
    assert line["final_epoch"] >= 2 and line["n_requests"] == 300
    assert line["p99_ms"] >= line["p50_ms"] > 0 and line["achieved_qps"] > 0
    assert line["engine_closure_misses"] >= (line["sketch"] != "countmin")


def test_final_sketch_is_bit_equal_to_jax(runs):
    _, ref_tenant, _, port = runs
    tenant = port["tenant"]
    assert tenant.exhausted and ref_tenant.exhausted
    assert tenant.buffer.pending_edges == ref_tenant.buffer.pending_edges == 0
    pl, ps = interop.export_state(tenant.snapshot.sketch)
    rl, rs = interop.export_state(ref_tenant.snapshot.sketch)
    assert ps == rs and sorted(pl) == sorted(rl)
    for k in rl:
        np.testing.assert_array_equal(pl[k], rl[k], err_msg=k)


def test_final_answers_equal_direct_and_replay(runs):
    _, _, line, port = runs
    tenant, snap = port["tenant"], port["tenant"].snapshot
    reqs = port["requests"][:120]
    got = [r.value for r in QueryEngine().execute(snap, reqs)]
    direct = eng.direct_answers(snap, reqs)
    assert gates.mismatched_indices(got, direct) == []
    replay = gates.replay_sketch(tenant.mod, tenant.mod.empty_like(snap.sketch),
                                 tenant.stream, tenant.stream.num_batches)
    assert gates.replay_exactness(snap, replay, reqs, answers=direct)["ok"]
    # the driver's requests are the JAX driver's (numpy only)
    n = tenant.stream.spec.n_nodes
    again = synth_requests(300, t_driver.build_mix(t_driver.parse_args(
        ["--sketch", line["sketch"]])), n_nodes=n, seed=7,
        heavy_universe=min(n, 1 << 14), heavy_threshold=100.0)
    assert again == port["requests"]


def test_no_donate_is_refused_and_defaults_equal_jax(capsys):
    with pytest.raises(SystemExit):
        t_driver.parse_args(["--no-donate"])
    assert "nothing to switch off" in capsys.readouterr().err
    port, ref = vars(t_driver.parse_args([])), vars(j_driver.parse_args([]))
    assert port.pop("device") == "cuda"
    assert port.pop("sketch_backend") == ref.pop("sketch_backend") == ""
    assert port == ref


# the flags of the runtime, sharding and network tier and of the metrics
# dump, refused before they were ported: they parse as the JAX driver
# parses them (the last nine under the ids their refusals had)
PORTED = [
    ["--background-ingest"], ["--runtime-backend", "thread"],
    ["--publish-mode", "full"], ["--queue-capacity", "8"],
    ["--backpressure", "spill", "--spill-dir", "x"],
    ["--publish-policy", "every:2"], ["--spill-dir", "x"],
    ["--checkpoint-dir", "x"], ["--checkpoint-every", "4"],
    ["--restore", "--checkpoint-dir", "x"], ["--ingest-dedup"],
    ["--span-log", "x"], ["--shards", "2"], ["--shard-seed", "3"],
    ["--runtime-backend", "process"],
    ["--runtime-backend", "socket:127.0.0.1:7733"],
    ["--serve", "127.0.0.1:7311"],
    ["--connections", "2", "--serve", "127.0.0.1:0"],
    ["--max-inflight", "8", "--serve", "127.0.0.1:0"],
    ["--tenant-qps", "5", "--serve", "127.0.0.1:0"],
    ["--auth-token", "t", "--serve", "127.0.0.1:0"],
    ["--metrics-json", "m.json"], ["--metrics-interval-s", "2"],
]
PORTED_IDS = [f[0] for f in PORTED[:14]] + [
    "--runtime-backend0", "--runtime-backend1", "--serve", "--connections",
    "--max-inflight", "--tenant-qps", "--auth-token", "--metrics-json",
    "--metrics-interval-s"]


@pytest.mark.parametrize("flags", PORTED, ids=PORTED_IDS)
def test_runtime_flags_parse_as_jax(flags):
    argv = ["--background-ingest", *flags]
    port, ref = vars(t_driver.parse_args(argv)), vars(j_driver.parse_args(argv))
    assert port.pop("device") == "cuda"
    port.pop("sketch_backend"), ref.pop("sketch_backend")
    assert port == ref


@pytest.mark.parametrize("argv,message", [
    (["--restore"], "--restore requires --background-ingest"),
    (["--ingest-dedup"], "--ingest-dedup requires --background-ingest"),
    (["--queue-capacity", "8"], "--queue-capacity requires"),
    (["--shards", "2"], "--shards > 1 requires --background-ingest"),
    (["--background-ingest", "--shards", "0"], "--shards must be >= 1"),
    (["--background-ingest", "--restore"], "--restore requires --checkpoint"),
    (["--background-ingest", "--backpressure", "spill"],
     "spill requires --spill-dir"),
    (["--runtime-backend", "fibers"], "--runtime-backend must be one of"),
    (["--runtime-backend", "process"],
     "--runtime-backend requires --background-ingest"),
    (["--serve", "127.0.0.1:0"], "--serve requires --background-ingest"),
    (["--background-ingest", "--connections", "2"],
     "--connections requires --serve"),
    (["--background-ingest", "--tenant-qps", "5"],
     "--tenant-qps requires --serve"),
    (["--background-ingest", "--publish-mode", "both"], "invalid choice"),
])
def test_runtime_flag_errors_equal_jax(argv, message, capsys):
    for parse in (t_driver.parse_args, j_driver.parse_args):
        with pytest.raises(SystemExit) as exc:
            parse(argv)
        assert exc.value.code == 2
        assert message in capsys.readouterr().err


# ------------------------------------------------ background and sharded
BG_FLAGS = [*FLAGS, "--background-ingest"]
MODES = {
    "background-kmatrix": ["--sketch", "kmatrix"],
    "background-gmatrix": ["--sketch", "gmatrix"],
    "sharded-kmatrix": ["--sketch", "kmatrix", "--sketch-backend", "flat",
                        "--shards", "2"],
    "sharded-gmatrix": ["--sketch", "gmatrix", "--shards", "2"],
}
BG_DETERMINISTIC = DETERMINISTIC + (
    "runtime_backend", "backpressure", "publish_policy", "publishes",
    "dropped_edges", "spilled_batches", "unaccounted_edges", "checkpoints",
    "worker_state", "final_epoch", "overflow_edges")
SHARD_DETERMINISTIC = DETERMINISTIC + (
    "runtime_backend", "n_shards", "per_shard_published", "dropped_edges",
    "stream_total_edges", "conservation_ok")


def _jax_flags(flags):
    """The JAX driver's names for the port's layouts: the port's default
    kMatrix layout is the JAX package's Pallas one."""
    if "kmatrix" in flags and "--sketch-backend" not in flags:
        return [*flags, "--sketch-backend", "pallas"]
    return flags


@pytest.fixture(scope="module", params=list(MODES))
def bg_runs(request):
    flags = [*BG_FLAGS, *MODES[request.param]]
    seen = {}
    mp = pytest.MonkeyPatch()
    try:
        serve, attach = j_driver.background_serve, j_serving.attach_shards

        def capture_serve(args, tenant, engine, requests):
            seen["tenant"] = tenant
            return serve(args, tenant, engine, requests)

        def capture_attach(runtime, tenant, **kw):
            seen["tenant"] = tenant
            return attach(runtime, tenant, **kw)

        mp.setattr(j_driver, "background_serve", capture_serve)
        mp.setattr(j_serving, "attach_shards", capture_attach)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            j_driver._run(j_driver.parse_args(_jax_flags(flags)))
        ref = json.loads(out.getvalue().strip().splitlines()[-1])
    finally:
        mp.undo()
    handlers = {sig: signal.getsignal(sig)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port = t_driver._run(t_driver.parse_args([*flags, "--device", "cpu"]))
    assert handlers == {sig: signal.getsignal(sig) for sig in handlers}
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return request.param, ref, seen["tenant"], line, port


def test_background_summary_has_the_jax_keys_and_deterministic_fields(
        bg_runs):
    mode, ref, _, line, port = bg_runs
    assert line == port["summary"]
    assert set(line) == set(ref) | {"device"} and line["device"] == "cpu"
    assert set(line["latency_hist"]) == set(ref["latency_hist"])
    sharded = mode.startswith("sharded")
    for key in SHARD_DETERMINISTIC if sharded else BG_DETERMINISTIC:
        assert line[key] == ref[key], key
    assert line["total_edges"] == port["tenant"].stream.spec.n_edges
    assert line["n_requests"] == 300 and line["achieved_qps"] > 0
    if sharded:
        assert line["conservation_ok"] and line["ingest_mode"] == \
            "sharded-background"
        assert sum(line["per_shard_published"]) == line["total_edges"]
    else:
        assert line["worker_state"] == "stopped"
        assert line["unaccounted_edges"] == line["dropped_edges"] == 0


def test_background_final_counters_equal_jax(bg_runs):
    mode, _, ref_tenant, _, port = bg_runs
    tenant = port["tenant"]
    fronts = ([s.snapshot.sketch for s in tenant.shards]
              if mode.startswith("sharded") else [tenant.snapshot.sketch])
    ref_fronts = ([s.snapshot.sketch for s in ref_tenant.shards]
                  if mode.startswith("sharded")
                  else [ref_tenant.snapshot.sketch])
    for sk, ref_sk in zip(fronts, ref_fronts):
        assert gates.layout_counters_equal(sk, interop.import_state(
            *interop.export_state(ref_sk), device="cpu"))


def test_background_answers_equal_direct_answers(bg_runs):
    mode, _, _, _, port = bg_runs
    tenant, reqs = port["tenant"], port["requests"][:100]
    snap = tenant.snapshot
    got = [r.value for r in port["engine"].execute(snap, reqs)]
    if mode.startswith("sharded"):
        want = sharded_direct_answers(snap, reqs)
        merged = tenant.merged_snapshot()
        assert merged.n_edges == tenant.stream.spec.n_edges
        replay = gates.replay_sketch(
            tenant.mod, tenant.mod.empty_like(merged.sketch), tenant.stream,
            tenant.stream.num_batches)
        assert gates.layout_counters_equal(merged.sketch, replay)
    else:
        want = eng.direct_answers(snap, reqs)
        replay = gates.replay_sketch(
            tenant.mod, tenant.mod.empty_like(snap.sketch), tenant.stream,
            tenant.stream.num_batches)
        assert gates.replay_exactness(snap, replay, reqs, answers=want)["ok"]
    assert gates.mismatched_indices(got, want) == []



@pytest.mark.parametrize("shards", ["1", "2"])
def test_a_failing_worker_ends_the_driver_run(shards, monkeypatch, capsys):
    """A worker's exception (a CUDA error on the card) surfaces as
    ``WorkerFailure`` from the drain, and no summary line is printed."""
    from repro_torch.runtime import WorkerFailure
    from repro_torch.serving.snapshot import SnapshotBuffer

    ingest = SnapshotBuffer.ingest

    def fail_in_workers(self, batch, count=None):
        if threading.current_thread().name.startswith("ingest-"):
            raise RuntimeError("CUDA error: an illegal memory access")
        return ingest(self, batch, count)

    monkeypatch.setattr(SnapshotBuffer, "ingest", fail_in_workers)
    with pytest.raises(WorkerFailure, match="illegal memory access"):
        t_driver._run(t_driver.parse_args(
            [*BG_FLAGS, "--n-requests", "50", "--shards", shards,
             "--device", "cpu"]))
    assert '"achieved_qps"' not in capsys.readouterr().out
