"""The port's drivers in the network tier's modes against the JAX package's
drivers on the same flags, on the CPU: ``query_serve --background-ingest``
with ``--runtime-backend process`` and ``socket`` and with ``--serve``,
``stream_ingest --runtime-backend process`` and a ``stream_ingest
--listen`` worker host dialled by both packages' drivers.  Deterministic
fields, final counters and answers equal; flag errors equal."""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.launch.query_serve as j_driver
import repro.launch.stream_ingest as j_stream
from repro_torch import interop
from repro_torch.launch import query_serve as t_driver
from repro_torch.launch import stream_ingest as t_stream
from repro_torch.serving import gates
from repro_torch.serving import engine as eng

REPO = Path(__file__).resolve().parents[1]
# five stream batches, two of them warm-up, a publish after each of the
# other three: a remote worker's first publish is full, the next two
# deltas unless --publish-mode full
FLAGS = ["--scale", "0.1", "--budget-kb", "64", "--depth", "3",
         "--n-requests", "300", "--qps", "2000", "--background-ingest",
         "--sketch", "gmatrix", "--publish-policy", "every:1"]
DETERMINISTIC = ("driver", "dataset", "sketch", "budget_kb", "offered_qps",
                 "n_requests", "total_edges", "ingest_mode", "backpressure",
                 "publish_policy", "publishes", "dropped_edges",
                 "spilled_batches", "unaccounted_edges", "checkpoints",
                 "worker_state", "final_epoch", "overflow_edges")
NET_DETERMINISTIC = ("connections", "shed", "shed_rate", "aborted")
STREAM = ["--scale", "0.03", "--budget-kb", "64", "--depth", "3",
          "--eval-queries", "500", "--sketch", "gmatrix"]


def _last_line(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _jax_run(flags):
    """The JAX driver's summary line and its final tenant."""
    seen, mp = {}, pytest.MonkeyPatch()
    serve = j_driver.background_serve

    def capture(args, tenant, engine, requests):
        seen["tenant"] = tenant
        return serve(args, tenant, engine, requests)

    try:
        mp.setattr(j_driver, "background_serve", capture)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            j_driver._run(j_driver.parse_args(flags))
    finally:
        mp.undo()
    return _last_line(out.getvalue()), seen["tenant"]


def _port_run(flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = t_driver._run(t_driver.parse_args([*flags, "--device", "cpu"]))
    line = _last_line(out.getvalue())
    assert line == run["summary"]
    return line, run


@pytest.fixture(scope="module")
def reference():
    return _jax_run([*FLAGS, "--runtime-backend", "process"])


MODES = {"process": ["--runtime-backend", "process"],
         "socket": ["--runtime-backend", "socket", "--publish-mode", "full"],
         "serve": ["--serve", "127.0.0.1:0", "--connections", "2"]}


@pytest.mark.parametrize("mode", list(MODES))
def test_query_serve_remote_and_serve_modes_equal_jax(mode, reference,
                                                      monkeypatch):
    from repro_torch.net import backend as net_backend
    from repro_torch.runtime import backend as rt_backend

    ref, ref_tenant = reference
    shipped, dispatch = [], rt_backend.dispatch_parent_message

    def record(h, msg):  # what each publish frame carried on the wire
        if msg[0] == "publish":
            shipped.append(msg[1]["mode"])
        return dispatch(h, msg)

    monkeypatch.setattr(rt_backend, "dispatch_parent_message", record)
    monkeypatch.setattr(net_backend, "dispatch_parent_message", record)
    line, run = _port_run([*FLAGS, *MODES[mode]])
    # --publish-mode reaches the remote backend: the first publish of a
    # session is full, the rest deltas unless the run asked for full
    assert {"process": {"full", "delta"}, "socket": {"full"},
            "serve": set()}[mode] == set(shipped)
    if mode == "serve":  # the same driver modes on the JAX side
        ref, ref_tenant = _jax_run([*FLAGS, *MODES[mode]])
        for key in NET_DETERMINISTIC:
            assert line[key] == ref[key], key
        assert set(line["server_stats"]) == set(ref["server_stats"])
        stats = line["server_stats"]
        assert stats["offered_requests"] == stats["served_requests"] == 300
        assert line["shed"] == line["aborted"] == 0
        assert line["answer_epoch"] >= 1
    assert set(line) == set(ref) | {"device"} and line["device"] == "cpu"
    assert line["runtime_backend"] == (
        "thread" if mode == "serve" else MODES[mode][1])
    for key in DETERMINISTIC:
        assert line[key] == ref[key], key
    tenant, snap = run["tenant"], run["tenant"].snapshot
    assert snap.n_edges == tenant.stream.spec.n_edges
    assert gates.layout_counters_equal(snap.sketch, interop.import_state(
        *interop.export_state(ref_tenant.snapshot.sketch), device="cpu"))
    reqs = run["requests"][:100]
    got = [r.value for r in run["engine"].execute(snap, reqs)]
    assert gates.mismatched_indices(got, eng.direct_answers(snap, reqs)) == []


def test_query_serve_metrics_json_holds_the_scrape_payload(tmp_path):
    path = tmp_path / "m.json"
    t_driver.main([*FLAGS, "--n-requests", "50", "--device", "cpu",
                   "--metrics-json", str(path), "--metrics-interval-s",
                   "0.05"])
    payload = json.loads(path.read_text())
    assert set(payload) == {"prometheus", "state", "ts"}
    assert "repro_engine_group_seconds" in payload["prometheus"]


def _jax_stream(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["stream_ingest", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_stream.main()
    return _last_line(out.getvalue())


def test_stream_ingest_process_backend_equals_jax(monkeypatch):
    argv = [*STREAM, "--runtime-backend", "process", "--ingest-dedup"]
    ref = _jax_stream(argv, monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = t_stream.runtime_main(t_stream.parse_args(
            [*argv, "--device", "cpu"]))
    line = _last_line(out.getvalue())
    assert line == {**ref, "ARE": line["ARE"], "device": "cpu"}
    assert abs(line["ARE"] - ref["ARE"]) <= 1e-6
    assert run["report"]["unaccounted_edges"] == 0


def test_listen_host_serves_a_port_and_a_jax_driver(monkeypatch):
    """One ``stream_ingest --listen`` host (a subprocess, CPU), dialled first
    by the port's driver and then by the JAX package's: both lines equal,
    and the host reports two stopped sessions."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    host = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.stream_ingest", "--listen",
         "127.0.0.1:0", "--max-sessions", "2", "--idle-timeout-s", "120",
         "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=REPO)
    try:
        listening = json.loads(host.stdout.readline())
        assert listening["max_sessions"] == 2 and listening["device"] == "cpu"
        argv = [*STREAM, "--runtime-backend",
                f"socket:{listening['listening']}"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            t_stream.main([*argv, "--device", "cpu"])
        line = _last_line(out.getvalue())
        ref = _jax_stream(argv, monkeypatch)
        rest, err = host.communicate(timeout=120)
    finally:
        if host.poll() is None:
            host.kill()
            host.communicate()
    assert host.returncode == 0, err[-2000:]
    assert line == {**ref, "ARE": line["ARE"], "device": "cpu"}
    assert abs(line["ARE"] - ref["ARE"]) <= 1e-6
    final = _last_line(rest)
    assert final == {"sessions_served": 2, "results": ["stopped", "stopped"],
                     "device": "cpu"}


@pytest.mark.parametrize("argv,message", [
    (["--runtime-backend", "fibers"], "--runtime-backend must be one of"),
    (["--ingest-dedup"], "--ingest-dedup requires a runtime backend"),
    (["--publish-mode", "both"], "invalid choice"),
])
def test_stream_ingest_flag_errors_equal_jax(argv, message, monkeypatch,
                                             capsys):
    with pytest.raises(SystemExit) as exc:
        t_stream.parse_args(argv)
    assert exc.value.code == 2 and message in capsys.readouterr().err
    monkeypatch.setattr(sys, "argv", ["stream_ingest", *argv])
    with pytest.raises(SystemExit) as exc:
        j_stream.main()
    assert exc.value.code == 2 and message in capsys.readouterr().err


def test_listen_refuses_a_non_loopback_bind_without_a_token(monkeypatch):
    monkeypatch.delenv("KMATRIX_NET_TOKEN", raising=False)
    with pytest.raises(SystemExit, match="non-loopback"):
        t_stream.main(["--listen", "0.0.0.0:0", "--device", "cpu"])
