"""The port's dashboard (``repro_torch.obs.dashboard``) against the JAX
package's: the exposition parser and the panels on the same payloads, the
``--json`` follower on a port ``MetricsJsonDumper`` file, and ``--connect``
scrapes of a port front-end by both dashboards (mixed peers)."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from repro.obs import dashboard as jdash
from repro_torch.net.query_server import QueryClient, QueryServer
from repro_torch.obs import MetricsJsonDumper, dashboard, get_hub, reset_hub
from repro_torch.obs.dump import scrape_payload
from repro_torch.serving import QueryEngine, SketchRegistry, synth_requests
from repro_torch.serving.loadgen import mix_for_sketch

REPO = Path(__file__).resolve().parents[1]
TENANTS = ["cit-HepPh/kmatrix/256KB/seed0", 'odd "name" \\ with\nnewline']


@pytest.fixture(autouse=True)
def _fresh_hub():
    reset_hub()
    yield
    reset_hub()


def _fill_hub(n_lat: int = 40) -> None:
    """Ingest and query series as the runtime and the front-end emit them."""
    hub = get_hub()
    for i, tenant in enumerate(TENANTS):
        hub.counter("repro_ingest_edges_total", "edges", tenant=tenant).inc(
            1000 * (i + 1))
        hub.gauge("repro_ingest_edges_per_s", "rate", tenant=tenant).set(
            12345.5 / (i + 1))
        hub.gauge("repro_queue_depth", "depth", tenant=tenant).set(3 + i)
        hub.gauge("repro_epoch", "epoch", tenant=tenant).set(7 * (i + 1))
        hub.counter("repro_queue_dropped_edges_total", "drops",
                    tenant=tenant).inc(i)
        pub = hub.histogram("repro_publish_latency_seconds", "publish",
                            tenant=tenant)
        for k in range(n_lat):
            pub.observe(0.0005 * (k + 1) * (i + 1))
    for key, n in (("offered_requests", 120), ("served_requests", 100),
                   ("shed_overload", 20), ("auth_failures", 1)):
        hub.counter(f"repro_query_{key}_total", key).inc(n)
    hub.gauge("repro_query_inflight", "inflight").set(5)
    lat = hub.histogram("repro_query_latency_seconds", "latency")
    for k in range(n_lat):
        lat.observe(1e-4 * (k + 1) ** 1.5)


def _payloads() -> dict:
    empty = {"prometheus": "", "state": {}, "ts": 0}
    _fill_hub()
    full = scrape_payload()
    reset_hub()
    _fill_hub(n_lat=0)
    no_latency = scrape_payload()
    return {"empty": empty, "full": full, "no_latency": no_latency}


@pytest.mark.parametrize("which", ["empty", "full", "no_latency"])
def test_parse_and_panels_equal_the_reference(which):
    payload = _payloads()[which]
    got = dashboard.parse_prometheus_text(payload["prometheus"])
    assert got == jdash.parse_prometheus_text(payload["prometheus"])
    if which != "empty":
        assert len(got) > 20
    assert dashboard.render_panels(payload) == jdash.render_panels(payload)
    # a JSON round trip (the --metrics-json file) renders the same
    again = json.loads(json.dumps(payload))
    assert dashboard.render_panels(again) == jdash.render_panels(payload)


@pytest.mark.parametrize("text", [
    "repro_x 1",
    "repro_x 1.5e-3\n# HELP repro_x help\n\nrepro_y{a=\"b\"} -Inf",
    'repro_x{a="1",b="two"} NaN',
    'repro_x{a="q\\"uote",b="back\\\\slash",c="new\\nline"} 3',
    "repro_x{} 2",
    # malformed: each must raise in both
    "repro_x",
    "repro_x one",
    "9bad 1",
    'repro_x{a="1" junk} 1',
    'repro_x{a=1} 1',
    "repro_x 1 2",
    'repro_x{a="1"',
])
def test_parser_accepts_and_refuses_what_the_reference_does(text):
    try:
        want = jdash.parse_prometheus_text(text)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            dashboard.parse_prometheus_text(text)
        assert str(got.value) == str(exc)
        return
    got = dashboard.parse_prometheus_text(text)
    # repr: NaN samples compare equal by spelling, not by value
    assert {k: repr(v) for k, v in got.items()} == {
        k: repr(v) for k, v in want.items()}


def test_json_once_reads_a_port_dump_and_fails_on_a_missing_file(tmp_path,
                                                                  capsys):
    _fill_hub()
    path = str(tmp_path / "metrics.json")
    dumper = MetricsJsonDumper(path, interval_s=0.05)
    dumper.start()
    time.sleep(0.15)
    dumper.stop()
    assert dumper.writes >= 3
    assert dashboard.main(["--json", path, "--once"]) == 0
    out = capsys.readouterr().out
    assert "ingest (per shard)" in out and TENANTS[0] in out
    assert "exposition samples parsed" in out
    assert dashboard.main(["--json", str(tmp_path / "absent.json"),
                           "--once"]) == 1
    assert "scrape failed" in capsys.readouterr().err


@pytest.fixture()
def front_end():
    t = SketchRegistry(depth=3, batch_size=1024, scale=0.02,
                       device="cpu").open("cit-HepPh", "gmatrix", 64)
    t.step(2)
    t.publish()
    server = QueryServer(QueryEngine(), lambda: t.snapshot).start()
    try:
        reqs = synth_requests(40, mix_for_sketch("gmatrix"),
                              n_nodes=t.stream.spec.n_nodes, seed=4,
                              heavy_universe=256)
        client = QueryClient(server.address)
        client.query(reqs)
        client.close()
        get_hub().counter("repro_ingest_edges_total", "edges",
                          tenant=TENANTS[0]).inc(2048)
        yield "{}:{}".format(*server.address)
    finally:
        server.stop()


def _panels(text: str) -> list[str]:
    """The rendered panel lines: after the timestamped header, before the
    sample count (each scrape adds the wire's byte counters for its own
    frames, so the second sees a few more samples)."""
    lines = text.strip().splitlines()
    assert lines[0].startswith("-- scrape @ ")
    assert lines[-1].endswith("exposition samples parsed)")
    return lines[1:-1]


def test_both_dashboards_scrape_a_port_front_end(front_end, capsys):
    assert dashboard.main(["--connect", front_end, "--once"]) == 0
    mine = capsys.readouterr().out
    assert jdash.main(["--connect", front_end, "--once"]) == 0
    ref = capsys.readouterr().out
    assert _panels(mine) == _panels(ref)
    assert f"  {TENANTS[0]:<40} {2048:>10}" in mine
    assert "offered_requests=40" in mine and "served_requests=40" in mine


def test_dashboard_cli_scrapes_once_and_fails_without_a_server(front_end):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    cmd = [sys.executable, "-m", "repro_torch.obs.dashboard", "--once",
           "--timeout-s", "5"]
    proc = subprocess.run(cmd + ["--connect", front_end], capture_output=True,
                          text=True, env=env, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert TENANTS[0] in proc.stdout and "latency ms: p50=" in proc.stdout
    proc = subprocess.run(cmd + ["--json", str(REPO / "no-such-metrics.json")],
                          capture_output=True, text=True, env=env,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 1 and "scrape failed" in proc.stderr
