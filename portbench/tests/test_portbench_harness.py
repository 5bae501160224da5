"""The harness: every cell runs and comes out correct at a small size, a
configuration, a cell and a metric are found as new files with no code
edited, and ``BENCHMARK.json`` keeps to the names its contract allows."""
import json
import re

import pytest

from portbench.harness import REPO, load_json

from portbench_small import run_small, small_bench  # noqa: F401 (fixture)

BENCH = load_json(REPO / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_correct_at_a_small_size(small_bench, cell, trace):
    out = run_small(small_bench, cell, trace=trace, seconds=1.0)
    line, checks = out["line"], out["checks"]
    assert line["correct"], checks
    assert all(limit == 0 for _, limit in checks.values())
    names = {m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= names
    if not trace:
        # the CPU has no launch counters or device trace; the host-clock
        # end-to-end metrics are all there
        assert set(line["metrics"]) == names
        # a loaded CPU may publish nothing in a second; the card always does
        assert all(m["value"] >= 0 for m in line["metrics"].values())
        assert line["metrics"]["setup_s"]["value"] > 0
    assert line["attempted"] > 0 and line["failed"] == 0


def test_new_files_add_a_config_a_cell_and_a_metric(small_bench):
    """Everything a later PR adds is files and entries: a configuration,
    a mix, a cell and a per-layer metric, found by name."""
    root = small_bench
    config = load_json(root / "configs" / "gmatrix-cit-hepph-512kb.json")
    config.update(name="gmatrix-wide", budget_kb=128)
    (root / "configs" / "gmatrix-wide.json").write_text(json.dumps(config))
    mix = load_json(root / "traffic" / "serve_firehose.json")
    mix["mix"] = {**mix["mix"], "edge_freq": 0.15, "reach": 0.65}
    (root / "traffic" / "serve_reach.json").write_text(json.dumps(
        {**mix, "publish_every": 1}))
    (root / "workloads" / "gwide.serve_reach.json").write_text(json.dumps(
        {"config": "gmatrix-wide", "traffic": "serve_reach",
         "params": {"qps": 300}}))
    (root / "metrics" / "answers_checked.py").write_text(
        "def read(run):\n    return run.info.get('answers_checked')\n")
    bench = load_json(root.parent / "BENCHMARK.json")
    bench["workloads"].append({"name": "gwide.serve_reach",
                               "config": "gmatrix-wide",
                               "traffic": "serve_reach", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][1]["workloads"].append("gwide.serve_reach")
    bench["per_layer"].append({"name": "answers_checked", "unit": "answers",
                               "better": "higher", "source": "host_clock",
                               "layer": "client", "moves": "query_p95_ms",
                               "workloads": ["gwide.serve_reach"]})
    (root.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    plain = run_small(root, "gwide.serve_reach")
    assert plain["line"]["correct"], plain["checks"]
    assert set(plain["line"]["metrics"]) == {"ingest_medges_per_s",
                                             "query_p95_ms", "setup_s"}
    traced = run_small(root, "gwide.serve_reach", trace=True)
    value = traced["line"]["metrics"]["answers_checked"]["value"]
    assert value == traced["line"]["attempted"] > 0


@pytest.mark.parametrize("cell", [c for c in CELLS if "serve" in c])
def test_host_clock_layer_metrics_leave_the_profiled_slice_out(small_bench,
                                                               cell):
    """A traced run reads ``query_p50_ms``, ``engine_execute_ms`` and
    ``engine_group_ms.edge_freq`` from the window before the profiled
    slice: no request of the slice is among those they read."""
    root = small_bench
    path = root / "traffic" / "serve_firehose.json"
    path.write_text(json.dumps({**load_json(path), "trace_slice_s": 0.3}))
    (root / "metrics" / "slice_overlap.py").write_text(
        "def read(run):\n"
        "    ids = lambda log: {i for lo, hi, _ in log for i in range(lo, hi)}\n"
        "    return len(ids(run.unprofiled_served) & ids(run.slice_served))\n")
    bench = load_json(root.parent / "BENCHMARK.json")
    bench["per_layer"].append({"name": "slice_overlap", "unit": "requests",
                               "better": "lower", "source": "host_clock",
                               "layer": "client", "moves": "query_p95_ms",
                               "workloads": [cell]})
    (root.parent / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_small(root, cell, trace=True, seconds=1.2)
    metrics = out["line"]["metrics"]
    assert out["line"]["correct"], out["checks"]
    for name in ("query_p50_ms", "engine_execute_ms",
                 "engine_group_ms.edge_freq"):
        assert metrics[name]["value"] > 0, name
    assert metrics["slice_overlap"]["value"] == 0


def test_cell_files_agree_with_the_benchmark():
    root = REPO / "portbench"
    for w in BENCH["workloads"]:
        cell = load_json(root / "workloads" / f"{w['name']}.json")
        assert (cell["config"], cell["traffic"]) == (w["config"], w["traffic"])
        assert (root / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1
    for c in BENCH["configs"]:
        config = load_json(REPO / c["file"])
        assert config["name"] == c["name"] and config["source"] == c["source"]
        assert set(c["reduced"]) == set(config["reduced"])
        assert c["file"].startswith("portbench/")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (root / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_names_and_units_use_only_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in BENCH[kind]]
        assert len(got) == len(set(got))
    texts = ([w["why"] for w in BENCH["workloads"]]
             + [c["why"] for c in BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"])
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert all(m["moves"] in e2e for m in BENCH["per_layer"])
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for c in BENCH["configs"]:
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
