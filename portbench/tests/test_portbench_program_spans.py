"""The program's spans as the benchmark reads them: the five per-layer
metrics from a small traced run of each cell (none with the spans off, as
on a program without them), and ``ProgramTraceSlice`` on fabricated
profiler events: ``repro.*`` ranges kept, their device-side shadows out of
the device's operations, and an idle gap named by its true innermost span
however deep the nesting."""
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from portbench.harness import REPO, load_json, process_start
from portbench.program_spans import ProgramTraceSlice, run_with_program_spans

from portbench_small import small_bench  # noqa: F401 (fixture)

BENCH = load_json(REPO / "BENCHMARK.json")
NEW = {m["name"]: m["workloads"] for m in BENCH["per_layer"]
       if m["name"] in ("from_numpy_us", "ingest_launch_us", "query_core_ms",
                        "engine_readback_ms", "publish_ms")}
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_the_five_metrics_are_listed_for_the_cells_that_read_them():
    assert sorted(NEW) == sorted(["from_numpy_us", "ingest_launch_us",
                                  "query_core_ms", "engine_readback_ms",
                                  "publish_ms"])
    assert NEW["from_numpy_us"] == NEW["ingest_launch_us"] == CELLS
    assert all(NEW[m] == ["kmatrix512.serve_firehose"]
               for m in ("query_core_ms", "engine_readback_ms", "publish_ms"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_each_metric_listed_for_its_cell(small_bench,
                                                            cell):
    # a serving window whose slice holds publishes on a loaded CPU (about
    # 15 on an idle one)
    seconds = 0.5 if "serve" in cell else 0.3
    out = run_with_program_spans(cell, 2**31 + 11, seconds,
                                 torch.device("cpu"), process_start(),
                                 root=small_bench)
    line = out["line"]
    assert line["correct"], out["checks"]
    want = {m for m, cells in NEW.items() if cell in cells}
    assert want <= set(line["metrics"])
    assert all(line["metrics"][m]["value"] > 0 for m in want)
    b = line["breakdown"]
    assert b["ingest_spans"] > 0 and b["device_ops_named_program"] == 0
    if "serve" in cell:
        assert {"engine.execute", "snapshot.publish"} <= set(b["program_sites"])


def test_with_the_spans_off_the_metrics_read_nothing(small_bench,
                                                     monkeypatch):
    from repro_torch.obs import profile
    monkeypatch.setattr(profile, "_profiler_on", lambda: False)
    out = run_with_program_spans("kmatrix512.serve_firehose", 5, 0.3,
                                 torch.device("cpu"), process_start(),
                                 root=small_bench)
    assert out["line"]["correct"], out["checks"]
    assert not set(NEW) & set(out["line"]["metrics"])
    assert out["line"]["breakdown"]["program_sites"] == {}


def _event(name, start_us, end_us, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start_us,
                                                      end=end_us))


def test_program_ranges_kept_shadows_dropped_deep_gap_named_exactly():
    depth = 70  # past the 64 spans the benchmark's own look-back covers
    events = [_event("pb.execute", 0, 1000, annotation=True),
              _event("repro.engine.execute", 1, 999, annotation=True)]
    events += [_event(f"repro.query.d{k}", 2 + k, 998 - k, annotation=True)
               for k in range(depth)]
    # the device: kernels at 100-110, 500-510 and 900-1000 (two gaps inside
    # every span); shadows of the ranges, flagged and not
    events += [_event("kern", 100, 110, DeviceType.CUDA),
               _event("kern", 500, 510, DeviceType.CUDA),
               _event("kern", 900, 1000, DeviceType.CUDA),
               _event("repro.engine.execute", 100, 1000, DeviceType.CUDA,
                      annotation=True),
               _event("repro.query.d3", 100, 510, DeviceType.CUDA)]
    tr = ProgramTraceSlice(torch.device("cpu"), None)
    tr._read(events)
    assert [n for n, _, _ in tr.device_ops] == ["kern"] * 3
    assert tr.device_ops_named_program == 1
    assert len(tr.program_spans) == depth + 1
    assert tr.program_spans[0] == ("engine.execute", pytest.approx(1e-6),
                                   pytest.approx(999e-6))
    b = tr.breakdown()
    gaps = dict(b["program_idle_gaps"])
    assert gaps == pytest.approx({f"repro.query.d{depth - 1}": 780e-6})
    assert b["idle_in_pb_named_by_program"] == 1.0
    assert b["idle_in_execute_below_engine_execute"] == 1.0
    assert b["program_sites"]["query.d0"]["count"] == 1


def test_idle_time_is_charged_piece_by_piece_to_the_span_open_over_it():
    # one gap (10-90) over pb.ingest (0-100), which holds
    # repro.sketch.ingest (20-60), which holds repro.dispatch.check (30-40)
    events = [_event("pb.ingest", 0, 100, annotation=True),
              _event("repro.sketch.ingest", 20, 60),
              _event("repro.dispatch.check", 30, 40),
              _event("kern", 0, 10, DeviceType.CUDA),
              _event("kern", 90, 100, DeviceType.CUDA)]
    tr = ProgramTraceSlice(torch.device("cpu"), None)
    tr._read(events)
    b = tr.breakdown()
    assert dict(b["program_idle_gaps"]) == pytest.approx(
        {"ingest": 40e-6, "repro.sketch.ingest": 30e-6,
         "repro.dispatch.check": 10e-6})
    assert b["idle_in_pb_named_by_program"] == pytest.approx(0.5)
