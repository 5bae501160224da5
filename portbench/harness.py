"""The benchmark's harness: finds a cell's files by name, runs it, reads its
metrics and decides ``correct``.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own, found by the name in ``BENCHMARK.json``:

  configs/<config>.json     the deployment: sketch, budget, depth, plan,
                            stream, guarantees
  workloads/<cell>.json     the cell: its config, its traffic mix and the
                            mix's parameters it sets (such as a rate)
  traffic/<mix>.json        the mix: its ``kind`` and parameters
  traffic/<kind>.py         the loop of that kind: ``run(ctx)`` (set-up and
                            window) and ``check(ctx, run)`` (the reference)
  metrics/<metric>.py       ``read(run)``: the metric's number, or None
                            where the run holds nothing to read

A later cell, mix, configuration or metric is new files and new entries
in ``BENCHMARK.json``; no file here changes.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path
from typing import Any

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str):
    """Import a file of the benchmark by its path (its name may hold dots
    or dashes, as metric and mix names do)."""
    name = prefix + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    params: dict  # the mix's parameters, the cell's own laid over them
    kind: Any  # the module traffic/<kind>.py


def find_cell(name: str, root: Path = ROOT, overrides: dict | None = None
              ) -> Cell:
    """The cell's files; ``overrides`` lays parameters over the cell's own
    (the knee sweep's rates)."""
    cell = load_json(root / "workloads" / f"{name}.json")
    config = load_json(root / "configs" / f"{cell['config']}.json")
    mix = load_json(root / "traffic" / f"{cell['traffic']}.json")
    params = {**mix, **cell.get("params", {}), **(overrides or {})}
    kind = load_module(root / "traffic" / f"{mix['kind']}.py",
                       "portbench_kind_")
    return Cell(name, config, params, kind)


def cell_metrics(name: str, trace: bool, bench: dict) -> list[dict]:
    """The metrics ``BENCHMARK.json`` gives the cell: its end-to-end ones
    without a trace, its per-layer ones with."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if name in m.get("workloads", [name])]


@dataclasses.dataclass
class Run:
    """What a run leaves for the checks and the metric readers.  Times are
    seconds; ``trace`` is the ``TraceSlice`` of a ``--trace 1`` run."""

    attempted: int = 0
    failed: int = 0
    setup_s: float = 0.0
    window_s: float = 0.0
    edges_done: int = 0  # edges complete (and published, when serving)
    batches: list = dataclasses.field(default_factory=list)  # host batches
    stream: Any = None  # the benchmark's stream (a SyntheticStream)
    trace: Any = None
    slice_batches: list = dataclasses.field(default_factory=list)
    latencies_s: Any = None  # every request scheduled in the window
    requests: list = dataclasses.field(default_factory=list)
    slice_served: list = dataclasses.field(default_factory=list)  # (lo, hi, s)
    # the window before the profiled slice (all of it, untraced): each
    # execute's (lo, hi, s), the engine's {family: (seconds, groups)}
    unprofiled_served: list = dataclasses.field(default_factory=list)
    unprofiled_groups: dict = dataclasses.field(default_factory=dict)
    info: dict = dataclasses.field(default_factory=dict)
    program: dict = dataclasses.field(default_factory=dict)  # its outputs
    plan: Any = None  # the reference's plan and layout, set by ``check``
    layout: Any = None


@dataclasses.dataclass
class Context:
    """What a traffic kind's ``run`` and ``check`` are given."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device
    t_process: float  # perf_counter reading of the process's start
    module: Any = None  # a stand-in for the program's sketch module
    peak_bytes: int = 0

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def params(self) -> dict:
        return self.cell.params

    def read_peak(self) -> None:
        """Read the device's peak allocation; called when the window has
        closed, before the reference runs."""
        import torch
        if self.device.type == "cuda":
            self.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))


def process_start() -> float:
    """This process's start as a ``time.perf_counter`` reading (from
    ``/proc/self/stat``; the call's own time where that cannot be read)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load:
    JAX and the JAX package (``repro_torch`` is another name)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_process: float, *, module=None, root: Path = ROOT,
             overrides: dict | None = None) -> dict:
    """Run one cell and return its result: ``line`` (the contract's last
    line, without ``checks``), ``checks`` ({name: (value, limit)}) and
    ``info`` (the generator's lateness and what else goes on the line
    before the last).  ``module(program_module, ctx)`` makes a stand-in for
    the program's sketch module (the control, the fault tests)."""
    bench = load_json(root.parent / "BENCHMARK.json")
    cell = find_cell(name, root, overrides)
    ctx = Context(cell, seed, seconds, trace, device, t_process, module)
    run = cell.kind.run(ctx)
    gc.collect()
    import torch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.kind.check(ctx, run)
    metrics = {}
    for entry in cell_metrics(name, trace, bench):
        reader = load_module(root / "metrics" / f"{entry['name']}.py",
                             "portbench_metric_")
        value = reader.read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value),
                                      "unit": entry["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": 1, "memory_peak_bytes": ctx.peak_bytes}
    line = {"correct": all(v <= lim for v, lim in checks.values()),
            "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    return {"line": line, "checks": checks, "info": run.info}
