"""Helpers of the benchmark's CPU tests: small configurations of the same
shape and a copy of the benchmark that runs them.

The tests drive the reference against the program's CPU path, the
harness's discovery by name, the imports, the control and the faults that
must turn ``correct`` false.  The benchmark itself runs only on a card;
these tests drive its parts at small sizes on the CPU.  Import it as
``from portbench_small import ...`` (a test module's own directory is on
the path); the fixture ``small_bench`` is imported into each test module
that uses it."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
if str(REPO / "src") not in sys.path:
    sys.path.insert(0, str(REPO / "src"))

def small_config(kind: str) -> dict:
    """A configuration of the same shape at a size the CPU runs in a
    fraction of a second: a tenth of the stream (3,454 nodes, 42,157
    edges, a 3,000-edge sample), 64 KB and three layers."""
    src = REPO / "portbench" / "configs" / f"{kind}-cit-hepph-512kb.json"
    config = json.loads(src.read_text())
    config.update(name=f"{kind}-small", budget_kb=64, depth=3, scale=0.1)
    return config


@pytest.fixture
def small_bench(tmp_path):
    """``make_small_bench`` in the test's temporary directory."""
    return make_small_bench(tmp_path)


@pytest.fixture
def full_bench(tmp_path):
    """``make_small_bench(..., full_size=True)`` in the test's temporary
    directory."""
    return make_small_bench(tmp_path, full_size=True)


def make_small_bench(tmp_path: Path, *, full_size: bool = False) -> Path:
    """A copy of the benchmark (``BENCHMARK.json`` and ``portbench/``, its
    tests left out) whose cells run small configurations, or with
    ``full_size`` the cells' own configurations at a low rate: returns the
    copy's ``portbench`` directory."""
    root = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", root,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for cell in root.glob("workloads/*serve_firehose.json"):
        spec = json.loads(cell.read_text())
        spec["params"]["qps"] = 400
        cell.write_text(json.dumps(spec))
    if full_size:
        return root
    for kind in ("kmatrix", "gmatrix"):
        name = f"{kind}-cit-hepph-512kb"
        (root / "configs" / f"{name}.json").write_text(
            json.dumps(small_config(kind)))
    for mix, params in (("bulk_ingest", {"batch_edges": 16384}),
                        ("serve_firehose", {"batch_edges": 16384,
                                            "heavy_universe": 1024})):
        path = root / "traffic" / f"{mix}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()),
                                    **params}))
    return root


def run_small(root: Path, name: str, *, seconds: float = 0.4,
              trace: bool = False, seed: int = 2**31 + 7, module=None):
    import torch

    from portbench import harness
    return harness.run_cell(name, seed, seconds, trace, torch.device("cpu"),
                            harness.process_start(), module=module,
                            root=root)
