"""What the command loads: never JAX nor the JAX package ``repro`` (by
whole top-level name: ``repro_torch`` is another), and the reference never
the program; without a card, or without the port, the command fails and
prints no result."""
import ast
import os
import shutil
import subprocess
import sys

from portbench.harness import REPO

ROOT = REPO / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in ROOT.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] != "repro_torch", (path, name)
            assert name not in ("portbench.program", "portbench.harness"), (
                path, name)


SCRIPT = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
from portbench import harness, program, run, control, sweep, trace, roofline
program.import_port()
import portbench_small as small
root = small.make_small_bench(__import__("pathlib").Path(sys.argv[2]))
for cell in ("kmatrix512.bulk_ingest", "kmatrix512.serve_firehose"):
    out = small.run_small(root, cell, seconds=0.2, trace=True)
    assert out["line"]["correct"], out["checks"]
print(",".join(harness.forbidden_modules()) or "none")
"""


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(ROOT / "tests"), str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "none"


def _command(cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "kmatrix512.bulk_ingest", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_without_a_card_the_command_fails_and_prints_no_result():
    out = _command(REPO)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA card" in out.stderr


def test_with_only_the_benchmark_the_command_fails(tmp_path):
    shutil.copytree(ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _command(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
