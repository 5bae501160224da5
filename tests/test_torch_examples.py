"""The port's examples against the JAX package's: ``quickstart`` and
``sketch_queries`` run on the CPU in a subprocess each, beside the
unchanged JAX example, and print the same lines (the ingest rates aside)."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
# the port's examples on one CPU thread: the suite runs files side by side,
# and a torch process takes every core by default
PORT_ENV = {**ENV, "OMP_NUM_THREADS": "1"}


def _start(cmd, env):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)


def run_pair(name: str, *args: str, timeout: float = 240):
    """Run the port's example and the JAX example at once; both must exit
    0.  Returns their standard outputs' lines."""
    port = _start([sys.executable, "-m", f"repro_torch.examples.{name}",
                   "--device", "cpu", *args], PORT_ENV)
    ref = _start([sys.executable, str(REPO / "examples" / f"{name}.py"),
                  *args], ENV)
    out = []
    for proc in (port, ref):
        try:
            stdout, stderr = proc.communicate(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        assert proc.returncode == 0, stderr[-3000:]
        out.append(stdout.splitlines())
    return out


def without_rates(lines):
    return [ln for ln in lines if "edges/s" not in ln and "tok/s" not in ln]


@pytest.mark.parametrize("name,n_lines,n_rates", [
    ("quickstart", 13, 3),
    ("sketch_queries", 7, 0),
])
def test_example_prints_the_jax_examples_lines(name, n_lines, n_rates):
    port, ref = run_pair(name)
    assert len(port) == len(ref) == n_lines
    assert len(port) - len(without_rates(port)) == n_rates
    assert without_rates(port) == without_rates(ref)
