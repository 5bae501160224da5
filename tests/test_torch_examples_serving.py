"""The port's serving and training examples on the CPU: ``query_serving``
prints the unchanged JAX example's lines; ``background_ingest`` and
``train_lm --tiny --steps 20`` run to their end (exit 0)."""
from __future__ import annotations

import subprocess
import sys

import pytest

from test_torch_examples import PORT_ENV, REPO, run_pair, without_rates


def test_query_serving_prints_the_jax_examples_lines():
    port, ref = run_pair("query_serving")
    assert len(port) == len(ref) == 6
    assert without_rates(port) == port
    assert port == ref


@pytest.mark.parametrize("name,args,last", [
    ("background_ingest", (),
     "crash -> restore -> resume is bit-identical to a clean run ✓"),
    ("train_lm", ("--tiny", "--steps", "20"), "loss "),
])
def test_example_runs_to_its_end_on_the_cpu(name, args, last):
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device",
         "cpu", *args], capture_output=True, text=True, env=PORT_ENV, cwd=REPO,
        timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1].startswith(last), proc.stdout
