"""The control of ``correct``: the reference's ingest in the program's
place with its counters in float16 must come out not correct in every
cell.  Here at the cells' own configurations, a low rate and a short
window on the CPU (a small configuration keeps its counters below the
2,048 that float16 holds exactly); the chip runs it at the cells' own
sizes with ``python3 -m portbench.control``."""
import pytest

from portbench.control import control_module
from portbench.harness import REPO, load_json

from portbench_small import full_bench, run_small  # noqa: F401 (fixture)

CELLS = [w["name"] for w in load_json(REPO / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_float16_control_is_not_correct(full_bench, cell):
    out = run_small(full_bench, cell, seconds=0.3, module=control_module)
    checks = out["checks"]
    assert not out["line"]["correct"]
    sketch = checks.get("sketch_mismatches", checks.get("front_mismatches"))
    assert sketch[0] > 0
    parts = out["info"].get("sketch_mismatches_by_part",
                            out["info"].get("front_mismatches_by_part"))
    assert set(parts) == {"counters"}  # the plan is the reference's
