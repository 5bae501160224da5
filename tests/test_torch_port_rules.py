"""The port's own rules: no JAX and no reference package in the port, the
card as the default device, and launch counters that count only launches."""
import ast
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import interop
from repro_torch.common.hashing import HashFamily
from repro_torch.core import EdgeBatch, KMatrix, KMatrixAccel
from repro_torch.core import kmatrix_accel as tkma
from repro_torch.core import queries as tq
from repro_torch.core import vertex_stats_from_sample
from repro_torch.core.routing import route_table_from_plan
from repro_torch.kernels import build, matrix_ingest, reach_step
from repro_torch.launch import stream_ingest
from repro_torch.serving.registry import build_sketch
from repro_torch.streams import make_stream
from repro_torch.streams.generators import SyntheticStream

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("fn", [
    KMatrix.create, KMatrixAccel.create, HashFamily.create,
    EdgeBatch.from_numpy, build_sketch, route_table_from_plan,
    interop.import_state, SyntheticStream.batch,
], ids=lambda f: f.__qualname__)
def test_constructors_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cli_defaults_to_cuda_and_refuses_without_a_card():
    assert stream_ingest.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.stream_ingest",
         "--scale", "0.03", "--eval-queries", "10"],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "--device cpu" in proc.stderr
    assert '"ARE"' not in proc.stdout


def test_launch_counters_stay_zero_on_cpu_tensors():
    matrix_ingest.launches = reach_step.launches = 0
    stream = make_stream("cit-HepPh", batch_size=1024, scale=0.01)
    s, d, w = stream.batch_numpy(0)
    sk = KMatrixAccel.create(bytes_budget=1 << 16,
                             stats=vertex_stats_from_sample(s, d, w),
                             depth=3, device="cpu")
    tkma.ingest(sk, stream.batch(0, device="cpu"))
    closure = tq.build_closure(tq.closure_layers(sk))
    assert closure.shape == sk.conn.shape
    assert int(sum(int(p.sum()) for p in sk.pools)) == 3 * int(w.sum())
    assert matrix_ingest.launches == 0 and reach_step.launches == 0


def test_wrappers_refuse_other_devices():
    pool = torch.zeros((1, 1, 4, 4), dtype=torch.int32, device="meta")
    hi = torch.zeros((1, 1, 8), dtype=torch.int32, device="meta")
    wt = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        matrix_ingest(pool, hi, hi, wt)
    with pytest.raises(ValueError, match="cuda or cpu"):
        reach_step(torch.zeros((1, 4, 4), device="meta"))
    assert matrix_ingest.launches == 0 and reach_step.launches == 0


def test_kernel_libraries_are_named_by_content_and_need_nvcc():
    paths = {name: build.library_path(name) for name in build.KERNELS}
    for name, path in paths.items():
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").exists()
    assert len(set(paths.values())) == len(paths)
    cuda_nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "nvcc")
    if shutil.which("nvcc") or os.path.exists(cuda_nvcc):
        pytest.skip("nvcc is installed here: the kernels can be built")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
