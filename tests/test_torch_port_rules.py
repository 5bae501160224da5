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

import test_torch_baselines
import test_torch_checkpoint
from repro_torch import interop
from repro_torch.common.hashing import HashFamily
from repro_torch.core import (
    CountMin,
    EdgeBatch,
    GSketch,
    KMatrix,
    KMatrixAccel,
    MatrixSketch,
)
from repro_torch.core import kmatrix_accel as tkma
from repro_torch.core import matrix_sketch as tms
from repro_torch.core import queries as tq
from repro_torch.core import vertex_stats_from_sample
from repro_torch.core.routing import route_table_from_plan
from repro_torch.configs.registry import build_fm_cell
from repro_torch.kernels import (
    build,
    embedding_bag,
    matrix_ingest,
    matrix_ingest_edges,
    matrix_lookup,
    matrix_lookup_edges,
    reach_closure,
    reach_step,
)
from repro_torch.launch import query_serve, stream_ingest
from repro_torch.models.recsys import fm as tfm
from repro_torch.serving import QueryEngine, SketchRegistry, synth_requests
from repro_torch.serving import ShardStreamView
from repro_torch.serving import WorkloadMix
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


# the modules of the runtime and sharding slice, copies included: each is
# in the scan above (which covers every file of the port)
RUNTIME_SLICE = ["obs/trace.py", "obs/profile.py", "runtime/__init__.py",
                 "runtime/queueing.py", "runtime/policies.py",
                 "runtime/metrics.py", "runtime/worker.py",
                 "runtime/backend.py", "runtime/supervisor.py",
                 "serving/sharding.py"]


@pytest.mark.parametrize("module", RUNTIME_SLICE)
def test_runtime_slice_modules_are_scanned(module):
    path = REPO / "src" / "repro_torch" / module
    assert path in PORT_FILES
    test_port_imports_neither_jax_nor_reference(path)


def test_only_items_12_and_13b_stay_refused_by_query_serve():
    items = {item for _, _, item in query_serve._LATER}
    assert items == {"12", "13b"}
    flags = {flag for flag, _, _ in query_serve._LATER}
    assert "--background-ingest" not in flags and "--shards" not in flags
    assert "--runtime-backend" in flags and "--serve" in flags
    assert "--metrics-json" in flags


@pytest.mark.parametrize("fn", [
    KMatrix.create, KMatrixAccel.create, HashFamily.create,
    EdgeBatch.from_numpy, build_sketch, route_table_from_plan,
    interop.import_state, SyntheticStream.batch, MatrixSketch.create,
    CountMin.create, GSketch.create, SyntheticStream.iter_from,
    tq.heavy_nodes, tfm.init_params, build_fm_cell, interop.fm_params_from_jax,
    SketchRegistry.__init__, interop.snapshot_state_from_jax,
    ShardStreamView.batch, ShardStreamView.iter_from,
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


def test_query_serve_cli_defaults_to_cuda_and_refuses_without_a_card():
    assert query_serve.parse_args([]).device == "cuda"
    assert SketchRegistry().config()["device"] == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.query_serve",
         "--scale", "0.03", "--n-requests", "10"],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "--device cpu" in proc.stderr
    assert '"achieved_qps"' not in proc.stdout


def test_serving_path_launches_nothing_on_cpu_tensors():
    for fn in (matrix_ingest, matrix_ingest_edges, matrix_lookup,
               matrix_lookup_edges, reach_step, reach_closure, embedding_bag):
        fn.launches = 0
    reg = SketchRegistry(depth=3, batch_size=1024, scale=0.01, device="cpu")
    for kind in ("kmatrix", "gmatrix"):
        t = reg.open("cit-HepPh", kind, 32)
        t.step(2)
        snap = t.publish()
        reqs = synth_requests(64, WorkloadMix(), n_nodes=t.stream.spec.n_nodes,
                              heavy_universe=128)
        assert len(QueryEngine().execute(snap, reqs)) == 64
    assert matrix_ingest_edges.launches == matrix_lookup_edges.launches == 0
    assert reach_closure.launches == reach_step.launches == 0
    assert matrix_ingest.launches == matrix_lookup.launches == 0


def test_launch_counters_stay_zero_on_cpu_tensors():
    matrix_ingest.launches = matrix_lookup.launches = reach_step.launches = 0
    embedding_bag.launches = reach_closure.launches = 0
    matrix_ingest_edges.launches = matrix_lookup_edges.launches = 0
    stream = make_stream("cit-HepPh", batch_size=1024, scale=0.01)
    s, d, w = stream.batch_numpy(0)
    sk = KMatrixAccel.create(bytes_budget=1 << 16,
                             stats=vertex_stats_from_sample(s, d, w),
                             depth=3, device="cpu")
    tkma.ingest(sk, stream.batch(0, device="cpu"))
    closure = tq.build_closure(tq.closure_layers(sk))
    assert closure.shape == sk.conn.shape
    assert int(sum(int(p.sum()) for p in sk.pools)) == 3 * int(w.sum())
    gm = MatrixSketch.create(bytes_budget=1 << 16, depth=3, device="cpu")
    tms.ingest(gm, stream.batch(0, device="cpu"))
    assert int(gm.table.sum()) == 3 * int(w.sum())
    est = tms.edge_freq(gm, torch.as_tensor(s), torch.as_tensor(d))
    assert bool((est >= 1).all())
    assert tq.reachability(gm, torch.as_tensor(s), torch.as_tensor(d)).all()
    assert matrix_ingest.launches == matrix_lookup.launches == 0
    assert matrix_ingest_edges.launches == matrix_lookup_edges.launches == 0
    assert reach_step.launches == reach_closure.launches == 0
    cfg = tfm.FMConfig(total_vocab=5_000, n_fields=7)
    fm = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ids = torch.randint(0, 1 << 30, (4, 7), dtype=torch.int32)
    assert tfm.retrieval_scores(cfg, fm, ids[0], ids).shape == (4,)
    assert embedding_bag.launches == 0


def test_wrappers_refuse_other_devices():
    pool = torch.zeros((1, 1, 4, 4), dtype=torch.int32, device="meta")
    hi = torch.zeros((1, 1, 8), dtype=torch.int32, device="meta")
    wt = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        matrix_ingest(pool, hi, hi, wt)
    with pytest.raises(ValueError, match="cuda or cpu"):
        reach_step(torch.zeros((1, 4, 4), device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        reach_closure(torch.zeros((1, 4, 4), dtype=torch.int32,
                                  device="meta"), 1)
    with pytest.raises(ValueError, match="cuda or cpu"):
        matrix_lookup(pool, hi, hi)
    ab = torch.zeros(1, dtype=torch.int64, device="meta")
    ids = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        matrix_ingest_edges((pool,), ab, ab, ids, ids, ids)
    with pytest.raises(ValueError, match="cuda or cpu"):
        matrix_lookup_edges(pool[:, 0], ab, ab, ids, ids)
    with pytest.raises(ValueError, match="cuda or cpu"):
        embedding_bag(torch.zeros((4, 10), device="meta"),
                      torch.zeros((2, 3), dtype=torch.int32, device="meta"))
    assert matrix_ingest.launches == 0 and reach_step.launches == 0
    assert matrix_lookup.launches == 0 and embedding_bag.launches == 0
    assert reach_closure.launches == 0
    assert matrix_ingest_edges.launches == matrix_lookup_edges.launches == 0


def _flag(flags, name):
    return int(flags[flags.index(name) + 1])


@pytest.mark.parametrize("budget,depth", [
    (test_torch_baselines.BUDGET, test_torch_baselines.DEPTH),
    (_flag(test_torch_baselines.FLAGS, "--budget-kb") * 1024,
     _flag(test_torch_baselines.FLAGS, "--depth")),
    (_flag(test_torch_checkpoint.FLAGS, "--budget-kb") * 1024,
     _flag(test_torch_checkpoint.FLAGS, "--depth")),
    (40 * 1024, 3),  # test_torch_checkpoint._sketches
])
def test_parity_widths_stay_below_2_16(budget, depth):
    """The JAX package's fastrange computes (h * w) >> 32 in 16-bit limbs
    that can overflow for wide ranges (ROADMAP C); the parity tests hold
    every CountMin / gSketch width below 2^16, where it is exact."""
    cm = CountMin.create(bytes_budget=budget, depth=depth, device="cpu")
    assert cm.w < 2**16
    stream = make_stream("cit-HepPh", batch_size=4096, scale=0.03)
    gs = GSketch.create(bytes_budget=budget, depth=depth,
                        stats=vertex_stats_from_sample(*stream.batch_numpy(0)),
                        device="cpu")
    assert int(gs.route.widths.max()) <= cm.w < 2**16


def test_kernel_libraries_are_named_by_content_and_need_nvcc():
    assert build.KERNELS == ("matrix_ingest", "matrix_lookup", "reach_closure",
                             "embedding_bag")
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


def test_library_path_follows_every_header(tmp_path, monkeypatch):
    """A library is named by its source and every csrc header: editing
    ``sketch_addr.cuh`` renames both libraries that include it, so a stale
    build is never loaded."""
    for kernel in ("matrix_ingest", "matrix_lookup"):
        assert '#include "sketch_addr.cuh"' in (
            build.CSRC / f"{kernel}.cu").read_text()
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.KERNELS}
    assert before == {name: build.library_path(name) for name in build.KERNELS}
    header = csrc / "sketch_addr.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.KERNELS}
    assert all(after[name] != before[name] for name in build.KERNELS)
    (csrc / "new_helper.cuh").write_text("#pragma once\n")
    assert build.library_path("matrix_ingest") != after["matrix_ingest"]
