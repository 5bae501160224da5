"""The port's own rules: no JAX and no reference package in the port, the
card as the default device, and launch counters that count only launches."""
import ast
import importlib
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
from repro_torch.distributed import choose_topology, group, run_ranks
from repro_torch.distributed import mesh_ops, sketch_parallel
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import query_serve, stream_ingest
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import model as tmodel
from repro_torch.net.ingest_server import WorkerServer, serve_worker_session
from repro_torch.runtime.backend import run_ingest_worker
from repro_torch.models.recsys import fm as tfm
from repro_torch.serving import QueryEngine, SketchRegistry, synth_requests
from repro_torch.serving import ShardStreamView
from repro_torch.serving import WorkloadMix
from repro_torch.serving.registry import build_sketch
from repro_torch.streams import make_stream
from repro_torch.streams.generators import FileStream, SyntheticStream

from repro_torch.configs import registry as tregistry
from repro_torch.models.gnn import (equiformer_v2, gatedgcn, graph as tgraph,
                                    graphcast, nequip)

_GNN_CONSTRUCTORS = [tgraph.synthetic_graph, gatedgcn.init_params,
                     graphcast.init_params, nequip.init_params,
                     equiformer_v2.init_params, tregistry.init_gnn_params,
                     tregistry.gnn_batch, tregistry.build_gnn_cell,
                     interop.gnn_params_from_jax]

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
                 "serving/sharding.py",
                 # the network tier and the metrics dump
                 "net/__init__.py", "net/wire.py", "net/backend.py",
                 "net/ingest_server.py", "net/query_server.py",
                 "obs/dump.py", "serving/loadgen.py",
                 # distribution and the dashboard
                 "distributed/__init__.py", "distributed/group.py",
                 "distributed/sketch_parallel.py", "launch/mesh.py",
                 "obs/dashboard.py"]


@pytest.mark.parametrize("module", RUNTIME_SLICE)
def test_runtime_slice_modules_are_scanned(module):
    path = REPO / "src" / "repro_torch" / module
    assert path in PORT_FILES
    test_port_imports_neither_jax_nor_reference(path)


# the training slice: the optimizer and steps, the transformer family, its
# drivers and configs
TRAINING_SLICE = ["training/__init__.py", "training/optimizer.py",
                  "training/steps.py", "models/transformer/__init__.py",
                  "models/transformer/config.py",
                  "models/transformer/attention.py",
                  "models/transformer/moe.py", "models/transformer/model.py",
                  "configs/lm.py", "launch/serve.py", "launch/train.py"]


@pytest.mark.parametrize("module", TRAINING_SLICE)
def test_training_slice_modules_are_scanned(module):
    test_runtime_slice_modules_are_scanned(module)


# the GNN family: its models, the numpy copies, the configs and losses that
# name it, interop and the smoke
GNN_SLICE = ["models/gnn/__init__.py", "models/gnn/graph.py",
             "models/gnn/sampler.py", "models/gnn/so3.py",
             "models/gnn/chunked.py", "models/gnn/gatedgcn.py",
             "models/gnn/graphcast.py", "models/gnn/nequip.py",
             "models/gnn/equiformer_v2.py", "configs/shapes.py",
             "configs/registry.py", "training/steps.py", "interop.py",
             "launch/smoke.py"]


@pytest.mark.parametrize("module", GNN_SLICE)
def test_gnn_slice_modules_are_scanned(module):
    test_runtime_slice_modules_are_scanned(module)


# the shardings slice: the specs, the mesh's per-rank collectives, the
# cells and the dry run, and the modules whose mesh variants it added
SHARDINGS_SLICE = ["launch/shardings.py", "launch/dryrun.py",
                   "distributed/mesh_ops.py", "distributed/group.py",
                   "configs/registry.py", "configs/shapes.py",
                   "models/transformer/model.py", "models/transformer/moe.py",
                   "models/transformer/attention.py", "training/steps.py"]


@pytest.mark.parametrize("module", SHARDINGS_SLICE)
def test_shardings_slice_modules_are_scanned(module):
    test_runtime_slice_modules_are_scanned(module)


# the analysis gate and the examples
ANALYSIS_SLICE = ["analysis/__init__.py", "analysis/__main__.py",
                  "analysis/engine.py", "analysis/wire_schema.py",
                  "analysis/pickle_rules.py", "analysis/locks.py",
                  "analysis/trace_purity.py", "analysis/isolation.py",
                  "analysis/witness.py", "examples/__init__.py",
                  "examples/quickstart.py", "examples/sketch_queries.py",
                  "examples/query_serving.py", "examples/background_ingest.py",
                  "examples/train_lm.py"]
EXAMPLES = ["quickstart", "sketch_queries", "query_serving",
            "background_ingest", "train_lm"]


@pytest.mark.parametrize("module", ANALYSIS_SLICE)
def test_analysis_slice_modules_are_scanned(module):
    test_runtime_slice_modules_are_scanned(module)


# the reference's last public surface: FileStream, the core helpers, the
# aliases and the driver's stream-taking pipeline
SURFACE_SLICE = ["streams/generators.py", "streams/__init__.py",
                 "core/types.py", "core/routing.py", "core/partitioning.py",
                 "core/__init__.py", "common/struct.py", "common/__init__.py",
                 "kernels/ops.py", "kernels/__init__.py", "models/common.py",
                 "models/recsys/fm.py", "models/recsys/__init__.py",
                 "serving/registry.py", "launch/stream_ingest.py"]


@pytest.mark.parametrize("module", SURFACE_SLICE)
def test_surface_slice_modules_are_scanned(module):
    test_runtime_slice_modules_are_scanned(module)


def test_analysis_slice_holds_the_reference_modules():
    """Every module of the JAX package's analysis has a port counterpart,
    ``donation.py`` as ``isolation.py``; every JAX example but
    ``distributed_sketch`` (``distributed/demo.py``) has one."""
    ref = {p.name for p in (REPO / "src" / "repro" / "analysis").glob("*.py")}
    port = {p.name for p in (REPO / "src" / "repro_torch" / "analysis").glob("*.py")}
    assert port == ref - {"donation.py"} | {"isolation.py"}
    ref_ex = {p.stem for p in (REPO / "examples").glob("*.py")}
    assert ref_ex - set(EXAMPLES) == {"distributed_sketch"}


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_default_to_cuda_and_refuse_without_a_card(name):
    module = importlib.import_module(f"repro_torch.examples.{name}")
    assert "--device cpu" in module.__doc__
    if torch.cuda.is_available():
        pytest.skip("a card is present: the example runs on it")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}"],
        capture_output=True, text=True, env=env, timeout=120, cwd=REPO)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "--device cpu" in proc.stderr
    assert proc.stdout == ""


def test_the_dry_run_is_the_one_entry_point_off_the_card():
    """``launch/dryrun.py`` traces cells as rank 0 of fake ranks, on tensors
    without storage: a plan for 256 or 512 cards, not work on this one.
    It is the one named exception to the card default, and no other module
    of the port starts fake ranks."""
    from repro_torch.launch import dryrun, shardings

    port = REPO / "src" / "repro_torch"
    users = sorted(p.relative_to(port).as_posix() for p in PORT_FILES
                   if "fake_ranks(" in p.read_text() and p.is_relative_to(port))
    assert users == ["distributed/group.py", "launch/dryrun.py"]
    assert "does not run on the" in dryrun.__doc__
    assert "card" in dryrun.__doc__.split("does not run on the")[1][:20]
    for fn in (tregistry.build_cell, tregistry.build_lm_cell,
               shardings.lm_param_specs, shardings.shard_tree):
        assert "device" not in inspect.signature(fn).parameters, fn.__name__


def test_gnn_slice_holds_every_module_of_the_jax_family():
    ref = sorted(p.name for p in (REPO / "src" / "repro" / "models" / "gnn").glob("*.py"))
    port = sorted(p.name for p in (REPO / "src" / "repro_torch" / "models" / "gnn").glob("*.py"))
    assert port == ref and len(port) == 9
    assert {f"models/gnn/{n}" for n in port} <= set(GNN_SLICE)


def test_gnn_path_launches_nothing_on_cpu_tensors():
    """The GNN family reaches no TPU kernel: a train step of each model and
    NequIP's forces launch no kernel (on the CPU, nor on the card: phase M
    of chip_smoke.py reads the same counters there)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.models.gnn import nequip

    wrappers = [matrix_ingest, matrix_ingest_edges, matrix_lookup,
                matrix_lookup_edges, reach_step, reach_closure, embedding_bag]
    from repro_torch.kernels import embedding_bag_backward
    wrappers.append(embedding_bag_backward)
    for fn in wrappers:
        fn.launches = 0
    small = {"gatedgcn": dict(n_layers=1, d_hidden=8),
             "graphcast": dict(n_layers=1, d_hidden=8, latent_dtype="float32"),
             "nequip": dict(n_layers=1, d_hidden=4, edge_chunk=4096),
             "equiformer-v2": dict(n_layers=1, d_hidden=8, l_max=2, n_heads=2,
                                   edge_chunk=4096)}
    for arch, kw in small.items():
        cfg = dataclasses.replace(registry.archs()[arch].config, **kw)
        gen = torch.Generator().manual_seed(0)
        params = registry.init_gnn_params(arch, cfg, gen, 16, "cpu")
        cell = registry.build_gnn_cell(arch, "molecule", params,
                                       np.random.default_rng(0), "cpu", cfg=cfg)
        assert torch.isfinite(cell.run()["loss"])
        if arch == "nequip":
            _, f = nequip.energy_and_forces(cfg, params, cell.inputs[0]["graph"])
            assert f.shape == (4_096, 3)
    assert all(fn.launches == 0 for fn in wrappers)


def test_training_path_launches_nothing_on_cpu_tensors():
    from repro_torch.kernels import embedding_bag_backward
    from repro_torch.training import AdamWConfig, init_train_state
    from repro_torch.training import make_train_step
    from repro_torch.training.steps import fm_loss_fn

    embedding_bag.launches = embedding_bag_backward.launches = 0
    cfg = tfm.FMConfig(total_vocab=5_000, n_fields=7)
    fm = tfm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                         requires_grad=True)
    state = init_train_state(fm, AdamWConfig())
    batch = {"ids": torch.randint(0, 1 << 30, (16, 7), dtype=torch.int32),
             "labels": torch.ones(16)}
    state, metrics = make_train_step(fm_loss_fn(cfg), AdamWConfig())(state, batch)
    assert int(state.opt.step) == 1 and torch.isfinite(metrics["loss"])
    assert embedding_bag.launches == embedding_bag_backward.launches == 0


def test_only_items_12_and_13b_stay_refused_by_query_serve():
    """Items 12 and 13b's flags were the last the driver refused; since the
    network tier and the metrics dump are ported, it refuses none of the
    JAX driver's flags but ``--no-donate`` (the port has no donation)."""
    import repro.launch.query_serve as j_driver

    assert not hasattr(query_serve, "_LATER")
    ref = vars(j_driver.parse_args([]))
    port = vars(query_serve.parse_args([]))
    assert set(ref) <= set(port)
    for argv in (["--background-ingest", "--runtime-backend", "process"],
                 ["--background-ingest", "--serve", "127.0.0.1:0",
                  "--connections", "2"], ["--metrics-json", "m.json"]):
        assert vars(query_serve.parse_args(argv))["device"] == "cuda"


@pytest.mark.parametrize("fn", [
    KMatrix.create, KMatrixAccel.create, HashFamily.create,
    EdgeBatch.from_numpy, build_sketch, route_table_from_plan,
    interop.import_state, SyntheticStream.batch, MatrixSketch.create,
    FileStream.batch, FileStream.iter_from, EdgeBatch.pad_to,
    CountMin.create, GSketch.create, SyntheticStream.iter_from,
    tq.heavy_nodes, tfm.init_params, build_fm_cell, interop.fm_params_from_jax,
    SketchRegistry.__init__, interop.snapshot_state_from_jax,
    ShardStreamView.batch, ShardStreamView.iter_from,
    WorkerServer.__init__, serve_worker_session, run_ingest_worker,
    run_ranks, choose_topology, tmodel.init_params, tmodel.init_cache,
    tmodel.init_layer, ttrain.synthetic_lm_batch,
    *_GNN_CONSTRUCTORS,
], ids=lambda f: f"{f.__module__.rsplit('.', 1)[-1]}.{f.__qualname__}")
def test_constructors_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("module", [sketch_parallel, tmesh, mesh_ops],
                         ids=lambda m: m.__name__)
def test_distributed_entry_points_take_the_groups_device(module):
    """The mesh and the distributed sketch have no device of their own: they
    run on the device ``run_ranks`` gave the group, the card by default,
    and name no CPU anywhere."""
    public = [getattr(module, n) for n in dir(module)
              if not n.startswith("_") and inspect.isfunction(getattr(module, n))
              and getattr(module, n).__module__ == module.__name__]
    assert len(public) >= 5
    for fn in public:
        assert "device" not in inspect.signature(fn).parameters, fn.__name__
    tree = ast.parse(Path(module.__file__).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Constant)
                and isinstance(n.value, str) and n.value.startswith("cpu")]


COLLECTIVE_CALLS = {"all_reduce", "all_gather", "all_gather_into_tensor",
                    "all_to_all", "all_to_all_single", "broadcast", "barrier",
                    "init_process_group", "init_device_mesh", "new_group"}


@pytest.mark.parametrize("module", [group, sketch_parallel, tmesh, mesh_ops],
                         ids=lambda m: m.__name__)
def test_backend_is_chosen_without_catching_a_collectives_error(module):
    """No ``try`` with an ``except`` wraps a collective (the backend and the
    transport come from the topology, never from an error), and the choice
    itself catches nothing."""
    tree = ast.parse(Path(module.__file__).read_text())
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Try) and node.handlers):
            continue
        called = {getattr(c.func, "attr", getattr(c.func, "id", None))
                  for stmt in node.body for c in ast.walk(stmt)
                  if isinstance(c, ast.Call)}
        assert not called & COLLECTIVE_CALLS, (node.lineno, called)
    choose = next(n for n in ast.walk(ast.parse(inspect.getsource(
        group.choose_topology))) if isinstance(n, ast.FunctionDef))
    assert not [n for n in ast.walk(choose) if isinstance(n, ast.Try)]


def test_process_workers_take_the_parents_device_and_listen_defaults_to_cuda():
    """A process child builds its tenant on the parent's device (the card
    for a registry that names none), a ``--listen`` host on its own
    ``--device``, the card by default."""
    from repro_torch.runtime import BoundedEdgeQueue, ProcessBackend

    assert stream_ingest.parse_args(
        ["--listen", "127.0.0.1:0"]).device == "cuda"
    tenant = SketchRegistry(depth=3, batch_size=1024, scale=0.02,
                            device="cpu").open("cit-HepPh", "gmatrix", 64)
    worker = ProcessBackend().make_worker(tenant, BoundedEdgeQueue(2),
                                          "every:1")
    assert worker.process._args[3] == "cpu" and not worker.is_alive()
    assert SketchRegistry().device == "cuda"


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
