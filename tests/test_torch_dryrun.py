"""The port's dry run (``repro_torch.launch.dryrun``): cells traced as rank
0 of 256 or 512 fake ranks, in subprocesses with a bounded wait.

Each record must carry the JAX dry run's keys (``repro/launch/dryrun.py``
``run_cell`` and ``run_sketch_cell``), its ``argument_bytes`` must equal
the bytes of one device's blocks under the JAX package's own specs
(``NamedSharding(AbstractMesh, spec).shard_shape``), and a cell whose
specs split its weights must count collectives.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jregistry
from repro_torch.launch import dryrun

REPO = Path(__file__).resolve().parents[1]
WAIT_S = 150.0
# the keys of the JAX package's records (repro/launch/dryrun.py)
JAX_KEYS = {"arch", "shape", "mesh", "n_devices", "ok", "loop_multiplier",
            "flops_adjusted", "lower_s", "compile_s", "memory", "flops",
            "bytes_accessed", "collectives", "model_flops"}
JAX_MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
              "peak_bytes"}
JAX_SKETCH_KEYS = {"arch", "shape", "mesh", "n_devices", "ok", "compile_s",
                   "memory", "flops", "bytes_accessed", "collectives",
                   "model_flops", "loop_multiplier"}
RUNS = {"gemma2": ["--arch", "gemma2-2b", "--shape", "long_500k"],
        "gatedgcn": ["--arch", "gatedgcn", "--shape", "molecule", "--multi-pod"],
        "fm": ["--arch", "fm", "--shape", "serve_p99"],
        "mixtral": ["--arch", "mixtral-8x7b", "--shape", "decode_32k"],
        "sketch": ["--sketch"]}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *flags, "--out",
         str(tmp / f"{k}.jsonl")], cwd=tmp, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k, flags in RUNS.items()}
    out = {}
    try:
        for k, proc in procs.items():
            text, _ = proc.communicate(timeout=WAIT_S)
            assert proc.returncode == 0, text[-3000:]
            with open(tmp / f"{k}.jsonl") as f:
                out[k] = [json.loads(line) for line in f]
            out[k + "_stdout"] = text
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _jax_argument_bytes(arch, shape, mesh_shape, axes) -> int:
    mesh = AbstractMesh(mesh_shape, axes)
    cell = jregistry.build_cell(arch, shape, mesh)
    total = 0
    for a, s in zip(cell.arg_shapes, cell.in_specs):
        leaves = jax.tree_util.tree_leaves(a)
        specs = jax.tree_util.tree_leaves(s, is_leaf=lambda x: isinstance(x, JP))
        assert len(leaves) == len(specs)
        for leaf, spec in zip(leaves, specs):
            block = NamedSharding(mesh, spec).shard_shape(leaf.shape)
            total += int(np.prod(block)) * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("key", ["gemma2", "gatedgcn", "fm"])
def test_cell_record_has_the_jax_keys_and_exact_argument_bytes(records, key):
    (rec,) = records[key]
    assert rec["ok"], rec.get("error")
    assert JAX_KEYS <= set(rec) and set(rec["memory"]) == JAX_MEMORY
    assert set(rec["collectives"]) == {"bytes", "counts", "total_bytes"}
    assert set(rec["null_keys"]) == {"lower_s", "compile_s",
                                     "memory.alias_bytes", "bytes_accessed"}
    assert rec["lower_s"] is rec["compile_s"] is rec["bytes_accessed"] is None
    assert rec["flops_adjusted"] == rec["flops"]
    multi = rec["mesh"] == "2x16x16"
    assert rec["n_devices"] == (512 if multi else 256)
    args = ((2, 16, 16), ("pod", "data", "model")) if multi else (
        (16, 16), ("data", "model"))
    assert rec["memory"]["argument_bytes"] == _jax_argument_bytes(
        rec["arch"], rec["shape"], *args)
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    assert rec["loop_multiplier"] == dryrun.loop_multiplier_for(rec["arch"])
    assert rec["fits"] is True
    assert rec["model_flops"] == jregistry.build_cell(
        rec["arch"], rec["shape"], AbstractMesh(*args)).model_flops_per_step


def test_split_weights_are_gathered_and_counted(records):
    """gemma2-2b's decode at batch 1: every weight split over "model" or
    every axis, the cache's sequence over every axis: gathers, and the
    distributed softmax's sums, each counted and sized."""
    (rec,) = records["gemma2"]
    coll = rec["collectives"]
    assert coll["counts"]["all-gather"] > 0 and coll["counts"]["all-reduce"] > 0
    assert coll["bytes"]["all-gather"] > 0
    assert coll["total_bytes"] == sum(coll["bytes"].values())
    assert rec["flops"] > 0
    (fm,) = records["fm"]
    assert fm["collectives"]["counts"]["all-reduce"] == 1  # the bags' sum
    assert "fits an H100 80GB" in records["fm_stdout"]


def test_split_graph_and_gated_experts_count_their_collectives(records):
    """The GNN train cell on a split graph: node arrays gathered for the
    edges (all-gather), messages summed into each rank's nodes
    (reduce-scatter), both again as each other's adjoint in the backward.
    mixtral's gated experts: ``w_out``'s blocks permuted to the ranks whose
    gate columns they meet (collective-permute), then gathered."""
    (gnn,) = records["gatedgcn"]
    counts = gnn["collectives"]["counts"]
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    assert gnn["collectives"]["bytes"]["reduce-scatter"] > 0
    (moe,) = records["mixtral"]
    assert moe["ok"], moe.get("error")
    counts = moe["collectives"]["counts"]
    n_layers = 32  # one permute of each layer's w_out
    assert counts["collective-permute"] == n_layers
    assert counts["reduce-scatter"] == 0  # a serve cell: no backward
    assert moe["collectives"]["bytes"]["collective-permute"] > 0


def test_cells_trace_one_after_another_in_one_process():
    """``--all`` traces every cell in one process: nothing a trace caches
    (the FM's field tables) may carry one cell's fake tensors into the
    next."""
    recs = [dryrun.run_cell("fm", "serve_p99", multi_pod=mp, verbose=False)
            for mp in (False, True)]
    assert [r["ok"] for r in recs] == [True, True], [r.get("error") for r in recs]


def test_sketch_records_have_the_jax_keys(records):
    recs = records["sketch"]
    assert [r["arch"] for r in recs] == ["kmatrix-stream-a2a",
                                        "kmatrix-stream-allgather"]
    for r in recs:
        assert r["ok"], r.get("error")
        assert JAX_SKETCH_KEYS <= set(r)
        assert r["shape"] == "ingest_1048576" and r["n_devices"] == 256
    assert recs[0]["collectives"]["counts"]["all-to-all"] == 1
    assert recs[1]["collectives"]["counts"]["all-gather"] == 1


def test_collectives_count_all_reduce_twice():
    stats = {"all_reduce": {"calls": 2, "bytes": 100, "host_bytes": 0,
                            "seconds": 0.0},
             "all_gather": {"calls": 1, "bytes": 40, "host_bytes": 0,
                            "seconds": 0.0},
             "all_to_all": {"calls": 0, "bytes": 0, "host_bytes": 0,
                            "seconds": 0.0}}
    out = dryrun.collectives({}, stats)
    assert out["bytes"]["all-reduce"] == 200 and out["bytes"]["all-gather"] == 40
    assert out["total_bytes"] == 240
    assert set(out["counts"]) == set(out["bytes"]) == {
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute"}
