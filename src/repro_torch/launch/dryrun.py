"""Multi-rank dry run: trace one step of every (arch x shape x mesh) cell
as rank 0 of 256 or 512 fake ranks, allocating nothing.

The port of ``repro/launch/dryrun.py``.  The JAX dry run lowers and
compiles each cell against 512 forced host devices and reads XLA's
memory and cost analyses and the HLO's collectives.  The port has no
compiler to ask; for each cell this script

  1. starts rank 0 of the production mesh's ranks on the "fake" process
     group (``group.fake_ranks``: 16x16 = 256, or 2x16x16 = 512), whose
     collectives move nothing, and builds the mesh
     (``launch/mesh.make_production_mesh``) and the mesh cell
     (``configs/registry.build_cell``);
  2. makes the rank's blocks of the arguments as tensors with shapes and
     dtypes and no storage, and runs the REAL step on them (the full
     train step with its optimizer, or prefill / decode with the KV
     cache) under ``MemTracker``, ``FlopCounterMode`` and
     ``CommDebugMode``.  The LM and GNN cells run on "meta" tensors (a
     few times faster to trace than fake ones); the FM cells and the
     sketch run under ``FakeTensorMode`` on the CPU, where the bag's
     wrapper takes its plain version and real route tables meet fake
     batches;
  3. appends one JSON record per cell, with the JAX record's keys:

     memory.argument_bytes  the exact sum of the rank's blocks;
     memory.peak_bytes      MemTracker's peak (arguments included);
     memory.temp_bytes      peak less arguments (JAX: temp + arguments
                            is its peak);
     memory.output_bytes    the bytes of the step's outputs;
     flops                  FlopCounterMode's count of every op the rank
                            ran: loops are traced in full, so no loop
                            multiplier applies (``loop_multiplier`` is
                            kept; ``flops_adjusted`` equals ``flops``);
     collectives            {bytes, counts, total_bytes} per kind, counts
                            from CommDebugMode and bytes delivered to the
                            rank from the counted collectives
                            (``collective_stats``), all-reduce 2x as in
                            JAX;
     model_flops            the cell's analytic estimate.

     Keys with no counterpart are null and named in ``null_keys``:
     ``lower_s``, ``compile_s`` and ``memory.alias_bytes`` (nothing is
     compiled) and ``bytes_accessed`` (no cost model).  ``trace_s`` is the
     trace's time, and ``fits`` whether the peak fits one NVIDIA H100
     80GB HBM3 (80e9 bytes, nominal).

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
  python -m repro_torch.launch.dryrun --sketch --both-meshes [--out f.jsonl]

Fake ranks are the one entry point of the port that does not run on the
card: it plans a run on 256 or 512 cards, and no tensor has storage.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

H100_BYTES = 80e9  # NVIDIA H100 80GB HBM3, nominal
_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")
_C10D = {"allreduce_": "all-reduce", "allgather_": "all-gather",
         "_reduce_scatter_base_": "reduce-scatter",
         "alltoall_base_": "all-to-all"}  # the ops the counted collectives call
_GROUP = {"all_reduce": "all-reduce", "all_gather": "all-gather",
          "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
          "permute": "collective-permute"}
NULL_KEYS = {"lower_s": "nothing is lowered", "compile_s": "nothing is compiled",
             "memory.alias_bytes": "no buffer assignment",
             "bytes_accessed": "no cost model"}


def collectives(comm_counts: dict, stats: dict) -> dict:
    """The JAX record's {bytes, counts, total_bytes}: counts from
    CommDebugMode's ``get_comm_counts()``, bytes delivered to the rank
    from ``collective_stats()`` (all-reduce counted 2x for the ring).  A
    permute is an ``all_to_all_single`` with one peer each way: the
    group's count of them moves from all-to-all to collective-permute."""
    counts = {k: 0 for k in _KINDS}
    for op, n in comm_counts.items():
        name = str(getattr(op, "__name__", op)).split(".")[-1]
        counts[_C10D.get(name, name)] = counts.get(_C10D.get(name, name), 0) + n
    permutes = stats.get("permute", {}).get("calls", 0)
    counts["all-to-all"] -= permutes
    counts["collective-permute"] += permutes
    nbytes = {k: 0.0 for k in _KINDS}
    for name, row in stats.items():
        kind = _GROUP[name]
        nbytes[kind] += row["bytes"] * (2.0 if kind == "all-reduce" else 1.0)
    return {"bytes": nbytes, "counts": counts,
            "total_bytes": float(sum(nbytes.values()))}


def loop_multiplier_for(arch_name: str) -> int:
    from repro_torch.configs.registry import archs

    arch = archs()[arch_name]
    if arch.family == "lm":
        per = len(arch.config.layer_pattern)
        return max(arch.config.n_layers // per, 1)
    if arch.family == "gnn":
        return arch.config.n_layers
    return 1


def _fake_args(cell, mesh, device) -> tuple:
    """The rank's blocks of the cell's arguments without storage (on
    "meta", or on the CPU inside ``FakeTensorMode``); a train state's
    parameters require grad."""
    from repro_torch.launch import shardings as sh

    def make(key, s):
        t = torch.empty(s.shape, dtype=s.dtype, device=device)
        if key.startswith("params/") and t.is_floating_point():
            t.requires_grad_(True)
        return t

    return tuple(sh.tree_map(make, a) for a in cell.local_arg_shapes(mesh))


def _tensors(tree) -> list:
    from repro_torch.launch import shardings as sh

    return [t for _, t in sh.tree_items(tree) if isinstance(t, torch.Tensor)]


def _mem_tracker():
    """A ``MemTracker`` that counts a sparse gradient (the GNNs'
    ``gather_rows``) by its indices and values."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class Tracker(MemTracker):
        def _track(self, reftype, t):
            if t.is_sparse:
                for part in (t._indices(), t._values()):
                    super()._track(reftype, part)
                return
            super()._track(reftype, t)

    return Tracker()


def _trace(step, args) -> dict:
    """Run ``step(*args)`` with the memory, FLOP and collective counters;
    returns their readings."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import group

    group.reset_collective_stats()
    mem, flops, comm = _mem_tracker(), FlopCounterMode(display=False), CommDebugMode()
    mem.track_external(*_tensors(args))
    with mem, flops, comm:
        out = step(*args)
    peak = mem.get_tracker_snapshot("peak")
    peak = max(v["Total"] for v in peak.values()) if peak else 0
    args_ids = {id(t) for t in _tensors(args)}
    out_bytes = sum(t.numel() * t.element_size() for t in _tensors(out)
                    if id(t) not in args_ids)
    return {"peak": int(peak), "out": int(out_bytes),
            "flops": float(flops.get_total_flops()),
            "coll": collectives(comm.get_comm_counts(),
                                group.collective_stats())}


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.registry import archs, build_cell
    from repro_torch.distributed import group
    from repro_torch.launch.mesh import make_production_mesh

    n = 512 if multi_pod else 256
    rec = {"arch": arch_name, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16", "n_devices": n,
           "ok": False}
    t0 = time.time()
    try:
        with group.fake_ranks(n):
            mesh = make_production_mesh(multi_pod=multi_pod)
            cell = build_cell(arch_name, shape_name, mesh)
            arg_bytes = cell.argument_bytes(mesh)
            if archs()[arch_name].family == "recsys":
                with FakeTensorMode(allow_non_fake_inputs=True):
                    r = _trace(cell.step_fn, _fake_args(cell, mesh, "cpu"))
            else:
                r = _trace(cell.step_fn, _fake_args(cell, mesh, "meta"))
        mult = loop_multiplier_for(arch_name)
        rec.update(
            ok=True, loop_multiplier=mult, flops_adjusted=r["flops"],
            lower_s=None, compile_s=None, trace_s=round(time.time() - t0, 2),
            memory={"argument_bytes": arg_bytes, "output_bytes": r["out"],
                    "temp_bytes": max(r["peak"] - arg_bytes, 0),
                    "alias_bytes": None, "peak_bytes": r["peak"]},
            fits=r["peak"] <= H100_BYTES, flops=r["flops"],
            bytes_accessed=None, collectives=r["coll"],
            model_flops=cell.model_flops_per_step, null_keys=NULL_KEYS)
        if verbose:
            print(f"[OK] {arch_name} x {shape_name} on {rec['mesh']}: "
                  f"trace {rec['trace_s']:.1f}s args/rank "
                  f"{arg_bytes / 2**30:.2f} GiB peak/rank "
                  f"{r['peak'] / 2**30:.2f} GiB "
                  f"({'fits' if rec['fits'] else 'does NOT fit'} an H100 80GB) "
                  f"GFLOPs {r['flops'] / 1e9:.1f} "
                  f"coll {r['coll']['total_bytes'] / 2**20:.1f} MiB", flush=True)
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        if verbose:
            print(f"[FAIL] {arch_name} x {shape_name}: {rec['error']}",
                  file=sys.stderr, flush=True)
    return rec


def run_sketch_cell(*, multi_pod: bool, mode: str = "a2a",
                    budget_mb: int = 64, batch: int = 1 << 20,
                    verbose: bool = True) -> dict:
    """Dry-run the PAPER'S system at pod scale: partition-parallel kMatrix
    ingest (partitions over "model", edges over the other axes, all_to_all
    or all_gather dispatch) of one batch, on rank 0's rows."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import KMatrix, vertex_stats_from_sample
    from repro_torch.distributed import group
    from repro_torch.distributed.sketch_parallel import make_pp_ingest
    from repro_torch.launch.mesh import make_production_mesh

    n = 512 if multi_pod else 256
    rec = {"arch": f"kmatrix-stream-{mode}", "shape": f"ingest_{batch}",
           "mesh": "2x16x16" if multi_pod else "16x16", "n_devices": n,
           "ok": False}
    t0 = time.time()
    try:
        rng = np.random.default_rng(0)
        src = rng.zipf(1.2, 200_000).astype(np.int32) % (1 << 20)
        dst = rng.integers(0, 1 << 20, 200_000).astype(np.int32)
        stats = vertex_stats_from_sample(src, dst)
        sk = KMatrix.create(bytes_budget=budget_mb << 20, stats=stats,
                            depth=7, seed=0, partitioner="banded",
                            n_bands=64, device="cpu")
        with group.fake_ranks(n):
            mesh = make_production_mesh(multi_pod=multi_pod)
            fn, _owner = make_pp_ingest(sk, mesh, mode=mode)
            arg_bytes = (sk.pool.numel() * sk.pool.element_size()
                         + sk.conn.numel() * sk.conn.element_size()
                         + 3 * batch * 4)
            with FakeTensorMode(allow_non_fake_inputs=True):
                args = (torch.empty(sk.pool.shape, dtype=sk.pool.dtype),
                        torch.empty(sk.conn.shape, dtype=sk.conn.dtype),
                        *(torch.empty((batch,), dtype=torch.int32)
                          for _ in range(3)))
                r = _trace(fn, args)
        rec.update(ok=True, loop_multiplier=1, flops_adjusted=r["flops"],
                   lower_s=None, compile_s=None,
                   trace_s=round(time.time() - t0, 2),
                   memory={"argument_bytes": arg_bytes, "output_bytes": r["out"],
                           "temp_bytes": max(r["peak"] - arg_bytes, 0),
                           "alias_bytes": None, "peak_bytes": r["peak"]},
                   fits=r["peak"] <= H100_BYTES, flops=r["flops"],
                   bytes_accessed=None, collectives=r["coll"],
                   model_flops=0.0, null_keys=NULL_KEYS)
        if verbose:
            print(f"[OK] kmatrix-stream[{mode}] on {rec['mesh']}: "
                  f"trace {rec['trace_s']}s peak/rank "
                  f"{r['peak'] / 2**30:.3f} GiB coll "
                  f"{r['coll']['total_bytes'] / 2**20:.1f} MiB/batch, owners "
                  f"over {mesh.shape[mesh.mesh_dim_names.index('model')]} "
                  "model ranks", flush=True)
    except Exception as e:  # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"
        if verbose:
            print(f"[FAIL] kmatrix-stream[{mode}]: {rec['error']}",
                  file=sys.stderr, flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sketch", action="store_true",
                    help="dry-run the paper's partition-parallel sketch")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    args = ap.parse_args(argv)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    if args.sketch:
        n_fail = 0
        with open(args.out, "a") as f:
            for mp in meshes:
                for mode in ["a2a", "allgather"]:
                    rec = run_sketch_cell(multi_pod=mp, mode=mode)
                    f.write(json.dumps(rec) + "\n")
                    n_fail += 0 if rec["ok"] else 1
        sys.exit(1 if n_fail else 0)

    from repro_torch.configs.registry import all_cells

    if args.all:
        cells = all_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    todo = [(arch, shape, mp) for arch, shape in cells for mp in meshes]
    n_fail = 0
    jobs = min(len(todo), os.cpu_count() or 1)
    with open(args.out, "a") as f, _pool(jobs) as pool:
        for rec in pool(_run_one, todo):
            f.write(json.dumps(rec) + "\n")
            f.flush()
            n_fail += 0 if rec["ok"] else 1
    sys.exit(1 if n_fail else 0)


def _run_one(cell) -> dict:
    arch, shape, mp = cell
    return run_cell(arch, shape, multi_pod=mp)


@contextlib.contextmanager
def _pool(jobs: int):
    """``map`` in this process (one job), or over ``jobs`` spawned
    processes (one a core), each with its own fake process group per
    cell; the records come back in cell order."""
    if jobs <= 1:
        yield map
        return
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(jobs) as pool:
        yield lambda fn, items: pool.imap(fn, items, chunksize=1)


if __name__ == "__main__":
    main()
