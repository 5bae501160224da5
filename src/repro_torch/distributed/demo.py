"""Distributed kMatrix on a (data x model) mesh of ranks — the port's
counterpart of the JAX package's ``examples/distributed_sketch.py``.

    python -m repro_torch.distributed.demo [--device cpu] [--shape 2,4]

Spawns data x model ranks (on the card unless ``--device cpu``), builds the
mesh, and runs

  1. data-parallel ingest (counter additivity; all_reduce at query), and
  2. partition-parallel ingest (partitions sharded like MoE experts, edges
     routed by source vertex) with allgather and a2a (cf = 2) dispatch,

each checked against a single-sketch replay of the same stream: one JSON
line per mode.  Exits 1 if an exact mode (DP, allgather) differs from the
replay, if an a2a estimate exceeds it, or if a2a's drops are not the edges
missing from its pools.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import KMatrix, kmatrix, vertex_stats_from_sample
from repro_torch.core.types import EdgeBatch
from repro_torch.distributed import group
from repro_torch.distributed.group import run_ranks
from repro_torch.distributed.sketch_parallel import (
    make_dp_edge_freq,
    make_dp_ingest,
    make_pp_edge_freq,
    make_pp_ingest,
    stacked_state,
)
from repro_torch.launch.mesh import make_mesh
from repro_torch.streams import make_stream, sample_stream

MODES = (("dp", None), ("allgather", None), ("a2a", 2.0))


def _stream():
    return make_stream("cit-HepPh", batch_size=2048, seed=3, scale=0.05)


def _rank(rank, world, shape, leaves, static, qs, qd):
    dev = group.rank_device()
    sk = interop.import_state(leaves, static, device=dev)
    mesh = make_mesh(shape, ("data", "model"))
    stream = _stream()
    qs, qd = torch.as_tensor(qs, device=dev), torch.as_tensor(qd, device=dev)
    out = {}
    for mode, cf in MODES:
        pool, conn = torch.zeros_like(sk.pool), torch.zeros_like(sk.conn)
        if mode == "dp":
            ingest, query = make_dp_ingest(sk, mesh), make_dp_edge_freq(sk, mesh)
            axes, owner = ("data",), None
        else:
            ingest, owner = make_pp_ingest(sk, mesh, mode=mode,
                                           capacity_factor=cf or 2.0)
            query, axes = make_pp_edge_freq(sk, mesh), None
        dropped = 0
        for i in range(stream.num_batches):
            b = stream.batch(i, device=dev)
            res = ingest(pool, conn, b.src, b.dst, b.weight)
            dropped += int(res[2]) if mode != "dp" else 0
        est = query(pool, conn, qs, qd).cpu().numpy()
        sp, _ = stacked_state(pool, conn, mesh, axes)
        layer0 = int(sp.view(-1, *sk.pool.shape)[:, 0].sum())
        out[mode] = {"est": est, "dropped": dropped, "layer0": layer0,
                     "owner": owner, "device": str(pool.device)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.distributed.demo")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every rank runs (default: the card)")
    ap.add_argument("--shape", default="2,4",
                    help="data,model ranks of the mesh (default 2,4)")
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.shape.split(","))
    if len(shape) != 2 or min(shape) < 1:
        ap.error("--shape takes two positive ints: DATA,MODEL")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: CUDA is not available; pass --device cpu to run the "
              "ranks on the CPU", file=sys.stderr)
        return 2

    stream = _stream()
    ssrc, sdst, sw = sample_stream(stream, 4000, seed=5)
    sk0 = KMatrix.create(bytes_budget=1 << 16,
                         stats=vertex_stats_from_sample(ssrc, sdst, sw),
                         depth=3, seed=1, device="cpu")
    print(f"kmatrix: {len(sk0.route.widths)} partitions, pool "
          f"{sk0.pool_size} cells/layer; mesh (data={shape[0]}, "
          f"model={shape[1]})")
    replay, positive = kmatrix.empty_like(sk0), 0
    for i in range(stream.num_batches):
        src, dst, w = stream.batch_numpy(i)
        positive += int(w[w > 0].sum())
        kmatrix.ingest(replay, EdgeBatch.from_numpy(src, dst, w, device="cpu"))
    qs, qd, _ = sample_stream(stream, 256, seed=9)
    ref = kmatrix.edge_freq(replay, torch.as_tensor(qs),
                            torch.as_tensor(qd)).numpy()

    ranks = run_ranks(_rank, int(np.prod(shape)), shape,
                      *interop.export_state(sk0), qs, qd, device=args.device)
    ok = True
    for mode, _ in MODES:
        got = ranks[0][mode]
        exact = bool((got["est"] == ref).all())
        line = {"mode": mode, "exact": exact, "device": got["device"],
                "max_undercount": int((ref - got["est"]).max())}
        if got["owner"] is not None:
            line["owner_loads"] = np.bincount(got["owner"],
                                              minlength=shape[1]).tolist()
        if mode == "a2a":
            true = positive - got["layer0"]
            line.update(dropped=got["dropped"], true_dropped=true)
            ok &= bool((got["est"] <= ref).all()) and got["dropped"] == true
        else:
            ok &= exact
        print(json.dumps(line))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
