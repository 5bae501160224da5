"""Quickstart: summarize a graph stream with kMatrix in ~60 seconds.

    python -m repro_torch.examples.quickstart [--device cpu]

The JAX package's ``examples/quickstart.py`` on the port: reservoir
sample -> error-optimal partition plan -> batched ingest -> frequency /
reachability queries, and kMatrix against TCM/gMatrix at the same memory
budget.  The kMatrix is the flat layout (``KMatrix``), as in the JAX
example; its lines equal the JAX example's, the ingest rates aside.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core import (
    KMatrix,
    MatrixSketch,
    kmatrix,
    matrix_sketch,
    queries,
    vertex_stats_from_sample,
)
from repro_torch.core.metrics import (
    average_relative_error,
    exact_edge_frequencies,
    lookup_exact,
    percent_effective_queries,
)
from repro_torch.launch.stream_ingest import require_device
from repro_torch.streams import make_stream, sample_stream


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits if no card) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    budget_kb, depth = 256, 5
    stream = make_stream("cit-HepPh", batch_size=8192, seed=1, scale=0.25)
    print(f"stream: {stream.spec.n_edges} edges over "
          f"{stream.spec.n_nodes} nodes ({stream.num_batches} batches)")

    # 1. Reservoir-sample the stream and plan the partitions (paper §IV-A).
    ssrc, sdst, sw = sample_stream(stream, 10_000, seed=7)
    stats = vertex_stats_from_sample(ssrc, sdst, sw)

    sketches = {
        "tcm": (MatrixSketch.create(bytes_budget=budget_kb * 1024, depth=depth,
                                    seed=3, kind="tcm", device=device),
                matrix_sketch),
        "gmatrix": (MatrixSketch.create(bytes_budget=budget_kb * 1024,
                                        depth=depth, seed=4, kind="gmatrix",
                                        device=device), matrix_sketch),
        "kmatrix": (KMatrix.create(bytes_budget=budget_kb * 1024, stats=stats,
                                   depth=depth, seed=3, device=device),
                    kmatrix),
    }
    km = sketches["kmatrix"][0]
    print(f"kmatrix: {km.route.n_partitions} partitions, widths "
          f"{km.route.widths.tolist()}")

    # 2. Stream ingest (batched, in place).
    for name, (sk, mod) in sketches.items():
        batches = [stream.batch(i, device=device)
                   for i in range(stream.num_batches)]
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            mod.ingest(sk, batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
        rate = stream.spec.n_edges / (time.perf_counter() - t0) / 1e6
        print(f"  {name:8s} ingest {rate:5.1f} M edges/s")

    # 3. Query accuracy vs exact ground truth (paper Fig. 7/8 protocol).
    src, dst, w = stream.all_edges_numpy()
    fmap = exact_edge_frequencies(src, dst, w)
    qs, qd, _ = sample_stream(stream, 5_000, seed=99)
    true = torch.as_tensor(lookup_exact(fmap, qs, qd))
    print(f"\n{'sketch':10s} {'ARE':>8s} {'PEQ@10':>8s}")
    for name, (sk, mod) in sketches.items():
        est = mod.edge_freq(sk, torch.as_tensor(qs, device=device),
                            torch.as_tensor(qd, device=device)).cpu()
        are = float(average_relative_error(est, true))
        peq = float(percent_effective_queries(est, true, 10.0))
        print(f"{name:10s} {are:8.2f} {peq:7.1f}%")

    # 4. Type II queries on kMatrix (what CountMin/gSketch cannot answer).
    qs5 = torch.as_tensor(qs[:5], device=device)
    qd5 = torch.as_tensor(qd[:5], device=device)
    reach = queries.kmatrix_reachability(km, qs5, qd5, max_hops=8)
    out_f = kmatrix.node_out_freq(km, qs5)
    print("\nreachability(sample pairs):", reach.tolist())
    print("node out-frequency:        ", out_f.tolist())


if __name__ == "__main__":
    main()
