"""Streaming-ingest driver: the paper's pipeline end to end.

stream -> reservoir sample -> VertexStats -> partition plan -> sketch ->
batched ingest -> edge-frequency queries -> ARE, printed as one JSON line
(the same line as the JAX package's driver prints).

  python -m repro_torch.launch.stream_ingest --dataset cit-HepPh \
      --budget-kb 512 --depth 7 [--scale 0.25] [--device cuda]

The run is on the card (``--device cuda``, the default) unless
``--device cpu`` is given; without a card and without ``--device cpu`` it
exits with an error instead of running on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from repro_torch.core import EdgeBatch, vertex_stats_from_sample
from repro_torch.core.metrics import (
    average_relative_error,
    exact_edge_frequencies,
    lookup_exact,
)
from repro_torch.serving.registry import SKETCHES, build_sketch
from repro_torch.streams import make_stream, sample_stream


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.stream_ingest",
        description="Paper pipeline: stream -> sample -> partition -> "
                    "ingest -> ARE")
    ap.add_argument("--dataset", default="cit-HepPh")
    ap.add_argument("--sketch", default="kmatrix", choices=sorted(SKETCHES))
    ap.add_argument("--budget-kb", type=int, default=512)
    ap.add_argument("--depth", type=int, default=7)
    ap.add_argument("--batch-size", type=int, default=8192)
    ap.add_argument("--sample-size", type=int, default=30_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--partitioner", default="banded",
                    choices=["banded", "greedy"])
    ap.add_argument("--sketch-backend", default="",
                    choices=["", "width_class", "flat"],
                    help="kmatrix layout (default: width_class, whose "
                         "ingest runs the matrix_ingest kernel)")
    ap.add_argument("--eval-queries", type=int, default=10_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    return ap


def require_device(device: str) -> torch.device:
    """``device`` as a torch.device; exits if it names CUDA and no card is
    available (the pipeline never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"error: --device {device} requested but CUDA is not available; "
            "pass --device cpu to run on the CPU")
    return dev


def inline_main(args) -> dict:
    """Run the pipeline, print its lines, and return the run's results:
    ``sketch``, ``module``, ``stream``, ``ARE`` (unrounded), ``n_edges``,
    ``batches`` and ``ingest_seconds``."""
    device = require_device(args.device)
    stream = make_stream(args.dataset, batch_size=args.batch_size,
                         seed=args.seed, scale=args.scale)
    print(f"stream: {stream.spec.name} nodes={stream.spec.n_nodes} "
          f"edges={stream.spec.n_edges} batches={stream.num_batches}")

    # Paper §V-A: 30k-edge reservoir sample bootstraps the partitioner.
    t0 = time.perf_counter()
    ssrc, sdst, sw = sample_stream(stream, args.sample_size, seed=args.seed + 1)
    stats = vertex_stats_from_sample(ssrc, sdst, sw)
    sk, mod = build_sketch(args.sketch, args.budget_kb * 1024, stats,
                           args.depth, args.seed, args.partitioner,
                           backend=args.sketch_backend or None, device=device)
    print(f"init: {args.sketch} [{type(sk).__name__}] "
          f"counters={sk.num_counters} on {device} "
          f"({time.perf_counter()-t0:.2f}s init incl. sampling)")

    t0 = time.perf_counter()
    n_edges = 0
    for i in range(stream.num_batches):
        src, dst, w = stream.batch_numpy(i)
        n_edges += int((w > 0).sum())  # host count: no device sync per batch
        sk = mod.ingest(sk, EdgeBatch.from_numpy(src, dst, w, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"ingest: {n_edges} edges in {dt:.2f}s "
          f"({n_edges/max(dt,1e-9)/1e6:.2f} M edges/s)")

    # evaluation against exact ground truth (paper Fig. 7 protocol)
    src, dst, w = stream.all_edges_numpy()
    fmap = exact_edge_frequencies(src, dst, w)
    qs, qd, _ = sample_stream(stream, args.eval_queries, seed=99)
    true = lookup_exact(fmap, qs, qd)
    est = mod.edge_freq(sk, torch.as_tensor(qs, device=device),
                        torch.as_tensor(qd, device=device)).cpu()
    # on the host, so the mean is taken in one order whatever the device
    are = float(average_relative_error(est, torch.as_tensor(true)))
    print(json.dumps({"sketch": args.sketch, "dataset": args.dataset,
                      "budget_kb": args.budget_kb, "ARE": round(are, 4)}))
    return {"sketch": sk, "module": mod, "stream": stream, "ARE": are,
            "n_edges": n_edges, "batches": stream.num_batches,
            "ingest_seconds": dt}


def main(argv=None) -> None:
    inline_main(build_parser().parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
