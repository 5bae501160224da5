"""End-to-end online serving driver: ingest + snapshot publishing + queries.

The cooperative mode of the JAX package's driver: ingest advances between
served query batches in one thread.  A live tenant ingests its stream into
the snapshot buffer's delta, publishes an epoch every ``--publish-every``
batches, and an open-loop load generator fires mixed queries at the
published snapshots; on completion the rest of the stream is drained,
published, and one JSON summary line (QPS, p50/p99 latency, epochs, edges,
engine stats) is printed with the JAX driver's keys.

  python -m repro_torch.launch.query_serve --dataset cit-HepPh \
      --sketch kmatrix --budget-kb 256 --qps 2000 --n-requests 8000 \
      [--scale 0.25] [--device cuda]

The run is on the card (``--device cuda``, the default) unless
``--device cpu`` is given; without a card and without ``--device cpu`` it
exits with an error.  The JAX driver's other modes are not ported yet, and
their flags exit with an error naming the ROADMAP item that ports them:
background ingest and the runtime (11), the network front-end (12),
sharding (10b) and the metrics dump (13b).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable

from repro_torch.launch.stream_ingest import require_device
from repro_torch.serving import (
    OpenLoopLoadGen,
    QueryEngine,
    SketchRegistry,
    WorkloadMix,
    mix_for_sketch,
    synth_requests,
    warm_bucket_ladder,
)
from repro_torch.serving.registry import SKETCHES

# flags of the JAX driver that belong to modes not ported yet: (flag, the
# test that it was given, the ROADMAP item that ports it)
_LATER = [
    ("--background-ingest", lambda a: a.background_ingest, "11"),
    ("--runtime-backend", lambda a: a.runtime_backend != "thread", "11"),
    ("--publish-mode", lambda a: a.publish_mode != "delta", "11"),
    ("--queue-capacity", lambda a: a.queue_capacity != 64, "11"),
    ("--backpressure", lambda a: a.backpressure != "block", "11"),
    ("--publish-policy", lambda a: bool(a.publish_policy), "11"),
    ("--spill-dir", lambda a: bool(a.spill_dir), "11"),
    ("--checkpoint-dir", lambda a: bool(a.checkpoint_dir), "11"),
    ("--checkpoint-every", lambda a: a.checkpoint_every != 16, "11"),
    ("--restore", lambda a: a.restore, "11"),
    ("--ingest-dedup", lambda a: a.ingest_dedup, "11"),
    ("--span-log", lambda a: bool(a.span_log), "11"),
    ("--serve", lambda a: bool(a.serve), "12"),
    ("--connections", lambda a: a.connections != 4, "12"),
    ("--max-inflight", lambda a: a.max_inflight != 4096, "12"),
    ("--tenant-qps", lambda a: a.tenant_qps != 0.0, "12"),
    ("--auth-token", lambda a: bool(a.auth_token), "12"),
    ("--shards", lambda a: a.shards != 1, "10b"),
    ("--shard-seed", lambda a: a.shard_seed != 0, "10b"),
    ("--metrics-json", lambda a: bool(a.metrics_json), "13b"),
    ("--metrics-interval-s", lambda a: a.metrics_interval_s != 1.0, "13b"),
]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.query_serve",
        description="Online serving: live ingest + snapshot publishing + "
                    "open-loop mixed queries")
    ap.add_argument("--dataset", default="cit-HepPh")
    ap.add_argument("--sketch", default="kmatrix", choices=list(SKETCHES))
    ap.add_argument("--budget-kb", type=int, default=256)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--partitioner", default="banded",
                    choices=["banded", "greedy", "auto"])
    ap.add_argument("--sketch-backend", default="",
                    choices=["", "width_class", "flat"],
                    help="kmatrix layout (default: width_class, whose "
                         "ingest runs the matrix_ingest_edges kernel)")
    ap.add_argument("--qps", type=float, default=2000.0)
    ap.add_argument("--n-requests", type=int, default=8000)
    ap.add_argument("--batch-max", type=int, default=512)
    ap.add_argument("--publish-every", type=int, default=4,
                    help="ingest batches between publishes")
    ap.add_argument("--warm-batches", type=int, default=4,
                    help="ingest batches before serving starts")
    ap.add_argument("--mix", default="",
                    help="comma list family=weight, e.g. "
                         "'edge_freq=0.7,reach=0.3' (default: built-in mix)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    # ---- the JAX driver's other modes: refused below ----
    later = ap.add_argument_group(
        "not ported yet", "accepted for the JAX driver's command lines; "
        "setting one exits with an error naming its ROADMAP item")
    later.add_argument("--background-ingest", action="store_true")
    later.add_argument("--runtime-backend", default="thread")
    later.add_argument("--publish-mode", default="delta",
                       choices=["delta", "full"])
    later.add_argument("--queue-capacity", type=int, default=64)
    later.add_argument("--backpressure", default="block",
                       choices=["block", "drop_oldest", "spill"])
    later.add_argument("--publish-policy", default="")
    later.add_argument("--spill-dir", default="")
    later.add_argument("--checkpoint-dir", default="")
    later.add_argument("--checkpoint-every", type=int, default=16)
    later.add_argument("--restore", action="store_true")
    later.add_argument("--ingest-dedup", action="store_true")
    later.add_argument("--no-donate", action="store_true")
    later.add_argument("--serve", default="", metavar="HOST:PORT")
    later.add_argument("--connections", type=int, default=4)
    later.add_argument("--max-inflight", type=int, default=4096)
    later.add_argument("--tenant-qps", type=float, default=0.0)
    later.add_argument("--auth-token", default="")
    later.add_argument("--shards", type=int, default=1)
    later.add_argument("--shard-seed", type=int, default=0)
    later.add_argument("--metrics-json", default="", metavar="PATH")
    later.add_argument("--metrics-interval-s", type=float, default=1.0)
    later.add_argument("--span-log", default="", metavar="PATH")
    args = ap.parse_args(argv)
    for flag, given, item in _LATER:
        if given(args):
            ap.error(f"{flag} is not ported yet (ROADMAP item {item}); "
                     "this driver runs the cooperative mode")
    if args.no_donate:
        ap.error("--no-donate has nothing to switch off: the port's ingest "
                 "always writes in place into the snapshot buffer's private "
                 "delta (there is no buffer donation)")
    return args


def build_mix(args) -> WorkloadMix:
    if not args.mix:
        return mix_for_sketch(args.sketch)
    weights = {k: 0.0 for k in WorkloadMix().normalized()}
    for part in args.mix.split(","):
        k, v = part.split("=")
        if k.strip() not in weights:
            raise SystemExit(f"unknown query family {k.strip()!r} in --mix")
        weights[k.strip()] = float(v)
    return WorkloadMix(**weights)


def open_tenant(args):
    """The registry and its one tenant on ``--device``, warmed with
    ``--warm-batches`` batches and published (epoch 1)."""
    device = require_device(args.device)
    registry = SketchRegistry(depth=args.depth, scale=args.scale,
                              partitioner=args.partitioner,
                              sketch_backend=args.sketch_backend or None,
                              device=device)
    tenant = registry.open(args.dataset, args.sketch, args.budget_kb,
                           seed=args.seed)
    print(f"tenant {tenant.key.tenant_id}: stream "
          f"{tenant.stream.num_batches} batches, universe "
          f"{tenant.stream.spec.n_nodes}, on {device}", file=sys.stderr)
    t0 = time.time()
    tenant.step(min(args.warm_batches, max(1, tenant.stream.num_batches // 2)))
    snap = tenant.publish()
    print(f"warm: epoch {snap.epoch}, {snap.n_edges} edges in "
          f"{time.time()-t0:.2f}s", file=sys.stderr)
    return registry, tenant


def warm_engine(args, tenant):
    """The measured requests and an engine that has walked its bucket
    ladder on the tenant's snapshot (off the clock)."""
    n_nodes = tenant.stream.spec.n_nodes
    mix = build_mix(args)
    requests = synth_requests(
        args.n_requests, mix, n_nodes=n_nodes, seed=args.seed + 7,
        heavy_universe=min(n_nodes, 1 << 14), heavy_threshold=100.0)
    engine = QueryEngine()
    warm = synth_requests(args.batch_max, mix, n_nodes=n_nodes, seed=99,
                          heavy_universe=min(n_nodes, 1 << 14),
                          heavy_threshold=100.0)
    warm_bucket_ladder(engine, tenant.snapshot, warm)
    return engine, requests


def live_ingest(args, tenant) -> Callable[[], None]:
    """The step run after each served batch: one stream batch into the
    delta, and a publish every ``--publish-every`` batches."""
    ingested = [0]

    def step() -> None:
        stepped = tenant.step(1)
        ingested[0] += stepped
        # key off this call's progress, not the cumulative count: once the
        # stream drains, a frozen total would either publish after every
        # served batch (thrashing the closure cache) or never again
        if stepped and ingested[0] % args.publish_every == 0:
            tenant.publish()

    return step


def run_load(args, engine, snapshot_fn, requests, *,
             between_batches: Callable[[], None] | None = None):
    """Measurement phase: the in-process open loop (the JAX driver's
    without ``--serve``).  Returns ``(report, extras)``."""
    loadgen = OpenLoopLoadGen(target_qps=args.qps, batch_max=args.batch_max)
    return loadgen.run(engine, snapshot_fn, requests,
                       between_batches=between_batches), {}


def cooperative_serve(args, tenant, engine, requests) -> tuple:
    """Ingest interleaves with query batches, one thread."""
    report, extras = run_load(args, engine, lambda: tenant.snapshot, requests,
                              between_batches=live_ingest(args, tenant))
    # drain whatever stream remains so the run is a full ingest too
    while tenant.step(16):
        pass
    final = tenant.publish()
    return report, final, {"ingest_mode": "cooperative", **extras}


def _run(args) -> dict:
    """Serve, print the summary line, and return the run: ``summary``, the
    final ``tenant``, the ``engine`` and the measured ``requests``."""
    registry, tenant = open_tenant(args)
    engine, requests = warm_engine(args, tenant)
    report, final, extras = cooperative_serve(args, tenant, engine, requests)
    summary = {
        "driver": "query_serve",
        "dataset": args.dataset,
        "sketch": args.sketch,
        "sketch_backend": registry.sketch_backend,
        "budget_kb": args.budget_kb,
        "achieved_qps": round(report.achieved_qps, 1),
        "offered_qps": args.qps,
        "p50_ms": round(report.p50_ms, 3),
        "p90_ms": round(report.p90_ms, 3),
        "p99_ms": round(report.p99_ms, 3),
        "p999_ms": round(report.p999_ms, 3),
        "latency_hist": report.latency_hist,
        "n_requests": report.n_requests,
        "final_epoch": final.epoch,
        "total_edges": final.n_edges,
        **extras,
        **{f"engine_{k}": v for k, v in engine.stats.items()},
    }
    print(json.dumps(summary))
    return {"summary": summary, "tenant": tenant, "engine": engine,
            "requests": requests}


def main(argv=None) -> None:
    _run(parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
