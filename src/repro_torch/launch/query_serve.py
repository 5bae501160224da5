"""End-to-end online serving driver: ingest + snapshot publishing + queries.

The JAX package's driver on the port.  A live tenant ingests its stream
into the snapshot buffer's delta, publishes epochs, and an open-loop load
generator fires mixed queries at the published snapshots; on completion
the rest of the stream is drained and published, and one JSON summary line
(QPS, p50/p99 latency, epochs, edges, engine stats) is printed with the
JAX driver's keys plus ``device``.  Three ingest modes:

  cooperative (default)   ingest advances between served query batches in
      one thread (a publish every ``--publish-every`` batches).

  --background-ingest     ingest runs in a ``repro_torch.runtime`` worker
      thread behind a bounded queue (``--backpressure``), publishing epochs
      under ``--publish-policy``, while the load generator fires queries
      from the main thread the whole time.  The summary gains runtime
      metrics and a conservation report (offered == published + accounted
      drops; a nonzero unaccounted count exits 1); ``--checkpoint-dir``
      adds crash-safe checkpoints and ``--restore`` resumes from the latest
      one.  SIGTERM/SIGINT drain gracefully (final epoch and checkpoint)
      before exit.

  --shards K              (with --background-ingest) K hash-band shards of
      one tenant: one worker and queue per shard, scatter/gather queries
      through ``ShardedQueryEngine``, a shard manifest beside the per-shard
      checkpoints, and a cross-shard conservation verdict (exit 1 if it
      fails).  The shards share the run's device: K is logical.

  python -m repro_torch.launch.query_serve --dataset cit-HepPh \
      --sketch kmatrix --budget-kb 256 --qps 2000 --n-requests 8000 \
      [--scale 0.25] [--device cuda] [--background-ingest [--shards 4]]

The run is on the card (``--device cuda``, the default) unless
``--device cpu`` is given; without a card and without ``--device cpu`` it
exits with an error.  A worker that fails (a CUDA error included) ends the
run with ``WorkerFailure`` and a nonzero exit.  The JAX driver's network
front-end and process/socket runtime backends (ROADMAP item 12) and its
metrics dump (13b) are not ported yet: their flags exit with an error
naming the item.
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
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

# flags of the JAX driver that belong to parts not ported yet: (flag, the
# test that it was given, the ROADMAP item that ports it)
_LATER = [
    ("--runtime-backend", lambda a: a.runtime_backend != "thread", "12"),
    ("--serve", lambda a: bool(a.serve), "12"),
    ("--connections", lambda a: a.connections != 4, "12"),
    ("--max-inflight", lambda a: a.max_inflight != 4096, "12"),
    ("--tenant-qps", lambda a: a.tenant_qps != 0.0, "12"),
    ("--auth-token", lambda a: bool(a.auth_token), "12"),
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
    # ---- background ingest runtime (repro_torch.runtime) ----
    ap.add_argument("--background-ingest", action="store_true",
                    help="ingest in a worker thread behind a bounded queue; "
                         "queries run concurrently")
    ap.add_argument("--runtime-backend", default="thread",
                    help="execution backend for ingest workers: thread "
                         "(process and socket are not ported yet)")
    ap.add_argument("--publish-mode", default="delta",
                    choices=["delta", "full"],
                    help="snapshot publication of a remote backend; the "
                         "thread backend publishes by reference and "
                         "ignores it")
    ap.add_argument("--shards", type=int, default=1,
                    help="serve K hash-band shards: one ingest worker + "
                         "queue per shard, scatter/gather queries "
                         "(requires --background-ingest)")
    ap.add_argument("--shard-seed", type=int, default=0,
                    help="seed of the shard routing hash (must match the "
                         "manifest when restoring a sharded checkpoint)")
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--backpressure", default="block",
                    choices=["block", "drop_oldest", "spill"])
    ap.add_argument("--publish-policy", default="",
                    help="every:N | interval:S | drain[:W] "
                         "(default: every:<--publish-every>)")
    ap.add_argument("--spill-dir", default="",
                    help="required for --backpressure spill")
    ap.add_argument("--checkpoint-dir", default="",
                    help="enable crash-safe checkpoints in background mode")
    ap.add_argument("--checkpoint-every", type=int, default=16,
                    help="batches between checkpoints (with --checkpoint-dir)")
    ap.add_argument("--restore", action="store_true",
                    help="resume from the latest checkpoint in "
                         "--checkpoint-dir before serving")
    ap.add_argument("--ingest-dedup", action="store_true",
                    help="pre-aggregate duplicate (src, dst) rows on the "
                         "host before each coalesced ingest dispatch")
    ap.add_argument("--span-log", default="", metavar="PATH",
                    help="on exit, append the bounded trace-span ring "
                         "(ingest enqueue -> dispatch -> publish) to PATH "
                         "as JSONL")
    # ---- the JAX driver's other parts: refused below ----
    later = ap.add_argument_group(
        "not ported yet", "accepted for the JAX driver's command lines; "
        "setting one exits with an error naming its ROADMAP item")
    later.add_argument("--no-donate", action="store_true")
    later.add_argument("--serve", default="", metavar="HOST:PORT")
    later.add_argument("--connections", type=int, default=4)
    later.add_argument("--max-inflight", type=int, default=4096)
    later.add_argument("--tenant-qps", type=float, default=0.0)
    later.add_argument("--auth-token", default="")
    later.add_argument("--metrics-json", default="", metavar="PATH")
    later.add_argument("--metrics-interval-s", type=float, default=1.0)
    args = ap.parse_args(argv)
    _valid_backends = ("thread", "process", "socket")
    if args.runtime_backend not in _valid_backends \
            and not args.runtime_backend.startswith("socket:"):
        ap.error(f"--runtime-backend must be one of {_valid_backends} or "
                 f"socket:HOST:PORT[,...], got {args.runtime_backend!r}")
    for flag, given, item in _LATER:
        if given(args):
            ap.error(f"{flag} is not ported yet (ROADMAP item {item}); "
                     "this driver runs the cooperative and background "
                     "(thread) modes")
    if args.no_donate:
        ap.error("--no-donate has nothing to switch off: the port's ingest "
                 "always writes in place into the snapshot buffer's private "
                 "delta (there is no buffer donation)")
    if not args.background_ingest:
        # these only take effect inside the runtime; silently ignoring them
        # would serve a different run than the one asked for
        for flag, is_set in [("--restore", args.restore),
                             ("--checkpoint-dir", bool(args.checkpoint_dir)),
                             ("--spill-dir", bool(args.spill_dir)),
                             ("--backpressure",
                              args.backpressure != "block"),
                             ("--publish-policy", bool(args.publish_policy)),
                             ("--queue-capacity",
                              args.queue_capacity != 64),
                             ("--ingest-dedup", args.ingest_dedup)]:
            if is_set:
                ap.error(f"{flag} requires --background-ingest")
    if args.shards < 1:
        ap.error("--shards must be >= 1")
    if args.shards > 1 and not args.background_ingest:
        # sharding exists to parallelize ingest; a cooperative single
        # thread stepping K shards round-robin would serve the same stream
        # slower
        ap.error("--shards > 1 requires --background-ingest")
    if args.restore and not args.checkpoint_dir:
        ap.error("--restore requires --checkpoint-dir")
    if args.backpressure == "spill" and not args.spill_dir:
        ap.error("--backpressure spill requires --spill-dir")
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
    ``--warm-batches`` batches and published (epoch 1) unless ``--restore``
    is to load it from a checkpoint."""
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
    if not args.restore:  # a restored tenant is already warm
        t0 = time.time()
        tenant.step(min(args.warm_batches,
                        max(1, tenant.stream.num_batches // 2)))
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


def install_graceful_drain(runtime):
    """SIGTERM/SIGINT -> graceful drain-and-stop, then exit 128+signum.

    An orchestrator's shutdown (or a terminal Ctrl-C) must not be a crash:
    the runtime drains its queues, publishes the final epoch and flushes a
    final checkpoint (when checkpointing is configured) before the process
    exits, so the next ``--restore`` resumes from the shutdown point.
    Worker failures found during the drain are reported but do not mask
    the signal exit code.

    Signal handlers can only be installed from the main thread; elsewhere
    (a driver run from another thread) this installs nothing.  Returns the
    handlers it replaced, for ``restore_signals`` once the run is over, so
    an in-process caller keeps its own handlers.
    """
    if threading.current_thread() is not threading.main_thread():
        return {}

    def handler(signum, frame):
        name = signal.Signals(signum).name
        print(f"{name}: draining ingest and flushing checkpoints before "
              "exit", file=sys.stderr)
        try:
            report = runtime.stop(drain=True, raise_on_failure=False)
            health = runtime.health()
            for tenant_id, rep in report.items():
                if rep.get("state") == "failed" or rep.get(
                        "unaccounted_edges"):
                    err = health.get(tenant_id, {}).get("error")
                    print(f"worker {tenant_id}: state={rep.get('state')} "
                          f"unaccounted={rep.get('unaccounted_edges')} "
                          f"error={err}", file=sys.stderr)
        finally:
            sys.exit(128 + signum)

    return {sig: signal.signal(sig, handler)
            for sig in (signal.SIGTERM, signal.SIGINT)}


def restore_signals(previous: dict) -> None:
    for sig, handler in previous.items():
        signal.signal(sig, handler)


def _runtime(args, **kw):
    from repro_torch.runtime import Runtime

    return Runtime(
        queue_capacity=args.queue_capacity,
        backpressure=args.backpressure,
        publish_policy=args.publish_policy or f"every:{args.publish_every}",
        checkpoint_dir=args.checkpoint_dir or None,
        checkpoint_every=args.checkpoint_every,
        spill_dir=args.spill_dir or None,
        dedup=args.ingest_dedup,
        # --publish-mode only chooses what a remote worker sends (item 12);
        # the thread backend shares the front by reference, as in JAX
        backend=args.runtime_backend,
        **kw)


def background_serve(args, tenant, engine, requests) -> tuple:
    """Queries (main thread) concurrent with a runtime ingest worker (its
    own thread, issuing on the same device stream as the queries)."""
    runtime = _runtime(args)
    runtime.attach(tenant, restore=args.restore)
    previous = install_graceful_drain(runtime)
    try:
        runtime.start(pumps=False)
        runtime.wait_ready()
        runtime.start_pumps()
        report, extras = run_load(args, engine, lambda: tenant.snapshot,
                                  requests)
        mid_metrics = runtime.metrics()[tenant.key.tenant_id]
        runtime.join_pumps()  # finish offering the stream, then drain
        final_report = runtime.stop(drain=True)
    finally:
        restore_signals(previous)
    tr = final_report[tenant.key.tenant_id]
    extras = {
        "ingest_mode": "background",
        "runtime_backend": args.runtime_backend,
        "backpressure": args.backpressure,
        "publish_policy": args.publish_policy or f"every:{args.publish_every}",
        "ingest_edges_per_s": mid_metrics["edges_per_s_ewma"],
        "publishes": tr["publishes"],
        "mean_publish_latency_ms": tr["mean_publish_latency_ms"],
        "max_queue_depth": tr["max_queue_depth"],
        "dropped_edges": tr["dropped_edges"],
        "overflow_edges": tr["overflow_edges"],
        "spilled_batches": tr["spilled_batches"],
        "unaccounted_edges": tr["unaccounted_edges"],
        "checkpoints": tr["checkpoints"],
        "worker_state": tr["state"],
        **extras,
    }
    return report, tenant.snapshot, extras


def _latency_fields(report) -> dict:
    return {
        "achieved_qps": round(report.achieved_qps, 1),
        "p50_ms": round(report.p50_ms, 3),
        "p90_ms": round(report.p90_ms, 3),
        "p99_ms": round(report.p99_ms, 3),
        "p999_ms": round(report.p999_ms, 3),
        "latency_hist": report.latency_hist,
        "n_requests": report.n_requests,
    }


def sharded_main(args) -> dict:
    """Sharded serving: K hash-band shards, one runtime worker per shard,
    scatter/gather queries (DESIGN.md §Sharding).  Prints the summary line
    and returns the run (``summary``, the sharded ``tenant``, the
    ``engine``, the ``requests``, the shards' runtime ``handles``)."""
    from repro_torch.serving import (ShardedQueryEngine, attach_shards,
                                     sharded_conservation)

    device = require_device(args.device)
    registry = SketchRegistry(depth=args.depth, scale=args.scale,
                              partitioner=args.partitioner,
                              sketch_backend=args.sketch_backend or None,
                              device=device)
    tenant = registry.open_sharded(args.dataset, args.sketch, args.budget_kb,
                                   seed=args.seed, n_shards=args.shards,
                                   shard_seed=args.shard_seed)
    stream = tenant.stream
    n_nodes = stream.spec.n_nodes
    print(f"sharded tenant {tenant.key.tenant_id} x{args.shards}: stream "
          f"{stream.num_batches} batches, universe {n_nodes}, on {device}",
          file=sys.stderr)

    if not args.restore:  # a restored tenant is already warm
        tenant.step(min(args.warm_batches,
                        max(1, stream.num_batches // 2)))
        snap = tenant.publish()
        print(f"warm: epochs {snap.epochs}, {snap.n_edges} edges",
              file=sys.stderr)

    mix = build_mix(args)
    requests = synth_requests(
        args.n_requests, mix, n_nodes=n_nodes, seed=args.seed + 7,
        heavy_universe=min(n_nodes, 1 << 14), heavy_threshold=100.0)
    engine = ShardedQueryEngine(QueryEngine())
    warm = synth_requests(args.batch_max, mix, n_nodes=n_nodes, seed=99,
                          heavy_universe=min(n_nodes, 1 << 14),
                          heavy_threshold=100.0)
    warm_bucket_ladder(engine, tenant.snapshot, warm)

    # under backlog, fold sub-batches back to full-batch dispatches so K
    # small shards don't pay K-fold fixed dispatch cost
    runtime = _runtime(args, coalesce_batches=max(4, args.shards),
                       coalesce_target=stream.batch_size)
    handles = attach_shards(runtime, tenant, restore=args.restore)
    previous = install_graceful_drain(runtime)
    try:
        runtime.start(pumps=False)
        runtime.wait_ready()
        runtime.start_pumps()
        report, extras = run_load(args, engine, lambda: tenant.snapshot,
                                  requests)
        mid = runtime.metrics()
        ingest_eps = sum(m["edges_per_s_ewma"] for m in mid.values())
        runtime.join_pumps()
        runtime.stop(drain=True)
    finally:
        restore_signals(previous)
    cons = sharded_conservation(handles, stream.spec.n_edges)

    summary = {
        "driver": "query_serve",
        "dataset": args.dataset,
        "sketch": args.sketch,
        "sketch_backend": registry.sketch_backend,
        "budget_kb": args.budget_kb,
        "ingest_mode": "sharded-background",
        "runtime_backend": args.runtime_backend,
        "n_shards": args.shards,
        "offered_qps": args.qps,
        **_latency_fields(report),
        "final_epochs": list(tenant.epochs),
        "total_edges": tenant.snapshot.n_edges,
        "ingest_edges_per_s": round(ingest_eps, 1),
        "per_shard_published": cons["per_shard_published"],
        "dropped_edges": cons["dropped_edges"],
        "stream_total_edges": cons["stream_total_edges"],
        "conservation_ok": cons["conservation_ok"],
        **extras,
        **{f"engine_{k}": v for k, v in engine.stats.items()},
        "device": registry.device,
    }
    print(json.dumps(summary))
    return {"summary": summary, "tenant": tenant, "engine": engine,
            "requests": requests, "handles": handles}


def _run(args) -> dict:
    """Serve, print the summary line, and return the run: ``summary``, the
    final ``tenant``, the ``engine`` and the measured ``requests`` (and,
    sharded, the shards' runtime ``handles``).  Exits 1 if edges went
    unaccounted (background) or conservation failed (sharded)."""
    if args.shards > 1:
        run = sharded_main(args)
        if not run["summary"]["conservation_ok"]:
            sys.exit(1)
        return run
    registry, tenant = open_tenant(args)
    engine, requests = warm_engine(args, tenant)
    serve = background_serve if args.background_ingest else cooperative_serve
    report, final, extras = serve(args, tenant, engine, requests)
    summary = {
        "driver": "query_serve",
        "dataset": args.dataset,
        "sketch": args.sketch,
        "sketch_backend": registry.sketch_backend,
        "budget_kb": args.budget_kb,
        "offered_qps": args.qps,
        **_latency_fields(report),
        "final_epoch": final.epoch,
        "total_edges": final.n_edges,
        **extras,
        **{f"engine_{k}": v for k, v in engine.stats.items()},
        "device": registry.device,
    }
    print(json.dumps(summary))
    if extras.get("unaccounted_edges"):
        sys.exit(1)
    return {"summary": summary, "tenant": tenant, "engine": engine,
            "requests": requests}


def main(argv=None) -> None:
    args = parse_args(argv)
    try:
        _run(args)
    finally:
        if args.span_log:
            from repro_torch.obs import get_trace_log

            n = get_trace_log().dump_jsonl(args.span_log)
            print(f"span log: {n} events -> {args.span_log}",
                  file=sys.stderr)


if __name__ == "__main__":
    main(sys.argv[1:])
