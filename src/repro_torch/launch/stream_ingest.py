"""Streaming-ingest driver: the paper's pipeline end to end.

stream -> reservoir sample -> VertexStats -> partition plan -> sketch ->
batched ingest -> edge-frequency queries -> ARE, printed as one JSON line
(the same line as the JAX package's driver prints), for every sketch kind
of the paper's comparison, with periodic checkpoints and resume:

  python -m repro_torch.launch.stream_ingest --dataset cit-HepPh \
      --budget-kb 512 --depth 7 --sketch countmin|gsketch|tcm|gmatrix|kmatrix \
      [--ckpt-dir DIR --steps-per-ckpt 16 [--resume]] [--scale 0.25] \
      [--device cuda]

An edge list on disk goes through the same pipeline from Python, as
``run_pipeline(build_parser().parse_args([...]), FileStream(path))``; like
the JAX package's driver, the command line reads no file.

Checkpoints use the JAX package's layout (``repro_torch.checkpoint.store``),
so either driver resumes from the other's.

``--runtime-backend thread|process|socket[:HOST:PORT,...]`` drives the same
pipeline's ingest through the ``repro_torch.runtime`` worker runtime (pump,
bounded queue, conservation verified after the drain; a remote worker owns
its sketch and ships published epochs back).  ``--listen HOST:PORT`` turns
the process into a standing socket-ingest worker host instead: it serves
worker sessions for any parent (this package's or the JAX package's) whose
runtime dials it, each on ``--device``; the other pipeline flags are
ignored, since the tenant spec arrives in the hello frame.
``--metrics-json PATH`` dumps the metrics hub to PATH in every mode.

The run is on the card (``--device cuda``, the default) unless
``--device cpu`` is given; without a card and without ``--device cpu`` it
exits with an error instead of running on the CPU (a ``--listen`` host
fails each session instead, and exits nonzero).
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
import time

import torch

from repro_torch.checkpoint import store
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
    ap.add_argument("--ckpt-dir", default="",
                    help="write a checkpoint here every --steps-per-ckpt "
                         "batches")
    ap.add_argument("--steps-per-ckpt", type=int, default=16)
    ap.add_argument("--resume", action="store_true",
                    help="with --ckpt-dir: continue from its latest "
                         "checkpoint's stream offset")
    ap.add_argument("--eval-queries", type=int, default=10_000)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda); with "
                         "--listen, the device of every session's tenant")
    ap.add_argument("--ingest-dedup", action="store_true",
                    help="runtime backends only: pre-aggregate duplicate "
                         "(src, dst) rows on the host before each coalesced "
                         "ingest dispatch")
    ap.add_argument("--runtime-backend", default="inline",
                    help="inline: this loop ingests directly (default). "
                         "thread/process/socket[:HOST:PORT,...]: drive "
                         "ingest through the repro_torch.runtime worker "
                         "runtime on that execution backend (pump + bounded "
                         "queue + conservation accounting; checkpoints use "
                         "the runtime's worker-state schema under a "
                         "per-tenant subdir). socket with no address "
                         "self-hosts a loopback worker; with addresses it "
                         "dials --listen worker hosts")
    ap.add_argument("--publish-mode", default="delta",
                    choices=["delta", "full"],
                    help="remote-backend snapshot publication: 'delta' "
                         "(default) ships only the per-epoch sketch delta, "
                         "sparse-encoded; 'full' ships whole fronts")
    ap.add_argument("--listen", default="", metavar="HOST:PORT",
                    help="worker-host mode: serve socket ingest worker "
                         "sessions at this address instead of running a "
                         "pipeline")
    ap.add_argument("--max-sessions", type=int, default=0,
                    help="with --listen: exit after N completed sessions "
                         "(0 = serve until signalled)")
    ap.add_argument("--idle-timeout-s", type=float, default=0.0,
                    help="with --listen: exit after this long with no live "
                         "session (0 = wait forever)")
    ap.add_argument("--auth-token", default="",
                    help="shared connection token (default: "
                         "$KMATRIX_NET_TOKEN); REQUIRED to --listen on a "
                         "non-loopback address")
    ap.add_argument("--metrics-json", default="", metavar="PATH",
                    help="periodically dump the merged metrics hub to PATH "
                         "as JSON (atomic replace; same payload as the "
                         "'metrics' wire frame); works in every mode")
    ap.add_argument("--metrics-interval-s", type=float, default=1.0,
                    help="with --metrics-json: seconds between dumps")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    ap = build_parser()
    args = ap.parse_args(argv)
    valid = ("inline", "thread", "process", "socket")
    if args.runtime_backend not in valid \
            and not args.runtime_backend.startswith("socket:"):
        ap.error(f"--runtime-backend must be one of {valid} or "
                 f"socket:HOST:PORT[,...], got {args.runtime_backend!r}")
    if args.ingest_dedup and args.runtime_backend == "inline" \
            and not args.listen:
        ap.error("--ingest-dedup requires a runtime backend "
                 "(--runtime-backend thread/process/socket)")
    return args


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
    """Run the pipeline on ``--dataset``'s generated stream: see
    :func:`run_pipeline`."""
    stream = make_stream(args.dataset, batch_size=args.batch_size,
                         seed=args.seed, scale=args.scale)
    return run_pipeline(args, stream)


def run_pipeline(args, stream) -> dict:
    """The pipeline on ``stream`` (a ``SyntheticStream``, or a
    ``FileStream`` of an edge list on disk) at ``args``' other flags: print
    its lines, and return the run's results: ``sketch``, ``module``,
    ``stream``, ``ARE`` (unrounded), ``n_edges`` and ``batches`` ingested
    by this run (from the resumed offset on), and ``ingest_seconds``."""
    device = require_device(args.device)
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

    offset = 0
    if args.resume and args.ckpt_dir:
        try:
            sk, meta = store.restore(args.ckpt_dir, sk)
            offset = meta["extra"]["stream_offset"]
            print(f"resumed from batch {offset}")
        except FileNotFoundError:
            print("no checkpoint found; starting fresh")

    t0 = time.perf_counter()
    n_edges = 0
    for i in range(offset, stream.num_batches):
        src, dst, w = stream.batch_numpy(i)
        n_edges += int((w > 0).sum())  # host count: no device sync per batch
        sk = mod.ingest(sk, EdgeBatch.from_numpy(src, dst, w, device=device))
        if args.ckpt_dir and (i + 1) % args.steps_per_ckpt == 0:
            store.save(args.ckpt_dir, i + 1, sk,
                       extra={"stream_offset": i + 1, "seed": args.seed})
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"ingest: {n_edges} edges in {dt:.2f}s "
          f"({n_edges/max(dt,1e-9)/1e6:.2f} M edges/s)")

    are = edge_are(stream, sk, mod, device, args.eval_queries)
    print(json.dumps({"sketch": args.sketch, "dataset": args.dataset,
                      "budget_kb": args.budget_kb, "ARE": round(are, 4)}))
    return {"sketch": sk, "module": mod, "stream": stream, "ARE": are,
            "n_edges": n_edges, "batches": stream.num_batches - offset,
            "ingest_seconds": dt}


def edge_are(stream, sk, mod, device, n_queries: int) -> float:
    """ARE of ``n_queries`` sampled edge-frequency queries against the
    stream's exact frequencies (paper Fig. 7 protocol)."""
    src, dst, w = stream.all_edges_numpy()
    fmap = exact_edge_frequencies(src, dst, w)
    qs, qd, _ = sample_stream(stream, n_queries, seed=99)
    true = lookup_exact(fmap, qs, qd)
    est = mod.edge_freq(sk, torch.as_tensor(qs, device=device),
                        torch.as_tensor(qd, device=device)).cpu()
    # on the host, so the mean is taken in one order whatever the device
    return float(average_relative_error(est, torch.as_tensor(true)))


def backend_arg(spec: str, publish_mode: str):
    """Backend arg for ``Runtime``, honouring ``--publish-mode``.  Only the
    remote backends publish over a transport; ``thread`` has no
    ``publish_mode`` attribute and ignores the flag."""
    if publish_mode == "delta":
        return spec  # the default everywhere; spec strings stay lazy
    from repro_torch.runtime.backend import resolve_backend

    backend = resolve_backend(spec)
    if hasattr(backend, "publish_mode"):
        backend.publish_mode = publish_mode
    return backend


def runtime_main(args) -> dict:
    """The pipeline with its ingest driven through the background ingest
    runtime on ``--runtime-backend`` (a process or socket worker owns the
    sketch; this process keeps the published snapshot for evaluation).
    Prints the JAX driver's lines plus ``device`` and returns the run:
    ``tenant``, ``report`` (the tenant's conservation report), ``ARE``."""
    from repro_torch.runtime import Runtime
    from repro_torch.serving import SketchRegistry

    device = require_device(args.device)
    registry = SketchRegistry(depth=args.depth, batch_size=args.batch_size,
                              sample_size=args.sample_size, scale=args.scale,
                              partitioner=args.partitioner,
                              sketch_backend=args.sketch_backend or None,
                              device=device)
    tenant = registry.open(args.dataset, args.sketch, args.budget_kb,
                           seed=args.seed)
    stream = tenant.stream
    print(f"stream: {stream.spec.name} nodes={stream.spec.n_nodes} "
          f"edges={stream.spec.n_edges} batches={stream.num_batches} "
          f"[runtime backend: {args.runtime_backend}]")
    runtime = Runtime(publish_policy="drain:0", reservoir_k=0,
                      checkpoint_dir=args.ckpt_dir or None,
                      checkpoint_every=args.steps_per_ckpt,
                      dedup=args.ingest_dedup,
                      backend=backend_arg(args.runtime_backend,
                                           args.publish_mode))
    restore = bool(args.resume and args.ckpt_dir)
    try:
        runtime.attach(tenant, restore=restore)
    except FileNotFoundError:
        print("no checkpoint found; starting fresh")
        runtime.attach(tenant, restore=False)
    if restore and tenant.offset:
        print(f"resumed from batch {tenant.offset}")
    t0 = time.perf_counter()
    runtime.start(pumps=False)
    runtime.wait_ready()
    runtime.start_pumps()
    runtime.join_pumps()
    report = runtime.stop(drain=True)[tenant.key.tenant_id]
    dt = time.perf_counter() - t0
    n_edges = report["ingested_edges"]
    print(f"ingest: {n_edges} edges in {dt:.2f}s "
          f"({n_edges/max(dt,1e-9)/1e6:.2f} M edges/s) "
          f"unaccounted={report['unaccounted_edges']}")
    if report["unaccounted_edges"]:
        raise SystemExit("edge conservation failed after drain")
    are = edge_are(stream, tenant.snapshot.sketch, tenant.mod, device,
                   args.eval_queries)
    print(json.dumps({"sketch": args.sketch, "dataset": args.dataset,
                      "budget_kb": args.budget_kb,
                      "runtime_backend": args.runtime_backend,
                      "ARE": round(are, 4), "device": str(device)}))
    return {"tenant": tenant, "report": report, "ARE": are}


def listen_main(args) -> dict:
    """Standing worker host: serve socket ingest sessions until signalled
    (or until ``--max-sessions`` sessions completed, for scripted runs),
    each session's tenant on ``--device``.  Exits 1 if a session failed
    or was aborted."""
    from repro_torch.net import wire
    from repro_torch.net.ingest_server import WorkerServer

    host, port = wire.parse_hostport(args.listen)
    try:
        server = WorkerServer(host, port, auth_token=args.auth_token or None,
                              device=args.device)
    except ValueError as exc:  # non-loopback bind without a token
        raise SystemExit(str(exc)) from exc
    print(json.dumps({"listening": f"{server.address[0]}:{server.address[1]}",
                      "max_sessions": args.max_sessions or None,
                      "device": server.device}), flush=True)

    def _stop(signum, frame):
        server.stop()

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _stop)
        signal.signal(signal.SIGINT, _stop)
    server.serve_forever(
        max_sessions=args.max_sessions or None,
        idle_timeout_s=args.idle_timeout_s or None)
    line = {"sessions_served": server.sessions_served,
            "results": server.session_results, "device": server.device}
    print(json.dumps(line), flush=True)
    if any(str(r).startswith("aborted") or r == "failed"
           for r in server.session_results):
        raise SystemExit(1)
    return line


def main(argv=None) -> None:
    args = parse_args(argv)
    dumper = None
    if args.metrics_json:
        from repro_torch.obs import MetricsJsonDumper

        dumper = MetricsJsonDumper(args.metrics_json,
                                   interval_s=args.metrics_interval_s).start()
    try:
        if args.listen:
            listen_main(args)
        elif args.runtime_backend != "inline":
            runtime_main(args)
        else:
            inline_main(args)
    finally:
        if dumper is not None:
            dumper.stop()


if __name__ == "__main__":
    main(sys.argv[1:])
