#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero without the final ``ok`` line):

  A. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
     (all at once) and print the card's name and power limit.
  G. Recsys serving: the Factorization Machine at full width (39 fields,
     k = 10, 10,000,384 table rows; random weights from a torch seed) on
     ``cuda``, through ``build_fm_cell`` for the three serve-kind cells:
     ``serve_p99`` (512 x 39), ``serve_bulk`` (262,144 x 39) and
     ``retrieval_cand`` (1 query, 1,000,000 candidates), ids uniform in
     [0, 2^30) from a numpy seed.  Launch counts are zeroed just before and
     read just after each cell: 3 ``embedding_bag`` launches per forward,
     6 per retrieval, no other kernel.  The same cell runs on the CPU
     through the plain versions on the same weights: every bag's output
     must be bit-equal, and logits and scores equal within rtol 1e-5,
     atol 1e-6 (the k-sum, the elementwise tail and the retrieval GEMV run
     in another order on the card; TF32 is off).  Each cell's latency
     (CUDA events around one synchronised call, median of 30 after
     warm-up), rows/s, and the device's busy time per call with its
     largest operations (torch.profiler).  It runs after A and needs none
     of the sketch phases.
  C. The main path: the paper pipeline on the full cit-HepPh stream (scale
     1.0: 421,578 edges in 52 batches of 8192), 512 KB budget, depth 7,
     banded partitioner, 10,000 evaluation queries, through the port's
     ``stream_ingest`` entry point on ``cuda`` with the width-class layout.
     Launch counts are zeroed just before and read just after: every batch
     must launch ``matrix_ingest_edges`` once (52) and the rectangle
     ``matrix_ingest`` never.  The same stream is ingested again through
     the flat layout on the card and through the plain versions on the CPU
     (which the CPU tests hold against the JAX package): counters, conn,
     the overflow tally and ARE must be identical.  Then the same stream at
     a forced capacity of 128, so that the tally is nonzero: the edge
     ingest on the card, its plain version on the CPU and the rectangle
     dispatch (``ops.rectangle_ingest``) on the card must agree.
  F. The paper's comparison (Fig. 7 at 512 KB): the same driver at the
     same flags with ``--sketch countmin|gsketch|tcm|gmatrix``, and with
     ``--sketch kmatrix --sketch-backend flat``, on ``cuda`` and on the
     CPU.  Counters and ARE must be identical; every TCM/gMatrix run must
     launch ``matrix_ingest_edges`` once per batch (52) and
     ``matrix_lookup_edges`` once (its 10,000 evaluation queries), and no
     rectangle entry point.  One line per sketch (ARE, M edges/s end to
     end, launches) and the ARE ordering, the width-class kMatrix's from
     phase C; the ordering is printed, not gated.
  D. Reachability: the closure of the kMatrix sketch's connectivity layers
     (w = 43) and of the gMatrix table (w = 136), each one ``reach_closure``
     launch, and of a gMatrix table at 2 MB (w = 273, wider than one
     block's shared memory holds) through ``reach_step``, one launch per
     squaring; 10,000 sampled pairs each, compared with the CPU plain
     closure.  Then a checkpoint round trip on the card through the
     driver: the main path with ``--ckpt-dir --steps-per-ckpt 26``, then
     ``--resume`` from the batch-26 checkpoint; both must equal the
     uninterrupted phase-C sketch.
  E. A profile of the main path's ingest loop: host time per batch for
     making, copying and issuing it, the device's busy and idle shares, and
     the top operations by device and host time, for the edge ingest and,
     in the same run, for the rectangle dispatch (rectangles, edges,
     edges, rectangles).
  H. Online serving: the port's ``query_serve`` driver (cooperative mode)
     on ``cuda`` at the JAX driver's defaults — the full cit-HepPh stream,
     256 KB, depth 5, 8,000 requests offered open-loop at 2,000 QPS,
     ``batch_max`` 512, a publish every 4 batches after 4 warm batches, the
     default query mix — for a width-class kMatrix tenant and a gMatrix
     tenant.  Launch counts are zeroed just before and read just after each
     run: ``matrix_ingest_edges`` once per batch (52), ``reach_closure``
     once per closure-cache miss, no ``reach_step``, ``matrix_lookup_edges``
     for the gMatrix's edge, path and subgraph groups and never for the
     kMatrix, no rectangle entry point.  Gates: the final front bit-equal to
     one replay of the stream on the card and on the CPU plain path, its
     edge count the stream's; the first 1,000 requests (every family)
     answered by the engine on the final snapshot equal to the direct
     answers on the card and to the CPU engine's on the CPU replay; a held
     snapshot keeps its counters and its answers to 200 requests after 4
     more batches are ingested and published, and shares no counter
     storage with the new front.  Each run's summary line (achieved QPS,
     p50/p90/p99, epochs, closure hits and misses), then a shorter run of
     600 requests under ``torch.profiler``: the device's busy and idle
     share over the load window and the top operations by device and host
     time.
  I. Background and sharded serving: the same two tenants at the same
     flags with ``--background-ingest`` (publish policy every:4, queue 64,
     backpressure block; ingest in a runtime worker thread while the main
     thread serves), the kMatrix again with ``--ingest-dedup``, then both
     with ``--shards 4`` (four shards on the one card).  Launch counts are
     zeroed just before and read just after each run, and the run's
     ``SnapshotBuffer.ingest`` calls are counted by wrapping the method:
     ``matrix_ingest_edges`` once per buffer ingest, ``reach_closure`` once
     per closure miss (sharded: one over the summed shard layers), no
     ``reach_step``, ``matrix_lookup_edges`` only for the gMatrix.  Gates:
     no unaccounted or dropped edge, the worker stopped, 421,578 edges; the
     final front (sharded: ``merged_snapshot()``) bit-equal to phase H's
     replays on the card and the CPU (counters; the overflow tally depends
     on dispatch sizes); the first 1,000 requests equal to the direct
     answers on the card (sharded: ``sharded_direct_answers``, and the CPU
     sharded engine on a CPU replay of the four shard views); dedup's
     pools and conn equal to the run without it; sharded conservation.
     Then a sharded crash and resume through ``attach_shards`` with
     checkpoints (shards at four offsets from pre-filled queues, stopped
     crash-like, restored into a new registry and drained: the merged
     front equals the replays, conservation holds, a different
     ``--shard-seed`` is refused by the manifest); the drain rate of
     ``measure_sharded_ingest``, 5 drains at each K = 1, 2, 4; and a
     profiled 600-request window of the sharded kMatrix run.  Each run
     also prints the engine's groups by family (the hub), each served
     batch's host time, and each request's latency split at the last
     buffer ingest, with p99 per 0.5 s window of arrivals.
  B. Each kernel against its plain version on the card, on the inputs the
     main paths give it (``matrix_ingest_edges``: the kMatrix batch and the
     P = 1 gMatrix batch, plus a turnstile batch and one whose cells pass
     2^24; ``matrix_lookup_edges``: the gMatrix evaluation queries; the
     rectangle ``matrix_ingest`` on the rectangles ``ops.dispatch_rectangles``
     builds from the kMatrix batch and on the gMatrix batch's
     ``node_cells``, ``matrix_lookup`` on the queries' ``node_cells``; the
     kMatrix and gMatrix closures for ``reach_closure`` and their
     squarings for ``reach_step``, every bag of phase G for
     ``embedding_bag``) plus one wide shape each for the sketch kernels
     (``reach_step`` also at phase D's 2 MB table): bit-equal results, and
     times
     of the kernel, the plain version and one PyTorch library call computing
     the same function, beside the least time the card could take
     (``bound_ms``).  ``ms`` keys are CUDA-event times of back-to-back calls
     after warm-up (host launch overhead included); ``device_ms`` keys are
     the launched kernels' own time from ``torch.profiler``.

The last lines are one ``{"kernels": [...]}`` JSON object and then
``{"ok": true, "device": {...}}``.  Each kernel's ``launches`` is summed
over the paths that run it, each path counted from zero just before it
runs (``launches_by_path``).
"""
from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_FLOPS = 989e12  # bf16 on the tensor cores, which B2 runs

SLICE_FLAGS = ["--dataset", "cit-HepPh", "--scale", "1.0", "--budget-kb", "512",
               "--depth", "7", "--batch-size", "8192", "--partitioner", "banded",
               "--eval-queries", "10000", "--sketch-backend", "width_class"]
REACH_PAIRS = 10_000
# phase D's third closure: a gMatrix table too wide for one block (w = 273)
WIDE_REACH_FLAGS = [*SLICE_FLAGS, "--sketch", "gmatrix", "--budget-kb", "2048"]
FM_CELLS = ("serve_p99", "serve_bulk", "retrieval_cand")
FM_BAGS = {"serve": 3, "retrieval": 6}  # embedding_bag launches per step
FM_RTOL, FM_ATOL = 1e-5, 1e-6
# phase F's runs: the four baselines, and kMatrix in the flat layout, whose
# partitions keep their planned widths (the width-class layout of phase C
# rounds them down to powers of two and so holds fewer counters)
COMPARED = {kind: ["--sketch", kind]
            for kind in ("countmin", "gsketch", "tcm", "gmatrix")}
COMPARED["kmatrix-flat"] = ["--sketch", "kmatrix", "--sketch-backend", "flat"]
# phase H: the JAX query_serve driver's defaults, on the card
SERVE_FLAGS = ["--dataset", "cit-HepPh", "--scale", "1.0", "--budget-kb", "256",
               "--depth", "5", "--qps", "2000", "--n-requests", "8000",
               "--batch-max", "512", "--publish-every", "4",
               "--warm-batches", "4", "--device", "cuda"]
SERVE_KINDS = ("kmatrix", "gmatrix")
SERVE_CHECKED = 1000  # requests whose answers are gated
SERVE_HELD = 200  # requests asked again of a held snapshot
SERVE_PROFILED = 600  # requests of the profiled run (0.3 s offered)
# phase I: the same runs with ingest in runtime workers, then 4 shards
BG_FLAGS = [*SERVE_FLAGS, "--background-ingest", "--publish-policy",
            "every:4", "--queue-capacity", "64", "--backpressure", "block"]
STREAM_EDGES = 421_578  # cit-HepPh, weight > 0
RESUME_EVERY = 4  # batches between checkpoints of the resumed shards
RESUME_OFFSETS = (12, 20, 28, 36)  # per shard, multiples of RESUME_EVERY
DRAIN_SHARDS = (1, 2, 4)
DRAIN_REPEATS = 5  # drains at each K, for the spread
LATENCY_BIN_S = 0.5  # width of the arrival windows of the latency timeline


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profiled(torch, fn, iters: int, synced: bool = False):
    """Device rows of ``key_averages()`` over ``iters`` calls of ``fn()``
    (each followed by a synchronise if ``synced``).  The profiler traces
    a first cycle of ``iters`` calls and throws it away, since a session
    that records from its start was seen to lose its first calls."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    cycles = []  # the profiler clears its events when a cycle ends
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: cycles.append(p.key_averages())
                 ) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
                if synced:
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
            prof.step()
    return cycles[-1] if cycles else []


def _per_call_us(event, iters: int) -> float:
    """A kernel row's device time per call: its mean duration times the
    whole number of launches per call its count shows."""
    us = _self_device_us(event)
    if us <= 0 or event.count == 0:
        return 0.0
    return us / event.count * max(1, round(event.count / iters))


def device_ms(torch, fn, iters: int = 20, attempts: int = 3):
    """Device time per call of ``fn()`` from ``torch.profiler``: the summed
    duration of the kernels it launched, per call.  Unlike ``time_ms`` it
    excludes the host's launch overhead.  A session that records no
    device time at all (seen now and then) is run again; None when every
    attempt records none."""
    for _ in range(attempts):
        total_us = sum(_per_call_us(e, iters)
                       for e in _profiled(torch, fn, iters))
        if total_us > 0:
            return total_us / 1e3
    return None


def _self_device_us(event) -> float:
    """Device time of a kernel row of ``key_averages()``; 0 for host-side
    rows, whose own device-time column repeats their kernels' time."""
    from torch.autograd import DeviceType

    if getattr(event, "device_type", None) != DeviceType.CUDA:
        return 0.0
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.failures: list[str] = []

    def check(self, cond: bool, what: str) -> None:
        status = "ok" if cond else "FAIL"
        print(f"  [{status}] {what}")
        if not cond:
            self.failures.append(what)

    def phase(self, name: str, fn, *args):
        print(f"== {name}", flush=True)
        try:
            return fn(*args)
        except Exception:  # a phase that raises fails the run, reported here
            traceback.print_exc(file=sys.stdout)
            self.failures.append(f"{name}: raised")
            return None


KERNEL_NAMES = ("matrix_ingest", "matrix_ingest_edges", "matrix_lookup",
                "matrix_lookup_edges", "reach_step", "reach_closure",
                "embedding_bag")


def _wrappers() -> dict:
    from repro_torch import kernels

    return {name: getattr(kernels, name) for name in KERNEL_NAMES}


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0 (just before a path)."""
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    """Every kernel wrapper's launch count (just after a path)."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def same_state(a, b) -> bool:
    """Whether two sketches hold identical leaves and layout, wherever they
    live (export_state copies every leaf to the host)."""
    from repro_torch import interop

    al, ast_ = interop.export_state(a)
    bl, bst = interop.export_state(b)
    return ast_ == bst and sorted(al) == sorted(bl) and all(
        al[k].dtype == bl[k].dtype and (al[k] == bl[k]).all() for k in al)


def phase_build(smoke):
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    print(f"  built {sorted(report) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f}s wall")
    for name, info in report.items():
        print(f"  {name}: nvcc {info['seconds']:.2f}s")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    line = card_line()
    print(line)
    return line


def phase_slice(smoke):
    torch = smoke.torch
    from repro_torch.core import EdgeBatch
    from repro_torch.core import kmatrix as km
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.core.metrics import exact_edge_frequencies, lookup_exact
    from repro_torch.launch import stream_ingest
    from repro_torch.streams import sample_stream

    parser = stream_ingest.build_parser()
    # warm-up on a small stream: first-call costs stay out of the timed run
    stream_ingest.inline_main(parser.parse_args(
        ["--scale", "0.03", "--eval-queries", "100", "--device", "cuda"]))

    reset_launches()
    run = stream_ingest.inline_main(
        parser.parse_args([*SLICE_FLAGS, "--device", "cuda"]))
    launches = read_launches()
    sk = run["sketch"]
    classes = sum(1 for n in sk.class_counts if n)
    print(f"  classes widths={sk.class_widths} counts={sk.class_counts} "
          f"conn_w={sk.conn_w} capacity="
          f"{kma.dispatch_capacity(sk, 8192)} overflow={int(sk.overflow)}")
    print(f"  launches on the main path: {launches}")
    smoke.check(type(sk).__name__ == "KMatrixAccel", "width-class sketch")
    smoke.check(run["batches"] == 52, f"52 batches (got {run['batches']})")
    smoke.check(launches["matrix_ingest_edges"] == run["batches"],
                f"matrix_ingest_edges launches == batches ({run['batches']}; "
                f"{classes} classes, one launch each batch)")
    smoke.check(launches["matrix_ingest"] == 0,
                "no rectangle matrix_ingest launch on the main path")
    smoke.check(launches["reach_step"] == launches["reach_closure"] == 0,
                "no reach_step or reach_closure launch in ingest")
    smoke.check(launches["matrix_lookup"] == launches["matrix_lookup_edges"] == 0,
                "no matrix_lookup launch (width-class queries are gathers)")
    smoke.check(launches["embedding_bag"] == 0, "no embedding_bag launch")
    rate = run["n_edges"] / run["ingest_seconds"] / 1e6
    print(f"  ingest: {run['n_edges']} edges in {run['ingest_seconds']:.4f}s "
          f"= {rate:.3f} M edges/s end to end (cuda); ARE={run['ARE']!r}")

    stream = run["stream"]
    qs, qd, _ = sample_stream(stream, 10_000, seed=99)
    src, dst, w = stream.all_edges_numpy()
    true = lookup_exact(exact_edge_frequencies(src, dst, w), qs, qd)
    est = kma.edge_freq(sk, torch.as_tensor(qs, device="cuda"),
                        torch.as_tensor(qd, device="cuda")).cpu().numpy()
    smoke.check(bool((est >= true).all()),
                "estimates never undercount (one-sided error)")
    smoke.check(math.isfinite(run["ARE"]) and run["ARE"] >= 0, "ARE finite, >= 0")

    # the flat layout on the card, from the same (empty) layout
    flat = kma.to_flat_layout(kma.empty_like(sk))
    for i in range(stream.num_batches):
        km.ingest(flat, EdgeBatch.from_numpy(*stream.batch_numpy(i),
                                             device="cuda"))
    twin = kma.to_flat_layout(sk)
    smoke.check(torch.equal(twin.pool, flat.pool)
                and torch.equal(twin.conn, flat.conn),
                "flat-layout ingest on cuda == width-class ingest (bit-exact)")

    # the plain versions on the CPU
    cpu = stream_ingest.inline_main(
        parser.parse_args([*SLICE_FLAGS, "--device", "cpu"]))
    smoke.check(same_state(sk, cpu["sketch"]),
                "cuda sketch == cpu plain sketch: pools, conn, overflow, "
                "routes, hashes")
    smoke.check(cpu["ARE"] == run["ARE"],
                f"ARE cuda == cpu ({run['ARE']!r} vs {cpu['ARE']!r})")
    _forced_overflow(smoke, sk, cpu["sketch"], stream)
    return {"run": run, "cpu": cpu, "launches": launches, "rate": rate}


def _forced_overflow(smoke, sk, sk_cpu, stream, capacity: int = 128):
    """The main path's stream at a forced dispatch capacity, so that the
    overflow tally is nonzero: the edge ingest on the card, its plain
    version on the CPU and the rectangle dispatch on the card."""
    from repro_torch.core import EdgeBatch
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.kernels import ops

    edges, rect, cpu = (kma.empty_like(sk), kma.empty_like(sk),
                        kma.empty_like(sk_cpu))
    for i in range(stream.num_batches):
        arrays = stream.batch_numpy(i)
        batch = EdgeBatch.from_numpy(*arrays, device="cuda")
        kma.ingest(edges, batch, capacity=capacity)
        ops.rectangle_ingest(rect, batch, capacity=capacity)
        kma.ingest(cpu, EdgeBatch.from_numpy(*arrays, device="cpu"),
                   capacity=capacity)
    tally = int(edges.overflow)
    print(f"  capacity {capacity}: overflow tally {tally} (edge ingest), "
          f"{int(rect.overflow)} (rectangles), {int(cpu.overflow)} (cpu)")
    smoke.check(tally > 0, f"capacity {capacity}: a nonzero overflow tally")
    smoke.check(same_state(edges, cpu),
                f"capacity {capacity}: cuda edge ingest == cpu plain "
                "(pools, conn, overflow)")
    smoke.check(same_state(edges, rect),
                f"capacity {capacity}: cuda edge ingest == rectangle dispatch "
                "(pools, conn, overflow)")
    smoke.check(same_state(edges.replace(overflow=sk.overflow), sk),
                f"capacity {capacity}: the counters do not depend on capacity")


def phase_compare(smoke, sl):
    """The paper's Fig. 7 at 512 KB on the card: every baseline, and the
    flat-layout kMatrix, through the driver at the slice's flags, on cuda
    and on the CPU."""
    from repro_torch.launch import stream_ingest

    parser = stream_ingest.build_parser()
    runs, cpus, launches = {}, {}, {}
    for kind, flags in COMPARED.items():
        # warm-up: the kind's first-call costs stay out of the timed run
        stream_ingest.inline_main(parser.parse_args(
            ["--scale", "0.03", "--eval-queries", "100", *flags,
             "--device", "cuda"]))
        reset_launches()
        run = stream_ingest.inline_main(parser.parse_args(
            [*SLICE_FLAGS, *flags, "--device", "cuda"]))
        launches[kind] = read_launches()
        cpu = stream_ingest.inline_main(parser.parse_args(
            [*SLICE_FLAGS, *flags, "--device", "cpu"]))
        rate = run["n_edges"] / run["ingest_seconds"] / 1e6
        print(f"  {kind:12s} [{type(run['sketch']).__name__}] "
              f"counters={run['sketch'].num_counters} ARE={run['ARE']!r} "
              f"ingest={rate:.3f} M edges/s end to end (cuda, "
              f"{run['ingest_seconds']:.4f}s) launches={launches[kind]}")
        smoke.check(run["batches"] == 52 and run["n_edges"] == 421_578,
                    f"{kind}: 52 batches, 421,578 edges")
        smoke.check(same_state(run["sketch"], cpu["sketch"]),
                    f"{kind}: cuda counters == cpu plain counters")
        smoke.check(run["ARE"] == cpu["ARE"] and math.isfinite(run["ARE"]),
                    f"{kind}: ARE cuda == cpu ({run['ARE']!r})")
        matrix = kind in ("tcm", "gmatrix")
        expect = {k: 0 for k in KERNEL_NAMES}
        expect["matrix_ingest_edges"] = run["batches"] if matrix else 0
        expect["matrix_lookup_edges"] = 1 if matrix else 0
        smoke.check(launches[kind] == expect,
                    f"{kind}: launches {launches[kind]} == {expect}")
        runs[kind], cpus[kind] = run, cpu
        runs[kind]["rate"] = rate
    smoke.check(same_state(runs["tcm"]["sketch"].replace(kind="gmatrix"),
                           runs["gmatrix"]["sketch"]),
                "tcm and gmatrix tables identical (same seed, as in JAX)")
    are = {"kmatrix": sl["run"]["ARE"],
           **{k: r["ARE"] for k, r in runs.items()}}
    rates = {"kmatrix": sl["rate"], **{k: r["rate"] for k, r in runs.items()}}
    order = sorted(are, key=are.get)
    print("  ARE at 512 KB, lower is better (Fig. 7; printed, not gated): "
          + " < ".join(f"{k} {are[k]:.4f}" for k in order))
    print(f"  summary: {json.dumps({'ARE': are, 'M_edges_per_s': rates})}")
    return {"runs": runs, "cpu": cpus, "launches": launches}


def _reach_path(smoke, label, sk, sk_cpu, n, answer):
    """Close ``sk``'s adjacency layers on the card and answer REACH_PAIRS
    pairs of vertex ids below ``n`` through ``answer(sketch, src, dst)``;
    hold closure and answers against the CPU plain version.  Returns the
    path's reach_step and reach_closure launches."""
    torch = smoke.torch
    from repro_torch.core import queries as q
    from repro_torch.kernels.reach_closure import CLOSURE_MAX_W

    import numpy as np

    rng = np.random.default_rng(7)
    qs = torch.as_tensor(rng.integers(0, n, REACH_PAIRS).astype("int32"))
    qd = torch.as_tensor(rng.integers(0, n, REACH_PAIRS).astype("int32"))
    reset_launches()
    answers = answer(sk, qs.cuda(), qd.cuda())
    torch.cuda.synchronize()
    launches = {k: read_launches()[k] for k in ("reach_step", "reach_closure")}
    w = q.closure_layers(sk).shape[-1]
    steps = q._closure_steps(w, None)
    # one launch for the whole closure where a layer fits one block, else
    # one reach_step launch per squaring
    expect = ({"reach_step": 0, "reach_closure": 1} if w <= CLOSURE_MAX_W
              else {"reach_step": steps, "reach_closure": 0})
    print(f"  {label}: launches {launches} (w={w}, {steps} squarings, "
          f"one block holds w <= {CLOSURE_MAX_W})")
    smoke.check(launches == expect, f"{label}: launches {launches} == {expect}")
    ref = answer(sk_cpu, qs, qd)
    smoke.check(torch.equal(answers.cpu(), ref),
                f"{label}: {REACH_PAIRS} reachability answers == cpu plain "
                f"({int(ref.sum())} reachable)")
    closure = q.build_closure(q.closure_layers(sk))
    smoke.check(torch.equal(closure.cpu(),
                            q.build_closure(q.closure_layers(sk_cpu))),
                f"{label}: kernel closure == cpu plain closure")
    plain = q.build_closure(q.closure_layers(sk), backend="plain")
    smoke.check(torch.equal(plain, closure),
                f"{label}: plain closure on cuda == kernel")
    return launches


def _checkpoint_round_trip(smoke, sl):
    """The driver's checkpoint path on the card: a run at the slice's flags
    that saves every 26 batches, then ``--resume`` from the batch-26
    checkpoint (the batch-52 one removed first).  Both runs must equal the
    uninterrupted phase-C sketch."""
    from repro_torch.checkpoint import store
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.launch import stream_ingest

    full = sl["run"]["sketch"]
    parser = stream_ingest.build_parser()
    with tempfile.TemporaryDirectory(prefix="kmatrix_ckpt_") as ckpt:
        flags = [*SLICE_FLAGS, "--device", "cuda", "--ckpt-dir", ckpt,
                 "--steps-per-ckpt", "26"]
        saved = stream_ingest.inline_main(parser.parse_args(flags))
        smoke.check(same_state(saved["sketch"], full)
                    and saved["ARE"] == sl["run"]["ARE"],
                    "run saving every 26 batches == phase-C sketch and ARE")
        meta = store.read_meta(ckpt, 26)
        smoke.check(meta["extra"] == {"stream_offset": 26, "seed": 0},
                    f"checkpoint 26 holds stream offset 26 ({meta['extra']})")
        last, _ = store.restore(ckpt, kma.empty_like(full), step=52)
        smoke.check(same_state(last, full),
                    "checkpoint 52 restores the phase-C sketch (bit-exact)")
        shutil.rmtree(Path(ckpt) / f"step_{52:010d}")
        resumed = stream_ingest.inline_main(
            parser.parse_args([*flags, "--resume"]))
    sk = resumed["sketch"]
    smoke.check(resumed["batches"] == 26 and sk.conn.device.type == "cuda",
                f"--resume ingested batches 26-51 on cuda "
                f"(got {resumed['batches']} batches)")
    smoke.check(same_state(sk, full) and resumed["ARE"] == sl["run"]["ARE"],
                "26 batches + save + --resume + 26 batches == uninterrupted "
                "52-batch sketch and ARE (bit-exact)")


def phase_reach(smoke, sl, cmp):
    from repro_torch.core import queries as q
    from repro_torch.launch import stream_ingest

    n = sl["run"]["stream"].spec.n_nodes
    parser = stream_ingest.build_parser()
    wide = {dev: stream_ingest.inline_main(parser.parse_args(
        [*WIDE_REACH_FLAGS, "--device", dev]))["sketch"]
        for dev in ("cuda", "cpu")}
    smoke.check(same_state(wide["cuda"], wide["cpu"]),
                "gmatrix 2 MB: cuda table == cpu plain table")
    launches = {
        "kmatrix": _reach_path(
            smoke, "kmatrix conn", sl["run"]["sketch"], sl["cpu"]["sketch"],
            n, q.kmatrix_reachability),
        "gmatrix": _reach_path(
            smoke, "gmatrix table", cmp["runs"]["gmatrix"]["sketch"],
            cmp["cpu"]["gmatrix"]["sketch"], n, q.reachability),
        "gmatrix 2MB": _reach_path(
            smoke, "gmatrix 2 MB table", wide["cuda"], wide["cpu"], n,
            q.reachability),
    }
    _checkpoint_round_trip(smoke, sl)
    return {"launches": launches, "wide": wide["cuda"]}


def _profile_loop(smoke, stream, sk, ingest, label, show_top):
    """One pass of the ingest loop over ``stream`` under the profiler:
    host time per batch of making, copying and issuing it, and the device
    time of what the ingest launched."""
    torch = smoke.torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import EdgeBatch

    n = stream.num_batches
    t = {"make": 0.0, "copy": 0.0, "issue": 0.0}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall0 = time.perf_counter()
        for i in range(n):
            t0 = time.perf_counter()
            arrays = stream.batch_numpy(i)
            t1 = time.perf_counter()
            batch = EdgeBatch.from_numpy(*arrays, device="cuda")
            t2 = time.perf_counter()
            ingest(sk, batch)
            t3 = time.perf_counter()
            t["make"] += t1 - t0
            t["copy"] += t2 - t1
            t["issue"] += t3 - t2
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall0
    events = prof.key_averages()
    device_ms = sum(_self_device_us(e) for e in events) / 1e3
    row = {**{f"{k}_ms": v / n * 1e3 for k, v in t.items()},
           "wall_ms": wall / n * 1e3, "device_busy_ms": device_ms / n,
           "idle_share": 1 - device_ms / (wall * 1e3)}
    print(f"  {label}, per batch (host clock, profiler on): {json.dumps(row)}")
    if show_top:
        top = sorted(events, key=_self_device_us, reverse=True)[:8]
        for e in top:
            if _self_device_us(e) > 0:
                print(f"    device {_self_device_us(e) / n:9.2f} us/batch  "
                      f"x{e.count / n:5.1f}  {e.key[:90]}")
        top = sorted(events, key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:8]
        for e in top:
            print(f"    host   {e.self_cpu_time_total / n:9.2f} us/batch  "
                  f"x{e.count / n:5.1f}  {e.key[:90]}")
    return row


def phase_profile(smoke, sl):
    """Where one batch's time goes on the main path, for the edge ingest
    and the rectangle dispatch in turn (rectangles, edges, edges,
    rectangles), on fresh sketches; both must end equal."""
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.kernels import ops

    stream = sl["run"]["stream"]
    designs = {"edges": kma.ingest, "rectangles": ops.rectangle_ingest}
    rows = {name: [] for name in designs}
    finals = {}
    for turn, name in enumerate(("rectangles", "edges", "edges", "rectangles")):
        sk = kma.empty_like(sl["run"]["sketch"])
        rows[name].append(_profile_loop(smoke, stream, sk, designs[name],
                                        f"{name} (turn {turn + 1})",
                                        show_top=turn < 2))
        finals[name] = sk
    smoke.check(same_state(finals["edges"], finals["rectangles"])
                and same_state(finals["edges"], sl["run"]["sketch"]),
                "profiled edge ingest == rectangle dispatch == phase C sketch")
    summary = {name: {k: statistics.mean(r[k] for r in runs) for k in runs[0]}
               for name, runs in rows.items()}
    print(f"  summary, mean of two turns each: {json.dumps(summary)}")
    return summary


def _capture_bags(torch, fn):
    """``fn()``'s result and, for every ``embedding_bag`` call the FM made
    in it, ``(table, idx, weights, out)``.  The tensors are the call's
    own (nothing on the path writes to them afterwards), not copies."""
    from repro_torch.models.recsys import fm as fm_mod

    calls = []
    real = fm_mod.embedding_bag

    def record(table, idx, weights=None):
        out = real(table, idx, weights)
        calls.append((table, idx, weights, out))
        return out

    fm_mod.embedding_bag = record
    try:
        result = fn()
    finally:
        fm_mod.embedding_bag = real
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return result, calls


def _latencies_ms(torch, fn, n: int = 30, warmup: int = 3) -> list:
    """Latency of ``n`` single calls of ``fn()``: CUDA events around each
    call, the device idle before it (synchronised), so a call's time
    includes the host issuing it."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _device_breakdown(torch, fn, iters: int = 10):
    """Device time per call of ``fn()`` (each call synchronised, as a
    served request is) and its largest device operations, from
    ``torch.profiler``."""
    events = [e for e in _profiled(torch, fn, iters, synced=True)
              if _per_call_us(e, iters) > 0]
    busy = sum(_per_call_us(e, iters) for e in events) / 1e3
    top = sorted(events, key=lambda e: _per_call_us(e, iters), reverse=True)
    return busy, [(e.key[:70], _per_call_us(e, iters), e.count / iters)
                  for e in top[:6]]


def phase_fm(smoke, card):
    """The FM serving path at full width on the card, against the CPU."""
    torch = smoke.torch
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.models.recsys import fm as fm_mod

    cfg = registry._fm_config()
    t_phase = t0 = time.perf_counter()
    params = fm_mod.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    cpu_params = fm_mod.FM(cfg, params.emb.cpu(), params.lin.cpu(),
                           params.bias.cpu())
    mb = (params.emb.numel() + params.lin.numel()) * 4 / 1e6
    print(f"  {cfg}: emb {list(params.emb.shape)}, lin "
          f"{list(params.lin.shape)} ({mb:.1f} MB f32), made on cuda and "
          f"copied to the CPU in {time.perf_counter() - t0:.2f}s")
    smoke.check(cfg.table_rows == 10_000_384 and cfg.n_fields == 39
                and cfg.embed_dim == 10, "full width: 39 fields, k = 10, "
                "10,000,384 rows")
    rng = np.random.default_rng(0)
    launches, bags, summary = {}, {}, {}
    for name in FM_CELLS:
        cell = registry.build_fm_cell(name, params, rng, device="cuda")
        kind = RECSYS_SHAPES[name].kind
        reset_launches()
        out, calls = _capture_bags(torch, cell.run)
        launches[name] = read_launches()
        expect = {k: 0 for k in KERNEL_NAMES}
        expect["embedding_bag"] = FM_BAGS[kind]
        smoke.check(launches[name] == expect,
                    f"{name}: launches {launches[name]} == {expect}")
        what = "scores" if kind == "retrieval" else "logits"
        smoke.check(tuple(out.shape) == (cell.rows,)
                    and bool(torch.isfinite(out).all()),
                    f"{name}: {cell.rows} finite {what}")
        t1 = time.perf_counter()
        ref, cpu_calls = _capture_bags(torch, lambda: cell.step_fn(
            cpu_params, *(x.cpu() for x in cell.inputs)))
        cpu_s = time.perf_counter() - t1
        smoke.check(len(calls) == len(cpu_calls) and all(
            torch.equal(c[3].cpu(), r[3]) for c, r in zip(calls, cpu_calls)),
            f"{name}: {len(calls)} bag outputs bit-equal to the CPU plain "
            f"path ({cpu_s:.2f}s on the CPU)")
        err = float((out.cpu() - ref).abs().max())
        smoke.check(torch.allclose(out.cpu(), ref, rtol=FM_RTOL, atol=FM_ATOL),
                    f"{name}: within rtol {FM_RTOL}, atol {FM_ATOL} of the "
                    f"CPU path (max abs diff {err!r})")
        lat = sorted(_latencies_ms(torch, cell.run))
        med = statistics.median(lat)
        busy, top = _device_breakdown(torch, cell.run)
        summary[name] = {"rows": cell.rows, "median_ms": med,
                         "p10_ms": lat[len(lat) // 10],
                         "p90_ms": lat[len(lat) * 9 // 10],
                         "max_ms": lat[-1],
                         "rows_per_s": cell.rows / med * 1e3,
                         "device_busy_ms": busy, "idle_share": 1 - busy / med,
                         "cpu_check_s": cpu_s}
        print(f"  {name}: {json.dumps(summary[name])} ({card})")
        for key, us, count in top:
            print(f"    device {us:9.2f} us/call  x{count:4.1f}  {key}")
        bags[name] = calls
    fm_launches = {k: sum(v[k] for v in launches.values())
                   for k in KERNEL_NAMES}
    print(f"  launches on the FM path: {fm_launches}; phase G "
          f"{time.perf_counter() - t_phase:.1f}s")
    return {"launches": fm_launches, "bags": bags, "summary": summary}


def _counter_tensors(sk) -> list:
    """The counter tensors of a sketch (what ingest and merge write)."""
    out = list(getattr(sk, "pools", ()))
    return out + [getattr(sk, f) for f in ("pool", "conn", "overflow", "table")
                  if hasattr(sk, f)]


def _serve_run(smoke, kind):
    """One tenant's query_serve run on the card, launch-counted and gated."""
    torch = smoke.torch
    from repro_torch import interop
    from repro_torch.launch import query_serve
    from repro_torch.obs import get_hub, reset_hub
    from repro_torch.serving import QueryEngine, gates
    from repro_torch.serving import engine as eng
    from repro_torch.serving.snapshot import Snapshot

    args = query_serve.parse_args([*SERVE_FLAGS, "--sketch", kind])
    t0 = time.perf_counter()
    reset_hub()  # the engine's per-family group counts and times
    reset_launches()
    run = query_serve._run(args)
    torch.cuda.synchronize()
    launches = read_launches()
    run_s = time.perf_counter() - t0
    by_family = {labels["family"]: {"groups": hs["count"], "ms": hs["sum"] * 1e3}
                for name, labels, hs in get_hub().state()["hists"]
                if name == "repro_engine_group_seconds"}
    summary, tenant, stats = run["summary"], run["tenant"], run["engine"].stats
    final, stream, mod = tenant.snapshot, tenant.stream, tenant.mod
    print(f"  {kind}: achieved_qps={summary['achieved_qps']} offered="
          f"{summary['offered_qps']} p50_ms={summary['p50_ms']} p90_ms="
          f"{summary['p90_ms']} p99_ms={summary['p99_ms']} epochs="
          f"{summary['final_epoch']} closure hits={stats['closure_hits']} "
          f"misses={stats['closure_misses']} ({run_s:.1f}s run)")
    sk = final.sketch
    layout = ({"class_widths": sk.class_widths, "class_counts": sk.class_counts,
               "conn_w": sk.conn_w} if hasattr(sk, "class_widths")
              else {"table": list(sk.table.shape)})
    print(f"  {kind}: {type(sk).__name__} {json.dumps(layout)}, "
          f"{sk.num_counters} counters")
    print(f"  {kind}: launches on the serving path: {launches}")
    print(f"  {kind}: engine groups by family over the run, warm-up ladder "
          f"included (host clock per group, read-back included): "
          f"{json.dumps(dict(sorted(by_family.items())))}")
    batches = stream.num_batches
    smoke.check(batches == 52 and launches["matrix_ingest_edges"] == batches,
                f"{kind}: matrix_ingest_edges launches == batches ({batches})")
    smoke.check(launches["reach_closure"] == stats["closure_misses"] > 0,
                f"{kind}: reach_closure launches == closure misses "
                f"({stats['closure_misses']})")
    smoke.check(launches["reach_step"] == 0, f"{kind}: no reach_step launch")
    lookups = launches["matrix_lookup_edges"]
    smoke.check(lookups >= 1 if kind == "gmatrix" else lookups == 0,
                f"{kind}: matrix_lookup_edges launches {lookups} "
                f"({'>= 1' if kind == 'gmatrix' else '0: gathers'})")
    smoke.check(launches["matrix_ingest"] == launches["matrix_lookup"]
                == launches["embedding_bag"] == 0,
                f"{kind}: no rectangle entry point, no embedding_bag")
    live = sum(int((stream.batch_numpy(i)[2] > 0).sum()) for i in range(batches))
    smoke.check(summary["total_edges"] == final.n_edges == live == 421_578,
                f"{kind}: total_edges {summary['total_edges']} == the "
                f"stream's weight > 0 count ({live})")

    # final state: one replay of the stream on the card and on the CPU
    t1 = time.perf_counter()
    reqs = run["requests"][:SERVE_CHECKED]
    families = {r.family for r in reqs}
    smoke.check(families == {r.family for r in run["requests"]}
                and len(families) == 6,
                f"{kind}: the first {SERVE_CHECKED} requests hold every "
                f"family ({sorted(families)})")
    card_replay = gates.replay_sketch(mod, mod.empty_like(final.sketch),
                                      stream, batches)
    cpu_template = interop.import_state(
        *interop.export_state(mod.empty_like(final.sketch)), device="cpu")
    cpu_replay = gates.replay_sketch(mod, cpu_template, stream, batches)
    direct = eng.direct_answers(final, reqs)
    for where, replay in (("card", card_replay), ("CPU", cpu_replay)):
        verdict = gates.replay_exactness(final, replay, reqs, answers=direct)
        smoke.check(verdict["ok"] and same_state(final.sketch, replay),
                    f"{kind}: final front == one replay of the stream on the "
                    f"{where} (counters and {len(reqs)} direct answers): "
                    f"{verdict}")
    # answers: the engine on the final snapshot
    got = [r.value for r in QueryEngine().execute(final, reqs)]
    cpu_snap = Snapshot(final.tenant_id + "/cpu", final.epoch, cpu_replay,
                        final.kind, final.n_edges)
    on_cpu = [r.value for r in QueryEngine().execute(cpu_snap, reqs)]
    smoke.check(gates.mismatched_indices(got, direct) == []
                and gates.mismatched_indices(got, on_cpu) == [],
                f"{kind}: engine answers on the final snapshot == direct "
                f"answers on the card == the CPU engine's on the CPU replay")

    # the device time of one edge group (the min bucket, 64 point queries)
    # of this layout: the kMatrix's are plain gathers, the gMatrix's one
    # matrix_lookup_edges launch
    pairs = [(r.src, r.dst) for r in run["requests"] if r.family == "edge_freq"]
    qs, qd = (torch.as_tensor([p[i] for p in pairs[:64]], dtype=torch.int32,
                              device=tenant.device) for i in (0, 1))
    group_ms = device_ms(torch, lambda: mod.edge_freq(final.sketch, qs, qd))
    n_groups = sum(by_family.get(f, {"groups": 0})["groups"]
                   for f in ("edge_freq", "path_weight", "subgraph_weight"))
    edge_groups = {"groups": n_groups, "device_ms_per_group": group_ms,
                   "device_ms": None if group_ms is None else group_ms * n_groups}
    print(f"  {kind}: edge, path and subgraph groups: {json.dumps(edge_groups)}")

    # isolation: a held snapshot under 4 more batches and a publish
    held = final
    host = {k: v.copy() for k, v in interop.export_state(held.sketch)[0].items()}
    ask = reqs[:SERVE_HELD]
    before = [r.value for r in QueryEngine().execute(held, ask)]
    for i in range(4):
        tenant.buffer.ingest(stream.batch(i, device=tenant.device))
    new = tenant.publish()
    after = interop.export_state(held.sketch)[0]
    again = [r.value for r in QueryEngine().execute(held, ask)]
    smoke.check(new.epoch == held.epoch + 1
                and new.n_edges == held.n_edges + 4 * stream.batch_size
                and all((after[k] == host[k]).all() for k in host)
                and gates.mismatched_indices(before, again) == [],
                f"{kind}: held epoch {held.epoch} keeps its counters and its "
                f"answers to {len(ask)} requests after 4 more batches and "
                f"epoch {new.epoch}")
    ptrs = {t.untyped_storage().data_ptr() for t in _counter_tensors(held.sketch)}
    smoke.check(not ptrs & {t.untyped_storage().data_ptr()
                            for t in _counter_tensors(new.sketch)},
                f"{kind}: the new front shares no counter storage with the "
                "held one")
    print(f"  {kind}: gates {time.perf_counter() - t1:.1f}s")
    return {"summary": summary, "launches": launches, "run_s": run_s,
            "families": by_family, "edge_groups": edge_groups,
            "replays": {"card": card_replay, "CPU": cpu_replay}}


def _serve_profile(smoke, kind):
    """A shorter run of the same driver with ``torch.profiler`` over the
    load window: the device's busy and idle share, the top operations."""
    torch = smoke.torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import query_serve

    args = query_serve.parse_args([*SERVE_FLAGS, "--sketch", kind,
                                   "--n-requests", str(SERVE_PROFILED)])
    _, tenant = query_serve.open_tenant(args)
    engine, requests = query_serve.warm_engine(args, tenant)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        report, _ = query_serve.run_load(
            args, engine, lambda: tenant.snapshot, requests,
            between_batches=query_serve.live_ingest(args, tenant))
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    events = prof.key_averages()
    busy = sum(_self_device_us(e) for e in events) / 1e3
    row = {"requests": report.n_requests, "batches": report.n_batches,
           "ingested_batches": tenant.offset, "window_ms": window * 1e3,
           "device_busy_ms": busy, "idle_share": 1 - busy / (window * 1e3),
           "achieved_qps": report.achieved_qps, "p50_ms": report.p50_ms,
           "p99_ms": report.p99_ms}
    print(f"  {kind}, load window under the profiler: {json.dumps(row)}")
    for e in sorted(events, key=_self_device_us, reverse=True)[:8]:
        if _self_device_us(e) > 0:
            print(f"    device {_self_device_us(e) / 1e3:9.3f} ms  "
                  f"x{e.count:6d}  {e.key[:90]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms  "
              f"x{e.count:6d}  {e.key[:90]}")
    smoke.check(busy > 0, f"{kind}: the profiled load window ran on the device")
    return row


def phase_serving(smoke, card):
    """The online serving tier on the card: two tenants through the port's
    query_serve driver, gated against replays, the CPU and a held snapshot."""
    from repro_torch.launch import query_serve

    t0 = time.perf_counter()
    # warm-up on a small stream: first-call costs stay out of the timed runs
    query_serve._run(query_serve.parse_args(
        ["--scale", "0.03", "--n-requests", "200", "--device", "cuda"]))
    out = {kind: _serve_run(smoke, kind) for kind in SERVE_KINDS}
    for kind in SERVE_KINDS:
        out[kind]["profile"] = _serve_profile(smoke, kind)
    print(f"  {card}; phase H {time.perf_counter() - t0:.1f}s")
    return out


# ------------------------------------------------------------ phase I --

def _counting_ingests():
    """Wrap ``SnapshotBuffer.ingest`` to count its calls (every thread) and
    note when the last one returned; returns the box and the function that
    restores the method."""
    import threading

    from repro_torch.serving.snapshot import SnapshotBuffer

    box, lock, orig = {"n": 0, "last": None}, threading.Lock(), \
        SnapshotBuffer.ingest

    def counted(self, batch, count=None):
        out = orig(self, batch, count)
        with lock:
            box["n"] += 1
            box["last"] = time.perf_counter()
        return out

    SnapshotBuffer.ingest = counted

    def restore():
        SnapshotBuffer.ingest = orig

    return box, restore


class _TimedEngine:
    """The engine as the load generator sees it, each served batch's host
    time noted (start, end, requests)."""

    def __init__(self, engine, log: list):
        self._engine, self._log = engine, log

    def execute(self, snapshot, batch):
        t = time.perf_counter()
        out = self._engine.execute(snapshot, batch)
        self._log.append((t, time.perf_counter(), len(batch)))
        return out

    def __getattr__(self, name):
        return getattr(self._engine, name)


def _timeline():
    """Note the served batches (through ``query_serve.run_load``) and when
    each stream pump finished; returns the box and the restore function."""
    from repro_torch.launch import query_serve
    from repro_torch.runtime.supervisor import StreamPump

    box = {"batches": [], "pumps_done": []}
    orig_load, orig_pump = query_serve.run_load, StreamPump.run

    def run_load(args, engine, *rest, **kw):
        return orig_load(args, _TimedEngine(engine, box["batches"]), *rest,
                         **kw)

    def pump_run(self):
        try:
            orig_pump(self)
        finally:
            box["pumps_done"].append(time.perf_counter())

    query_serve.run_load, StreamPump.run = run_load, pump_run

    def restore():
        query_serve.run_load, StreamPump.run = orig_load, orig_pump

    return box, restore


def _latency_split(batches, qps, ingest_done, pumps_done) -> dict:
    """Each request's latency from the served batches (arrival i / qps from
    the first batch's start, the load generator's clock to a few µs), split
    at the last buffer ingest: the requests that arrived while the stream
    was still being ingested, and those after; and p99 per arrival window."""
    import numpy as np

    t0 = batches[0][0]
    ends = np.repeat([b[1] for b in batches], [b[2] for b in batches])
    arrival = np.arange(ends.size) / qps
    lat = (ends - t0 - arrival) * 1e3
    cut = ingest_done - t0

    def pcts(x):
        return ({"n": int(x.size), "p50_ms": float(np.percentile(x, 50)),
                 "p99_ms": float(np.percentile(x, 99))} if x.size
                else {"n": 0})

    host = np.array([b[1] - b[0] for b in batches]) * 1e3
    bins = (arrival // LATENCY_BIN_S).astype(int)
    return {
        "served_batches": len(batches),
        "requests_per_batch": float(ends.size / len(batches)),
        "host_ms_per_batch": {"mean": float(host.mean()),
                              "p50": float(np.percentile(host, 50)),
                              "max": float(host.max())},
        "host_ms_per_request": float(host.sum() / ends.size),
        "ingest_done_s": cut,
        "pumps_done_s": (max(pumps_done) - t0) if pumps_done else None,
        "arrived_while_ingesting": pcts(lat[arrival < cut]),
        "arrived_after": pcts(lat[arrival >= cut]),
        "p99_ms_by_window": [float(np.percentile(lat[bins == b], 99))
                             for b in range(bins.max() + 1)],
        "p99_ms_recomputed": float(np.percentile(lat, 99)),
    }


def _bg_run(smoke, label, flags):
    """One query_serve run in a background mode on the card: its launches
    counted from zero, its buffer ingests counted, its served batches and
    engine groups timed on the host, its line printed."""
    torch = smoke.torch
    from repro_torch.launch import query_serve
    from repro_torch.obs import get_hub, reset_hub

    args = query_serve.parse_args([*BG_FLAGS, *flags])
    ingests, restore = _counting_ingests()
    timeline, restore_timeline = _timeline()
    reset_hub()  # the engine's per-family group counts and times
    reset_launches()
    t0 = time.perf_counter()
    try:
        run = query_serve._run(args)
        torch.cuda.synchronize()
    finally:
        restore()
        restore_timeline()
    launches = read_launches()
    by_family = {labels["family"]: {"groups": hs["count"], "ms": hs["sum"] * 1e3}
                 for name, labels, hs in get_hub().state()["hists"]
                 if name == "repro_engine_group_seconds"}
    summary = run["summary"]
    epochs = summary.get("final_epochs", summary.get("final_epoch"))
    stats = run["engine"].stats
    misses = (stats.get("sharded_closure_misses", 0)
              + stats["closure_misses"])
    hits = stats.get("sharded_closure_hits", 0) + stats["closure_hits"]
    print(f"  {label}: achieved_qps={summary['achieved_qps']} offered="
          f"{summary['offered_qps']} p50_ms={summary['p50_ms']} p99_ms="
          f"{summary['p99_ms']} ingest_edges_per_s="
          f"{summary['ingest_edges_per_s']} publishes="
          f"{summary.get('publishes', '-')} epochs={epochs} closure "
          f"hits={hits} misses={misses} buffer_ingests={ingests['n']} "
          f"launches={json.dumps(launches)} "
          f"({time.perf_counter() - t0:.1f}s run)")
    print(f"  {label}: engine groups by family over the run, warm-up ladder "
          f"included (host clock per group, read-back included; sharded: "
          f"one group per shard): {json.dumps(dict(sorted(by_family.items())))}")
    split = _latency_split(timeline["batches"], args.qps, ingests["last"],
                           timeline["pumps_done"])
    print(f"  {label}: served batches and latency against the ingest "
          f"(seconds from the first served batch): {json.dumps(split)}")
    kind = args.sketch
    smoke.check(abs(split["p99_ms_recomputed"] - summary["p99_ms"]) < 1.0,
                f"{label}: p99 recomputed from the served batches "
                f"{split['p99_ms_recomputed']:.3f} ms == the summary's "
                f"{summary['p99_ms']} (within 1 ms)")
    smoke.check(launches["matrix_ingest_edges"] == ingests["n"] > 0,
                f"{label}: matrix_ingest_edges launches == buffer ingests "
                f"({ingests['n']})")
    smoke.check(launches["reach_closure"] == misses > 0,
                f"{label}: reach_closure launches == closure misses "
                f"({misses})")
    smoke.check(launches["reach_step"] == launches["matrix_ingest"]
                == launches["matrix_lookup"] == launches["embedding_bag"]
                == 0, f"{label}: no reach_step, no rectangle entry point, "
                "no embedding_bag")
    lookups = launches["matrix_lookup_edges"]
    smoke.check(lookups >= 1 if kind == "gmatrix" else lookups == 0,
                f"{label}: matrix_lookup_edges launches {lookups} "
                f"({'>= 1' if kind == 'gmatrix' else '0: gathers'})")
    smoke.check(summary["total_edges"] == STREAM_EDGES,
                f"{label}: total_edges {summary['total_edges']} == "
                f"{STREAM_EDGES}")
    return {**run, "launches": launches, "ingests": ingests["n"],
            "misses": misses, "families": by_family, "timeline": split}


def _same_counters(a, b) -> bool:
    """Counters (pools and conn, or the table) and layout equal; the
    overflow tally is left out: coalesced and shard dispatches have other
    batch sizes than a replay's."""
    from repro_torch import interop
    from repro_torch.serving import gates

    return (gates.layout_counters_equal(a, b)
            and interop.export_state(a)[1] == interop.export_state(b)[1])


def _bg_gates(smoke, label, run, replays):
    from repro_torch.serving import QueryEngine, gates
    from repro_torch.serving import engine as eng

    summary, final = run["summary"], run["tenant"].snapshot
    smoke.check(summary["unaccounted_edges"] == summary["dropped_edges"] == 0
                and summary["worker_state"] == "stopped",
                f"{label}: unaccounted_edges 0, dropped_edges 0, worker "
                f"{summary['worker_state']}")
    for where, replay in replays.items():
        smoke.check(_same_counters(final.sketch, replay),
                    f"{label}: final front == phase H's replay on the "
                    f"{where}")
    reqs = run["requests"][:SERVE_CHECKED]
    got = [r.value for r in QueryEngine().execute(final, reqs)]
    smoke.check(gates.mismatched_indices(got, eng.direct_answers(final, reqs))
                == [], f"{label}: engine answers to {len(reqs)} requests on "
                "the final snapshot == direct answers on the card")


def _cpu_shard_snapshot(sharded):
    """The sharded tenant's shard views replayed on the CPU through the
    plain versions, as one ShardedSnapshot."""
    from repro_torch import interop
    from repro_torch.serving import ShardedSnapshot, gates
    from repro_torch.serving.snapshot import Snapshot

    parts = []
    for shard in sharded.shards:
        sk = shard.snapshot.sketch
        template = interop.import_state(
            *interop.export_state(shard.mod.empty_like(sk)), device="cpu")
        replay = gates.replay_sketch(shard.mod, template, shard.stream,
                                     shard.stream.num_batches)
        parts.append(Snapshot(shard.snapshot.tenant_id + "/cpu",
                              shard.snapshot.epoch, replay,
                              shard.snapshot.kind, shard.snapshot.n_edges))
    return ShardedSnapshot(sharded.key.tenant_id + "/cpu", sharded.plan,
                           tuple(parts))


def _sharded_gates(smoke, label, run, replays):
    from repro_torch.serving import (QueryEngine, ShardedQueryEngine, gates,
                                     sharded_direct_answers)

    summary, st = run["summary"], run["tenant"]
    smoke.check(summary["conservation_ok"]
                and sum(summary["per_shard_published"]) == STREAM_EDGES
                and summary["dropped_edges"] == 0,
                f"{label}: conservation_ok, per_shard_published "
                f"{summary['per_shard_published']} sums to {STREAM_EDGES}")
    merged = st.merged_snapshot()
    for where, replay in replays.items():
        smoke.check(_same_counters(merged.sketch, replay),
                    f"{label}: merged_snapshot() == phase H's replay on the "
                    f"{where}")
    snap, reqs = st.snapshot, run["requests"][:SERVE_CHECKED]
    got = [r.value for r in ShardedQueryEngine(QueryEngine()).execute(
        snap, reqs)]
    on_cpu = [r.value for r in ShardedQueryEngine(QueryEngine()).execute(
        _cpu_shard_snapshot(st), reqs)]
    smoke.check(gates.mismatched_indices(
        got, sharded_direct_answers(snap, reqs)) == []
        and gates.mismatched_indices(got, on_cpu) == [],
        f"{label}: ShardedQueryEngine answers to {len(reqs)} requests == "
        "sharded_direct_answers on the card == the CPU engine on a CPU "
        "replay of the shard views")


def _sharded_resume(smoke, replays):
    """Crash and resume, sharded: the kMatrix shards taken to different
    offsets from pre-filled queues, stopped crash-like, restored into a new
    registry from their checkpoints and drained."""
    torch = smoke.torch
    from repro_torch.runtime import QueueItem, Runtime
    from repro_torch.serving import (SketchRegistry, attach_shards,
                                     read_shard_manifest, sharded_conservation)

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_shards_")
    try:
        reset_launches()
        reg = SketchRegistry(depth=5, scale=1.0, device="cuda")
        st = reg.open_sharded("cit-HepPh", "kmatrix", 256, n_shards=4)
        rt = Runtime(queue_capacity=64, publish_policy="every:4",
                     checkpoint_dir=ckpt, checkpoint_every=RESUME_EVERY)
        handles = attach_shards(rt, st)
        rt.start(pumps=False)
        for h, n in zip(handles, RESUME_OFFSETS):
            for i in range(n):
                h.queue.put(QueueItem.from_arrays(
                    i, *h.tenant.stream.batch_numpy(i)), timeout=60)
        deadline = time.monotonic() + 300
        while not all(h.worker.metrics.checkpoints >= n // RESUME_EVERY
                      and h.worker.metrics.ingested_batches >= n
                      for h, n in zip(handles, RESUME_OFFSETS)):
            if time.monotonic() > deadline:
                raise TimeoutError("shards did not reach their offsets")
            time.sleep(0.01)
        rt.stop(drain=False, timeout=60)
        crashed = [s.offset for s in st.shards]
        manifest = read_shard_manifest(ckpt)

        reg_b = SketchRegistry(depth=5, scale=1.0, device="cuda")
        st_b = reg_b.open_sharded("cit-HepPh", "kmatrix", 256,
                                  n_shards=manifest["n_shards"],
                                  shard_seed=manifest["shard_seed"])
        rt_b = Runtime(queue_capacity=64, publish_policy="every:4",
                       checkpoint_dir=ckpt)
        handles_b = attach_shards(rt_b, st_b, restore=True)
        restored = [s.offset for s in st_b.shards]
        rt_b.start()
        rt_b.join_pumps(300)
        rt_b.stop(drain=True, timeout=300)
        torch.cuda.synchronize()
        launches = read_launches()
        cons = sharded_conservation(handles_b, st_b.stream.spec.n_edges)
        print(f"  resume: crashed at offsets {crashed}, restored at "
              f"{restored}; {json.dumps(cons)}; launches "
              f"{json.dumps(launches)}")
        smoke.check(crashed == restored == list(RESUME_OFFSETS),
                    f"resume: each shard restored at the offset it crashed "
                    f"at ({list(RESUME_OFFSETS)})")
        smoke.check(cons["conservation_ok"]
                    and cons["published_edges"] == STREAM_EDGES,
                    "resume: conservation over the restored shards")
        merged = st_b.merged_snapshot()
        for where, replay in replays.items():
            smoke.check(_same_counters(merged.sketch, replay),
                        f"resume: merged front == phase H's replay on the "
                        f"{where}")
        other = SketchRegistry(depth=5, scale=1.0, device="cuda").open_sharded(
            "cit-HepPh", "kmatrix", 256, n_shards=4, shard_seed=1)
        try:
            attach_shards(Runtime(checkpoint_dir=ckpt), other, restore=True)
            refused = ""
        except ValueError as exc:
            refused = str(exc)
        smoke.check("manifest" in refused,
                    "resume: the manifest refuses --shard-seed 1 "
                    f"({refused[:60]!r})")
        return launches
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def _drain_rates(smoke):
    """``measure_sharded_ingest`` DRAIN_REPEATS times at each K, each on a
    fresh sharded tenant: every drain's rate and worker dispatches (buffer
    ingests less the warm-up's), then the spread at each K."""
    from repro_torch.serving import SketchRegistry, measure_sharded_ingest
    from repro_torch.serving import sharding

    rows, warm = [], sharding.warm_ingest_shapes

    def warm_counted(tenant):
        box["warm"] = warm(tenant)
        return box["warm"]

    for k in DRAIN_SHARDS:
        rates = []
        for rep in range(DRAIN_REPEATS):
            st = SketchRegistry(depth=5, scale=1.0, device="cuda").open_sharded(
                "cit-HepPh", "kmatrix", 256, n_shards=k)
            box, restore = _counting_ingests()
            sharding.warm_ingest_shapes = warm_counted
            try:
                out = measure_sharded_ingest(st)
            finally:
                restore()
                sharding.warm_ingest_shapes = warm
            dispatches = box["n"] - box["warm"]
            print(f"  drain K={k} #{rep}: {out['edges_per_s']} edges/s over "
                  f"{out['wall_s']} s, {dispatches} worker dispatches, "
                  f"conserved={out['conserved']}")
            smoke.check(out["conserved"] and out["queued_edges"] == STREAM_EDGES,
                        f"drain K={k} #{rep}: every queued edge published")
            rates.append(out["edges_per_s"])
            rows.append({**out, "dispatches": dispatches})
        print(f"  drain K={k} over {DRAIN_REPEATS} drains: edges/s min "
              f"{min(rates)} median {statistics.median(rates)} max "
              f"{max(rates)}")
    return rows


def _sharded_profile(smoke):
    """A 600-request window of the sharded kMatrix run under
    ``torch.profiler`` (the worker threads' kernels included): the device's
    busy and idle share and the top operations."""
    torch = smoke.torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import query_serve

    box, orig = {}, query_serve.run_load

    def profiled(*args, **kwargs):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            box["window"] = time.perf_counter() - t0
        box["prof"], box["report"] = prof, out[0]
        return out

    query_serve.run_load = profiled
    try:
        query_serve._run(query_serve.parse_args(
            [*BG_FLAGS, "--sketch", "kmatrix", "--shards", "4",
             "--n-requests", str(SERVE_PROFILED)]))
    finally:
        query_serve.run_load = orig
    events = box["prof"].key_averages()
    busy = sum(_self_device_us(e) for e in events) / 1e3
    report, window = box["report"], box["window"]
    row = {"requests": report.n_requests, "batches": report.n_batches,
           "window_ms": window * 1e3, "device_busy_ms": busy,
           "idle_share": 1 - busy / (window * 1e3),
           "achieved_qps": report.achieved_qps, "p50_ms": report.p50_ms,
           "p99_ms": report.p99_ms}
    print(f"  sharded kmatrix, load window under the profiler: "
          f"{json.dumps(row)}")
    for e in sorted(events, key=_self_device_us, reverse=True)[:8]:
        if _self_device_us(e) > 0:
            print(f"    device {_self_device_us(e) / 1e3:9.3f} ms  "
                  f"x{e.count:6d}  {e.key[:90]}")
    for e in sorted(events, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        print(f"    host   {e.self_cpu_time_total / 1e3:9.3f} ms  "
              f"x{e.count:6d}  {e.key[:90]}")
    smoke.check(busy > 0, "sharded kmatrix: the profiled window ran on the "
                "device")
    return row


def phase_background(smoke, card, serve):
    """Background and sharded serving on the card, gated against phase H's
    replays of the full stream (after a full drain every mode's final front
    must equal them)."""
    t0 = time.perf_counter()
    out, launches = {}, {}
    for kind in SERVE_KINDS:
        replays = serve[kind]["replays"]
        run = _bg_run(smoke, f"background {kind}", ["--sketch", kind])
        _bg_gates(smoke, f"background {kind}", run, replays)
        launches[f"background {kind}"] = run["launches"]
        out[f"background {kind}"] = run["summary"]
        if kind == "kmatrix":
            dedup = _bg_run(smoke, "background kmatrix dedup",
                            ["--sketch", kind, "--ingest-dedup"])
            _bg_gates(smoke, "background kmatrix dedup", dedup, replays)
            smoke.check(_same_counters(dedup["tenant"].snapshot.sketch,
                                       run["tenant"].snapshot.sketch),
                        "background kmatrix: --ingest-dedup pools and conn "
                        "== the run without it")
            launches["background kmatrix dedup"] = dedup["launches"]
            out["background kmatrix dedup"] = dedup["summary"]
    for kind in SERVE_KINDS:
        label = f"sharded {kind}"
        run = _bg_run(smoke, label, ["--sketch", kind, "--shards", "4"])
        _sharded_gates(smoke, label, run, serve[kind]["replays"])
        launches[label] = run["launches"]
        out[label] = run["summary"]
    launches["sharded kmatrix resume"] = _sharded_resume(
        smoke, serve["kmatrix"]["replays"])
    out["drain"] = _drain_rates(smoke)
    out["profile"] = _sharded_profile(smoke)
    print(f"  {card}; phase I {time.perf_counter() - t0:.1f}s")
    return {"runs": out, "launches": launches}


def _bench_ingest(smoke, pool, hi, hj, wt, label):
    torch = smoke.torch
    from repro_torch.kernels import matrix_ingest, matrix_ingest_plain

    d, p, w, _ = pool.shape
    out_k = matrix_ingest(pool.clone(), hi, hj, wt)
    out_p = matrix_ingest_plain(pool.clone(), hi, hj, wt)
    torch.cuda.synchronize()
    err = int((out_k.long() - out_p.long()).abs().max())
    smoke.check(torch.equal(out_k, out_p), f"matrix_ingest {label} bit-equal")
    rows = torch.arange(d, device="cuda").view(d, 1, 1).expand_as(hi)
    parts = torch.arange(p, device="cuda").view(1, p, 1).expand_as(hi)
    hil, hjl = hi.long(), hj.long()
    vals = wt[None].expand_as(hi)
    acc_k, acc_p, acc_l = pool.clone(), pool.clone(), pool.clone()
    ms = time_ms(torch, lambda: matrix_ingest(acc_k, hi, hj, wt))
    plain_ms = time_ms(torch, lambda: matrix_ingest_plain(acc_p, hi, hj, wt))
    library_ms = time_ms(torch, lambda: acc_l.index_put_(
        (rows, parts, hil, hjl), vals, accumulate=True))
    dev = {"device_ms": device_ms(torch, lambda: matrix_ingest(acc_k, hi, hj, wt)),
           "plain_device_ms": device_ms(
               torch, lambda: matrix_ingest_plain(acc_p, hi, hj, wt)),
           "library_device_ms": device_ms(torch, lambda: acc_l.index_put_(
               (rows, parts, hil, hjl), vals, accumulate=True))}
    live = int((wt != 0).sum())
    # bytes this call's data needs: wt once, hi/hj of the live slots, and a
    # read and a write of each pool cell they add to (the pool is updated
    # in place, so untouched cells need not move)
    ok = (wt != 0)[None] & (hi >= 0) & (hi < w) & (hj >= 0) & (hj < w)
    cells = ((rows * p + parts) * w + hil) * w + hjl
    touched = int(torch.unique(cells[ok]).numel())
    nbytes = wt.numel() * 4 + 2 * d * live * 4 + 2 * touched * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    row = {"shape": f"pool{list(pool.shape)} hi{list(hi.shape)}",
           "live_slots": live, "cells_touched": touched,
           "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, **dev}
    print(f"  matrix_ingest {label}: {json.dumps(row)}")
    return row


def _reach_bound(nbytes: float, flops: float) -> dict:
    """B2's bound: bytes over the memory rate against operations over the
    rate of the arithmetic it runs (bf16 on the tensor cores), with the
    float32 figure beside it."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_fp32_ms": max(bytes_ms, flops / FP32_FLOPS * 1e3)}


def _bench_reach(smoke, reach, label):
    torch = smoke.torch
    from repro_torch.kernels import reach_step, reach_step_plain

    d, w, _ = reach.shape
    out_k, out_p = reach_step(reach), reach_step_plain(reach)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    smoke.check(torch.equal(out_k, out_p), f"reach_step {label} bit-equal")
    # bf16 holds 0/1 exactly and the clamp makes any rounding of the sum
    # irrelevant: the honest yardstick for a tensor-core kernel
    half = reach.bfloat16()
    smoke.check(torch.equal(torch.clamp(torch.bmm(half, half), max=1).float(),
                            out_p), f"reach_step {label}: bf16 bmm exact too")
    ms = time_ms(torch, lambda: reach_step(reach))
    plain_ms = time_ms(torch, lambda: reach_step_plain(reach))
    library_ms = time_ms(torch, lambda: torch.bmm(reach, reach))
    dev = {"device_ms": device_ms(torch, lambda: reach_step(reach)),
           "plain_device_ms": device_ms(torch, lambda: reach_step_plain(reach)),
           "library_device_ms": device_ms(torch, lambda: torch.bmm(reach, reach)),
           "library_bf16_ms": time_ms(torch, lambda: torch.bmm(half, half)),
           "library_bf16_device_ms": device_ms(
               torch, lambda: torch.bmm(half, half))}
    row = {"shape": f"reach{list(reach.shape)}", "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           **_reach_bound(2 * reach.numel() * 4, 2 * d * w ** 3), **dev}
    print(f"  reach_step {label}: {json.dumps(row)}")
    return row


def _squarings_taken(torch, table, n_steps: int) -> list:
    """Per layer, the squarings the early-stopping closure runs: up to and
    including the first that leaves the layer unchanged, at most n_steps."""
    from repro_torch.kernels.reach_closure import closure_start, reach_step_plain

    reach = closure_start(table)
    taken = torch.zeros(table.shape[0], dtype=torch.int64, device=table.device)
    active = torch.ones_like(taken, dtype=torch.bool)
    for _ in range(n_steps):
        nxt = reach_step_plain(reach)
        taken += active
        active &= (nxt != reach).flatten(1).any(1)
        reach = nxt
    return taken.tolist()


def _bench_closure(smoke, table, n_steps, label):
    torch = smoke.torch
    from repro_torch.kernels import reach_closure, reach_closure_plain
    from repro_torch.kernels.reach_closure import closure_start

    d, w, _ = table.shape
    out_k = reach_closure(table, n_steps)
    out_p = reach_closure_plain(table, n_steps)
    torch.cuda.synchronize()
    err = int((out_k.int() - out_p.int()).abs().max())
    smoke.check(torch.equal(out_k, out_p), f"reach_closure {label} bit-equal")
    taken = _squarings_taken(torch, table, n_steps)
    start = closure_start(table)
    half = start.bfloat16()

    def cascade(x):
        """The library yardstick: n_steps torch.bmm calls (no clamp)."""
        for _ in range(n_steps):
            y = torch.bmm(x, x)
        return y

    ms = time_ms(torch, lambda: reach_closure(table, n_steps))
    plain_ms = time_ms(torch, lambda: reach_closure_plain(table, n_steps))
    library_ms = time_ms(torch, lambda: cascade(start))
    dev = {"device_ms": device_ms(torch, lambda: reach_closure(table, n_steps)),
           "plain_device_ms": device_ms(
               torch, lambda: reach_closure_plain(table, n_steps)),
           "library_device_ms": device_ms(torch, lambda: cascade(start)),
           "library_bf16_ms": time_ms(torch, lambda: cascade(half)),
           "library_bf16_device_ms": device_ms(torch, lambda: cascade(half))}
    # the counters read once and the closure written once (one byte each);
    # the squarings this data needs
    row = {"shape": f"table{list(table.shape)} n_steps={n_steps}",
           "squarings_taken": taken, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           **_reach_bound(table.numel() * 4 + out_k.numel(),
                          sum(taken) * 2 * w ** 3), **dev}
    print(f"  reach_closure {label}: {json.dumps(row)}")
    return row


def _bench_lookup(smoke, pool, hi, hj, label):
    torch = smoke.torch
    from repro_torch.kernels import matrix_lookup, matrix_lookup_plain

    d, p, w, _ = pool.shape
    c = hi.shape[2]
    out_k = matrix_lookup(pool, hi, hj)
    out_p = matrix_lookup_plain(pool, hi, hj)
    torch.cuda.synchronize()
    err = int((out_k.long() - out_p.long()).abs().max())
    smoke.check(torch.equal(out_k, out_p), f"matrix_lookup {label} bit-equal")
    ms = time_ms(torch, lambda: matrix_lookup(pool, hi, hj))
    plain_ms = time_ms(torch, lambda: matrix_lookup_plain(pool, hi, hj))
    dev = {"device_ms": device_ms(torch, lambda: matrix_lookup(pool, hi, hj)),
           "plain_device_ms": device_ms(
               torch, lambda: matrix_lookup_plain(pool, hi, hj)),
           "library_device_ms": None}
    # bytes this call's data needs: hi and hj once, out once, and each pool
    # cell the queries address once
    rows = torch.arange(d, device="cuda").view(d, 1, 1)
    parts = torch.arange(p, device="cuda").view(1, p, 1)
    cells = ((rows * p + parts) * w + hi.long()) * w + hj.long()
    gathered = int(torch.unique(cells).numel())
    nbytes = 2 * hi.numel() * 4 + p * c * 4 + gathered * 4
    row = {"shape": f"pool{list(pool.shape)} hi{list(hi.shape)}",
           "cells_gathered": gathered, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", **dev}
    print(f"  matrix_lookup {label}: {json.dumps(row)}")
    return row


def _bench_bag(smoke, table, idx, weights, label):
    torch = smoke.torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag, embedding_bag_plain

    b, f = idx.shape
    d = table.shape[1]
    out_k = embedding_bag(table, idx, weights)
    out_p = embedding_bag_plain(table, idx, weights)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max()) if out_k.numel() else 0.0
    smoke.check(torch.equal(out_k, out_p), f"embedding_bag {label} bit-equal")
    ms = time_ms(torch, lambda: embedding_bag(table, idx, weights))
    plain_ms = time_ms(torch, lambda: embedding_bag_plain(table, idx, weights))

    def library():
        return F.embedding_bag(idx, table, mode="sum",
                               per_sample_weights=weights)

    library_ms = time_ms(torch, library)
    dev = {"device_ms": device_ms(torch, lambda: embedding_bag(table, idx, weights)),
           "plain_device_ms": device_ms(
               torch, lambda: embedding_bag_plain(table, idx, weights)),
           "library_device_ms": device_ms(torch, library)}
    # bytes this call's data needs: idx (and weights) once, out once, and
    # each distinct row it gathers once; beside them the 32-byte sectors
    # those rows span, which is what the card moves for them
    rows = torch.unique(idx).long()
    first = rows * d * 4 // 32
    span = (rows * d * 4 + d * 4 - 1) // 32 - first + 1
    steps = torch.arange(int(span.max()), device="cuda")
    cover = first[:, None] + steps[None, :]
    sectors = int(torch.unique(cover[steps[None, :] < span[:, None]]).numel())
    fixed = idx.numel() * 4 * (1 if weights is None else 2) + b * d * 4
    nbytes = fixed + rows.numel() * d * 4
    row = {"shape": f"table{list(table.shape)} idx{list(idx.shape)}"
                    f"{'' if weights is None else ' weighted'}",
           "rows_gathered": rows.numel(), "sectors_gathered": sectors,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "sector_bound_ms": (fixed + sectors * 32) / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", **dev}
    print(f"  embedding_bag {label}: {json.dumps(row)}")
    return row


def _route_reads(torch, keys, v) -> tuple[int, int]:
    """Distinct key and part entries that ``sketch::route`` reads for the
    ids ``v``: the keys its left binary searches probe (and the final
    compare), the parts of the keys found."""
    n = keys.shape[0]
    if n == 0 or v.numel() == 0:
        return 0, 0
    lo = torch.zeros(v.shape, dtype=torch.int64, device=v.device)
    hi = torch.full_like(lo, n)
    probed = []
    while bool((lo < hi).any()):
        active = lo < hi
        mid = (lo + hi) >> 1
        probed.append(mid[active])
        less = active & (keys[mid.clamp(max=n - 1)] < v)
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    at = lo.clamp(max=n - 1)
    probed.append(at[lo < n])
    found = (lo < n) & (keys[at] == v)
    return (int(torch.unique(torch.cat(probed)).numel()),
            int(torch.unique(at[found]).numel()))


def _edge_updates(torch, sk, batch):
    """The counter updates one edge-ingest launch makes: per counter
    tensor, its flat cell indices (int64[d, n]) and the weights added
    there, as the kernel addresses them."""
    from repro_torch.common.hashing import fastrange, mix

    d = sk.depth
    layer = torch.arange(d, device=batch.src.device)[:, None]
    hs, ht = (mix(sk.hashes.a, sk.hashes.b, x) for x in (batch.src, batch.dst))
    w = batch.weight
    if not hasattr(sk, "pools"):  # P = 1: every nonzero weight
        e = (w != 0).nonzero().squeeze(1)
        cells = (layer * sk.w + fastrange(hs[:, e], sk.w)) * sk.w \
            + fastrange(ht[:, e], sk.w)
        return [(sk.table, cells, w[e].expand(d, -1))]
    p = sk.route.lookup(batch.src).long()
    cls, row = sk.part_class[p], sk.part_index[p].long()
    out = []
    for c, pool in enumerate(sk.pools):
        e = ((w > 0) & (cls == c)).nonzero().squeeze(1)
        n_c, w_c = pool.shape[1], pool.shape[-1]
        cells = ((layer * n_c + row[e]) * w_c + fastrange(hs[:, e], w_c)) \
            * w_c + fastrange(ht[:, e], w_c)
        out.append((pool, cells, w[e].expand(d, -1)))
    if sk.conn_w > 0:
        e = (w != 0).nonzero().squeeze(1)
        cw = sk.conn_w
        cells = (layer * cw + fastrange(hs[:, e], cw)) * cw \
            + fastrange(ht[:, e], cw)
        out.append((sk.conn, cells, w[e].expand(d, -1)))
    return out


def _bench_ingest_edges(smoke, sk, batch, label, capacity=None):
    """``matrix_ingest_edges`` on one batch into a fresh copy of ``sk``'s
    layout (routed for the kMatrix, P = 1 for TCM / gMatrix) against its
    plain version: every leaf (pools, conn, overflow) bit-equal."""
    torch = smoke.torch
    import importlib

    from repro_torch import interop
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.core import matrix_sketch as ms
    from repro_torch.kernels import matrix_ingest_edges, matrix_ingest_edges_plain

    routed = hasattr(sk, "pools")
    empty = kma.empty_like if routed else ms.empty_like
    if routed and capacity is None:
        capacity = kma.dispatch_capacity(sk, batch.size)

    def args(s):
        if not routed:
            return ((s.table.unsqueeze(1),), s.hashes.a, s.hashes.b, batch.src,
                    batch.dst, batch.weight), {}
        return ((s.pools, s.hashes.a, s.hashes.b, batch.src, batch.dst,
                 batch.weight),
                dict(route=s.route, part_class=s.part_class,
                     part_index=s.part_index, conn=s.conn,
                     overflow=s.overflow, capacity=capacity))

    out_k, out_p = empty(sk), empty(sk)
    a, kw = args(out_k)
    matrix_ingest_edges(*a, **kw)
    a, kw = args(out_p)
    matrix_ingest_edges_plain(*a, **kw)
    torch.cuda.synchronize()
    lk, lp = interop.export_state(out_k)[0], interop.export_state(out_p)[0]
    err = max(int(abs(lk[k].astype("int64") - lp[k].astype("int64")).max())
              if lk[k].size else 0 for k in lk)
    smoke.check(err == 0 and sorted(lk) == sorted(lp),
                f"matrix_ingest_edges {label} bit-equal (pools, conn, overflow)")
    acc_k, acc_p = empty(sk), empty(sk)
    ka, kkw = args(acc_k)
    pa, pkw = args(acc_p)
    updates = _edge_updates(torch, sk, batch)
    # the library yardstick: one accumulating index_put_ of every update
    # into one flat buffer of all the counters (the hashing, routing and
    # tally it leaves out are most of the function)
    sizes = [t.numel() for t, _, _ in updates]
    base = [sum(sizes[:i]) for i in range(len(sizes))]
    flat = torch.zeros(sum(sizes), dtype=torch.int32, device="cuda")
    idx = torch.cat([(c + o).reshape(-1) for (_, c, _), o in zip(updates, base)])
    vals = torch.cat([v.reshape(-1) for _, _, v in updates])

    def kernel():
        matrix_ingest_edges(*ka, **kkw)

    def plain():
        matrix_ingest_edges_plain(*pa, **pkw)

    def library():
        flat.index_put_((idx,), vals, accumulate=True)

    ms_, plain_ms, library_ms = (time_ms(torch, f) for f in (kernel, plain, library))
    dev = {"device_ms": device_ms(torch, kernel),
           "plain_device_ms": device_ms(torch, plain),
           "library_device_ms": device_ms(torch, library)}
    if routed and label.endswith("batch 0"):
        # the launch plan's measurement: layers a thread adds
        mod = importlib.import_module("repro_torch.kernels.matrix_ingest")
        keep = mod.LAYERS_PER_THREAD
        try:
            by_layers = {}
            for n in sorted({1, 2, sk.depth}):
                mod.LAYERS_PER_THREAD = n
                by_layers[n] = device_ms(torch, kernel)
        finally:
            mod.LAYERS_PER_THREAD = keep
        dev["device_ms_by_layers_per_thread"] = by_layers
    # bytes this call's data needs: src, dst and weight once, the hash
    # parameters, the route keys and parts the searches read, each used
    # partition's class and row, one 32-byte sector per updated counter
    # sector (a read-modify-write in L2)
    b, d = batch.size, sk.depth
    nbytes = 12 * b + 16 * d
    if routed:
        live = batch.src[batch.weight > 0]
        keys_read, parts_read = _route_reads(torch, sk.route.keys, live)
        used = int(torch.unique(sk.route.lookup(live)).numel())
        nbytes += 4 * (keys_read + parts_read) + 8 * used
    sectors = sum(int(torch.unique(c // 8).numel()) for _, c, _ in updates)
    nbytes += 32 * sectors
    row = {"shape": f"B={b} d={d} " + (
               " ".join(f"pool{list(p.shape)}" for p in sk.pools)
               + f" conn{list(sk.conn.shape)} capacity={capacity}"
               if routed else f"table{list(sk.table.shape)}"),
           "updates": int(vals.numel()), "sectors_updated": sectors,
           "overflow": int(out_k.overflow) if routed else None,
           "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library_call": "index_put_(accumulate=True) on precomputed flat "
                           "cells: the scatter only",
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", **dev}
    print(f"  matrix_ingest_edges {label}: {json.dumps(row)}")
    return row


def _bench_lookup_edges(smoke, table, a, b, src, dst, label):
    torch = smoke.torch
    from repro_torch.common.hashing import fastrange, mix
    from repro_torch.kernels import matrix_lookup_edges, matrix_lookup_edges_plain

    d, w, _ = table.shape
    out_k = matrix_lookup_edges(table, a, b, src, dst)
    out_p = matrix_lookup_edges_plain(table, a, b, src, dst)
    torch.cuda.synchronize()
    err = int((out_k.long() - out_p.long()).abs().max()) if out_k.numel() else 0
    smoke.check(torch.equal(out_k, out_p), f"matrix_lookup_edges {label} bit-equal")
    cells = (fastrange(mix(a, b, src), w).long() * w
             + fastrange(mix(a, b, dst), w))  # int64[d, n], within each layer
    flat = table.view(d, -1)

    def library():
        """The yardstick: gather + amin on precomputed cells (no hashing)."""
        return torch.gather(flat, 1, cells).amin(0)

    smoke.check(torch.equal(library(), out_p),
                f"matrix_lookup_edges {label}: gather + amin agrees")
    ms_ = time_ms(torch, lambda: matrix_lookup_edges(table, a, b, src, dst))
    plain_ms = time_ms(torch, lambda: matrix_lookup_edges_plain(table, a, b, src, dst))
    library_ms = time_ms(torch, library)
    dev = {"device_ms": device_ms(
               torch, lambda: matrix_lookup_edges(table, a, b, src, dst)),
           "plain_device_ms": device_ms(
               torch, lambda: matrix_lookup_edges_plain(table, a, b, src, dst)),
           "library_device_ms": device_ms(torch, library)}
    # bytes this call's data needs: src and dst once, out once, the hash
    # parameters, and each 32-byte sector of the table the queries address
    layer = torch.arange(d, device="cuda")[:, None]
    sectors = int(torch.unique((layer * w * w + cells) // 8).numel())
    nbytes = 12 * src.numel() + 16 * d + 32 * sectors
    row = {"shape": f"table{list(table.shape)} n={src.numel()}",
           "sectors_gathered": sectors, "max_abs_err": err, "ms": ms_,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_call": "torch.gather + amin on precomputed cells: the "
                           "lookup without its hashing",
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes", **dev}
    print(f"  matrix_lookup_edges {label}: {json.dumps(row)}")
    return row


def _random_ints(torch, gen, hi, shape):
    return torch.randint(0, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def _summary(name, source, replaces, launches, main, rows):
    """One kernel's entry of the kernels line: ``main``'s numbers (a row, or
    a dict summed over rows), its launches per path, and every shape.
    ``kernel_ms`` repeats ``ms`` under the name earlier lines used."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "exact": all(r["max_abs_err"] == 0 for r in rows),
            **{k: main[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "device_ms", "plain_device_ms", "library_device_ms")},
            **{k: main[k] for k in ("bound_fp32_ms", "library_bf16_ms",
                                    "library_bf16_device_ms") if k in main},
            "kernel_ms": main["ms"],
            "shapes": [{k: r[k] for k in ("label", "shape", "ms", "device_ms",
                                          "plain_ms", "bound_ms")}
                       for r in rows]}


def phase_kernels(smoke, sl, cmp, reach, fm, serve, bg):
    torch = smoke.torch
    import numpy as np

    from repro_torch.core import EdgeBatch
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.core import matrix_sketch as ms
    from repro_torch.core import queries as q
    from repro_torch.kernels import ops, reach_step_plain
    from repro_torch.kernels.reach_closure import CLOSURE_MAX_W, closure_start
    from repro_torch.streams import sample_stream

    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 bmm yardstick
    gen = torch.Generator(device="cuda").manual_seed(0)
    sk, stream = sl["run"]["sketch"], sl["run"]["stream"]
    gm = cmp["runs"]["gmatrix"]["sketch"]
    batch = EdgeBatch.from_numpy(*stream.batch_numpy(0), device="cuda")

    def labelled(row, label):
        row["label"] = label
        return row

    # matrix_ingest_edges: batch 0 of the main path into the kMatrix and
    # the gMatrix, the same batch at a forced capacity (a nonzero tally),
    # and with turnstile weights, and with weights whose cells pass 2^24
    b = batch.size
    rng = np.random.default_rng(3)
    turnstile = batch.replace(weight=torch.as_tensor(
        rng.integers(-2, 4, b).astype(np.int32), device="cuda"))
    heavy = batch.replace(weight=torch.as_tensor(
        rng.integers(1, 1 << 22, b).astype(np.int32), device="cuda"))
    edge_rows = [labelled(_bench_ingest_edges(smoke, *args), args[2])
                 for args in ((sk, batch, "kmatrix batch 0"),
                              (sk, batch, "kmatrix batch 0 capacity 128", 128),
                              (sk, turnstile, "kmatrix turnstile batch"),
                              (sk, heavy, "kmatrix cells above 2^24"),
                              (gm, batch, "gmatrix P=1 batch 0"),
                              (gm, turnstile, "gmatrix P=1 turnstile batch"),
                              (gm, heavy, "gmatrix P=1 cells above 2^24"))]
    smoke.check(edge_rows[1]["overflow"] > 0 and edge_rows[0]["overflow"] == 0,
                "the forced capacity's tally is nonzero, the default's zero")

    # matrix_ingest (rectangles): those the TPU's dispatch builds from the
    # kMatrix batch 0, and the gMatrix batch's node_cells at P = 1
    rects = ops.dispatch_rectangles(sk, batch, kma.dispatch_capacity(sk, b)).rects
    smoke.check(all(r is not None for r in rects),
                "one rectangle set per class (every class holds a partition)")
    kmat = [labelled(_bench_ingest(smoke, torch.zeros_like(pool), *r,
                                   f"kmatrix class {i}"), f"kmatrix class {i}")
            for i, (pool, r) in enumerate(zip(sk.pools, rects))]
    d = gm.depth
    cells = [ms.node_cells(gm, x).view(d, 1, b) for x in (batch.src, batch.dst)]
    smoke.check(tuple(gm.table.shape) == (7, 136, 136), "gmatrix table [7, 136, 136]")
    p1 = labelled(_bench_ingest(smoke, torch.zeros_like(gm.table).unsqueeze(1),
                                *cells, batch.weight.view(1, b), "gmatrix P=1"),
                  "gmatrix P=1")
    d, p, w, c = 7, 64, 128, 8192
    wt = torch.zeros((p, c), dtype=torch.int32, device="cuda")
    wt[:, : c // p] = 1  # one batch of 8192 edges over 64 partitions
    wide = labelled(_bench_ingest(
        smoke, torch.zeros((d, p, w, w), dtype=torch.int32, device="cuda"),
        _random_ints(torch, gen, w, (d, p, c)),
        _random_ints(torch, gen, w, (d, p, c)), wt, "wide"), "wide")

    # matrix_lookup_edges: gMatrix's evaluation queries, then a wide table
    qs, qd = (torch.as_tensor(x, device="cuda")
              for x in sample_stream(stream, 10_000, seed=99)[:2])
    look_edges = [labelled(_bench_lookup_edges(
        smoke, gm.table, gm.hashes.a, gm.hashes.b, qs, qd, "gmatrix queries"),
        "gmatrix queries")]
    look_edges.append(labelled(_bench_lookup_edges(
        smoke, _random_ints(torch, gen, 1 << 20, (7, 2048, 2048)), gm.hashes.a,
        gm.hashes.b, _random_ints(torch, gen, 1 << 30, (1_000_000,)),
        _random_ints(torch, gen, 1 << 30, (1_000_000,)), "wide"), "wide"))

    # matrix_lookup (given cells): the same queries' node_cells, a wide shape
    cells = [ms.node_cells(gm, x).view(gm.depth, 1, -1) for x in (qs, qd)]
    look = [labelled(_bench_lookup(smoke, gm.table.unsqueeze(1), *cells,
                                   "gmatrix queries"), "gmatrix queries")]
    pool = _random_ints(torch, gen, 1 << 20, (d, p, w, w))
    look.append(labelled(_bench_lookup(
        smoke, pool, _random_ints(torch, gen, w, (d, p, c)),
        _random_ints(torch, gen, w, (d, p, c)), "wide"), "wide"))

    # reach_closure: the kMatrix and gMatrix closures of phase D;
    # reach_step: every squaring of the kMatrix closure, the gMatrix
    # table's first, the 2 MB table's first (the path that launches it),
    # then a wide one
    close_rows, reach_rows = [], []
    for label, layers in (("kmatrix conn", q.closure_layers(sk)),
                          ("gmatrix table", q.closure_layers(gm)),
                          ("gmatrix 2MB table", q.closure_layers(reach["wide"]))):
        n = layers.shape[-1]
        if n <= CLOSURE_MAX_W:
            close_rows.append(labelled(_bench_closure(
                smoke, layers, q._closure_steps(n, None), label), label))
        r = closure_start(layers)
        steps = q._closure_steps(n, None) if label == "kmatrix conn" else 1
        for step in range(1, steps + 1):
            reach_rows.append(labelled(_bench_reach(
                smoke, r, f"{label} step {step}"), f"{label} step {step}"))
            r = reach_step_plain(r)
    wide_r = (torch.rand((7, 1024, 1024), generator=gen, device="cuda")
              < 0.002).float()
    reach_rows.append(labelled(_bench_reach(
        smoke, torch.clamp(wide_r + torch.eye(1024, device="cuda"), max=1.0),
        "wide"), "wide"))

    # embedding_bag: every bag of phase G's cells, as the FM called them
    bag_rows = {}
    for cell, calls in fm["bags"].items():
        names = ("emb", "emb_sq", "lin")
        for i, (table, idx, weights, _) in enumerate(calls):
            part = ("query " if cell == "retrieval_cand" and i < 3 else
                    "candidates " if cell == "retrieval_cand" else "")
            label = f"{cell} {part}{names[i % 3]}"
            bag_rows[label] = labelled(_bench_bag(smoke, table, idx, weights,
                                                  label), label)

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
            "plain_device_ms", "library_device_ms")

    def summed(rows):
        """One step's numbers: its launches summed."""
        out = {k: (None if any(r[k] is None for r in rows)
                   else sum(r[k] for r in rows)) for k in keys}
        out["bound_by"] = "bytes"
        return out

    # one batch of the kMatrix path: its launches summed over the classes
    batch_sum = summed(kmat)
    # one serve_p99 forward: its three bags
    p99 = summed([r for k, r in bag_rows.items() if k.startswith("serve_p99")])
    served = {**{f"serve {k}": v["launches"] for k, v in serve.items()},
              **bg["launches"]}
    by_path = {"kmatrix": sl["launches"],
               **{k: v for k, v in cmp["launches"].items()},
               "fm": fm["launches"], **served}
    return [
        _summary("matrix_ingest", "src/repro_torch/kernels/csrc/matrix_ingest.cu",
                 "src/repro/kernels/matrix_ingest.py:56",
                 {k: v["matrix_ingest"] for k, v in by_path.items()},
                 batch_sum, kmat + [p1, wide]),
        _summary("matrix_ingest_edges",
                 "src/repro_torch/kernels/csrc/matrix_ingest.cu",
                 "src/repro/kernels/matrix_ingest.py:56",
                 {k: v["matrix_ingest_edges"] for k, v in by_path.items()},
                 edge_rows[0], edge_rows),
        _summary("matrix_lookup", "src/repro_torch/kernels/csrc/matrix_lookup.cu",
                 "src/repro/kernels/matrix_lookup.py:43",
                 {k: v["matrix_lookup"] for k, v in by_path.items()},
                 look[0], look),
        _summary("matrix_lookup_edges",
                 "src/repro_torch/kernels/csrc/matrix_lookup.cu",
                 "src/repro/kernels/matrix_lookup.py:43",
                 {k: v["matrix_lookup_edges"] for k, v in by_path.items()},
                 look_edges[0], look_edges),
        _summary("reach_step", "src/repro_torch/kernels/csrc/reach_closure.cu",
                 "src/repro/kernels/reach_closure.py:39",
                 {**{f"{k} reachability": v["reach_step"]
                     for k, v in reach["launches"].items()},
                  "fm": fm["launches"]["reach_step"],
                  **{k: v["reach_step"] for k, v in served.items()}},
                 next(r for r in reach_rows if r["label"].startswith("gmatrix 2MB")),
                 reach_rows),
        _summary("reach_closure", "src/repro_torch/kernels/csrc/reach_closure.cu",
                 "src/repro/kernels/reach_closure.py:39",
                 {**{f"{k} reachability": v["reach_closure"]
                     for k, v in reach["launches"].items()},
                  "fm": fm["launches"]["reach_closure"],
                  **{k: v["reach_closure"] for k, v in served.items()}},
                 close_rows[0], close_rows),
        _summary("embedding_bag", "src/repro_torch/kernels/csrc/embedding_bag.cu",
                 "src/repro/kernels/embedding_bag.py:38",
                 {k: v["embedding_bag"] for k, v in by_path.items()},
                 p99, list(bag_rows.values())),
    ]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("error: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"error: the port's package is missing: {exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smoke = Smoke(torch)
    t0 = time.perf_counter()
    card = smoke.phase("A. build kernels", phase_build, smoke)
    fm = smoke.phase("G. recsys serving", phase_fm, smoke, card) if card else None
    sl = smoke.phase("C. slice", phase_slice, smoke) if card else None
    cmp = (smoke.phase("F. the paper's comparison", phase_compare, smoke, sl)
           if sl else None)
    reach = (smoke.phase("D. reachability", phase_reach, smoke, sl, cmp)
             if cmp else None)
    if reach is not None:
        smoke.phase("E. where the ingest time goes", phase_profile, smoke, sl)
    serve = (smoke.phase("H. online serving", phase_serving, smoke, card)
             if card else None)
    bg = (smoke.phase("I. background and sharded serving", phase_background,
                      smoke, card, serve) if serve else None)
    kernels = (smoke.phase("B. kernels vs plain", phase_kernels, smoke, sl,
                           cmp, reach, fm, serve, bg)
               if reach is not None and fm is not None and serve is not None
               and bg is not None else None)
    print(f"total {time.perf_counter() - t0:.1f}s")
    if smoke.failures or not kernels:
        print("FAILED: " + "; ".join(smoke.failures or ["phase missing"]))
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
