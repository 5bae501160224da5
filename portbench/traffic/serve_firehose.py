"""``serve_firehose``: ``launch/query_serve.py``'s cooperative mode, one live
tenant serving open-loop queries while it absorbs the stream.

Set-up: one tenant opened through ``SketchRegistry`` (its own stream,
sample and plan from the seed), one pass of the stream's batches handed to
its ``SnapshotBuffer`` and published (epoch 1), the requests of the window
drawn from the seed, and the engine's bucket ladder walked with one
``batch_max`` set of them.  Window: a modified copy of the open loop of
``OpenLoopLoadGen.run`` (``src/repro_torch/serving/loadgen.py`` at commit
cbdfd1d8e666db7c6b1c59ee99c9e22d4d3a7c8d).  Requests arrive on a schedule
from the window's start; whenever some are due, up to ``batch_max`` of
them go to ``QueryEngine.execute`` against the current snapshot, and one
bulk batch is handed to the buffer after each served batch (the mode's
ingest between batches); where none is due, the loop hands the next batch
instead of sleeping.  The batches cycle through the stream's passes and the
buffer publishes every ``publish_every`` batches.  At ``seconds`` the
ingest stops; requests scheduled in the window and still waiting are
served, their latency counting the wait; the remaining delta is published.

A request's latency runs from its scheduled arrival to the engine's return
(its answers are on the host then); its lateness from the arrival to the
start of the ``execute`` that serves it.

The host-clock readings of the engine (each ``execute``'s time, the
engine's group histogram) are kept for the window's part before a traced
run's profiled slice too, so that the profiler's cost stays out of them.

Parameters: ``batch_edges``, ``publish_every``, ``batch_max``, ``qps``,
``mix``, ``zipf_a``, ``path_len``, ``subgraph_edges``, ``heavy_universe``,
``heavy_threshold``, ``trace_slice_s`` (the traced last stretch of the
window).
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np

from portbench import program
from portbench.harness import Run
from portbench.reference.check import (
    answer_mismatches,
    counter_mismatches,
    plan_mismatches,
)
from portbench.reference.counters import Layout, batch_counters
from portbench.reference.plan import make_plan
from portbench.trace import Spans, TraceSlice
from portbench.traffic.requests import arrival_times, synth_requests
from portbench.traffic.stream import stream_from_config


def requests_for(ctx, n: int, seed: int) -> list[tuple]:
    p = ctx.params
    n_nodes = int(ctx.config["stream"]["n_nodes"])
    return synth_requests(
        n, p["mix"], n_nodes=n_nodes, seed=seed, zipf_a=float(p["zipf_a"]),
        path_len=int(p["path_len"]), subgraph_edges=int(p["subgraph_edges"]),
        heavy_universe=min(n_nodes, int(p["heavy_universe"])),
        heavy_threshold=float(p["heavy_threshold"]))


def run(ctx) -> Run:
    import torch

    dev = ctx.device
    cuda = dev.type == "cuda"
    p = ctx.params
    batch_edges = int(p["batch_edges"])
    publish_every = int(p["publish_every"])
    batch_max = int(p["batch_max"])
    qps = float(p["qps"])
    stream = stream_from_config(ctx.config, batch_size=batch_edges,
                                seed=ctx.seed)
    batches = stream.edge_batches()
    tb = time.perf_counter()
    program.build_kernels(dev)
    build_s = time.perf_counter() - tb
    tenant = program.open_tenant(ctx.config, batch_edges, ctx.seed, dev)
    buffer = tenant.buffer
    if ctx.module is not None:
        buffer = program.snapshot_buffer(
            tenant.snapshot.sketch, ctx.module(tenant.mod, ctx),
            tenant.key.tenant_id, ctx.config["sketch"])
    spans = Spans()
    handed = [0]  # batches handed to the buffer, set-up's included
    publishes = []  # (seconds from the window's start, epoch, batches)
    slice_batches = []
    t0 = [0.0]

    def ingest_one(tracing: bool) -> None:
        i = handed[0] % len(batches)
        with spans("from_numpy"):
            eb = program.edge_batch(*batches[i], dev)
        with spans("ingest"):
            buffer.ingest(eb)
        handed[0] += 1
        if tracing:
            slice_batches.append(i)
        if handed[0] % publish_every == 0:
            with spans("publish"):
                snap = buffer.publish()
            publishes.append((time.perf_counter() - t0[0], snap.epoch,
                              handed[0], snap.n_edges))

    for _ in range(len(batches)):  # set-up: one pass, published
        ingest_one(False)
    if handed[0] % publish_every:
        buffer.publish()
    publishes.clear()
    start_epoch = buffer.epoch
    start_edges = buffer.snapshot.n_edges

    from repro_torch.serving import QueryEngine, warm_bucket_ladder
    engine = QueryEngine()
    arrivals = arrival_times(max(1, math.ceil(qps * ctx.seconds)), qps)
    arrivals = arrivals[arrivals < ctx.seconds]
    n = len(arrivals)
    reqs = requests_for(ctx, n, ctx.seed + 7)
    preqs = [program.to_request(r) for r in reqs]
    warm = [program.to_request(r)
            for r in requests_for(ctx, batch_max, ctx.seed + 99)]
    warm_bucket_ladder(engine, buffer.snapshot, warm)
    if cuda:
        torch.cuda.synchronize(dev)

    tr = TraceSlice(dev, spans) if ctx.trace else None
    if tr is not None:
        tr.warm()
    slice_s = float(p.get("trace_slice_s", 1.0))
    trace_on = max(0.0, ctx.seconds - slice_s)  # the window's last stretch
    done = np.full(n, np.nan)  # seconds from the window's start
    began = np.full(n, np.nan)
    records = []  # (epoch, lo, hi, values)
    slice_served = []  # (lo, hi, seconds) of each execute in the slice
    unprofiled_served = []  # the same in the window before the slice
    served = 0

    def serve(log: list | None) -> None:
        nonlocal served
        now = time.perf_counter() - t0[0]
        hi = served
        while hi < n and arrivals[hi] <= now and hi - served < batch_max:
            hi += 1
        snap = buffer.snapshot
        ts = time.perf_counter()
        with spans("execute"):
            results = engine.execute(snap, preqs[served:hi])
        te = time.perf_counter()
        began[served:hi] = ts - t0[0]
        done[served:hi] = te - t0[0]
        records.append((snap.epoch, served, hi,
                        [program.answer_value(r.value) for r in results]))
        if log is not None:
            log.append((served, hi, te - ts))
        served = hi

    out = Run(batches=batches, stream=stream, requests=reqs)
    gc.collect()
    gc.freeze()  # set-up's objects (the requests) are never traversed again
    groups0 = program.engine_group_states()
    t0[0] = time.perf_counter()
    out.setup_s = t0[0] - ctx.t_process
    while True:
        now = time.perf_counter() - t0[0]
        if now >= ctx.seconds:
            break
        if tr is not None and tr.t0 is None and now >= trace_on:
            out.unprofiled_groups = program.engine_group_states(since=groups0)
            tr.start()
        tracing = tr is not None and tr.t0 is not None and tr.t1 is None
        if served < n and arrivals[served] <= now:
            serve(slice_served if tracing else unprofiled_served)
        ingest_one(tracing)
    if tr is None or tr.t0 is None:
        out.unprofiled_groups = program.engine_group_states(since=groups0)
    window_publishes = list(publishes)
    gc.unfreeze()
    if tr is not None and tr.t0 is not None and tr.t1 is None:
        tr.stop()
    out.trace = tr if tr is not None and tr.t0 is not None else None
    while served < n:  # scheduled in the window, still waiting
        serve(None)
    final = buffer.publish()
    if cuda:
        torch.cuda.synchronize(dev)
    ctx.read_peak()

    published = [x for x in window_publishes if x[0] <= ctx.seconds]
    out.window_s = float(ctx.seconds)
    out.edges_done = (published[-1][3] - start_edges) if published else 0
    out.attempted = n
    out.failed = int(np.isnan(done).sum())
    out.latencies_s = done - arrivals
    out.slice_batches = slice_batches
    out.slice_served = slice_served
    out.unprofiled_served = unprofiled_served
    late = began - arrivals
    quarter = max(1, n // 4)
    second = arrivals.astype(int)
    by_second = [float(np.percentile(out.latencies_s[second == k], 95)) * 1e3
                 for k in range(int(ctx.seconds)) if (second == k).any()]
    pub_t = np.asarray([x[0] for x in published])
    pub_e = np.diff([start_edges] + [x[3] for x in published])
    ingest_by_second = [float(pub_e[(pub_t >= k) & (pub_t < k + 1)].sum()) / 1e6
                        for k in range(int(ctx.seconds))]
    out.info = {
        "passes": handed[0] // len(batches),
        "publishes": len(window_publishes),
        "queries_served_batches": len(records),
        "lateness_ms": {
            "p50": float(np.percentile(late, 50)) * 1e3,
            "p95": float(np.percentile(late, 95)) * 1e3,
            "max": float(late.max()) * 1e3,
            "first_quarter_mean": float(late[:quarter].mean()) * 1e3,
            "last_quarter_mean": float(late[-quarter:].mean()) * 1e3},
        "achieved_qps": n / float(done.max()) if n else 0.0,
        "p95_ms_by_second": by_second,
        "medges_per_s_by_second": ingest_by_second,
        "offered_qps": qps,
        "build_s": build_s,
    }
    out.program = {
        "plan": program.plan_of(final.sketch),
        "front": program.counters_of(final.sketch),
        "front_edges": int(final.n_edges),
        "handed": handed[0],
        "start_epoch": start_epoch,
        "publishes": [(e, b) for _, e, b, _ in window_publishes],
        "records": records,
    }
    return out


def check(ctx, run: Run) -> dict:
    """The final front (its plan, its counters against every handed
    batch, and every handed edge in its count) as one count of
    disagreements; every answer against the reference on the epoch it
    was answered on."""
    stream = run.stream
    plan = make_plan(ctx.config, (stream.batch_numpy(i)
                                  for i in range(stream.num_batches)),
                     ctx.seed)
    layout = Layout(plan)
    per_batch = [batch_counters(layout, *b) for b in run.batches]
    nb = len(per_batch)
    one_pass = sum(per_batch)

    def handed_counters(k: int):
        return (k // nb) * one_pass + sum(per_batch[:k % nb], 0 * one_pass)

    prog = run.program
    batches_at = {prog["start_epoch"]: nb}
    batches_at.update({e: b for e, b in prog["publishes"]})

    def counters_at(epoch: int):
        k = batches_at.get(int(epoch))
        return None if k is None else handed_counters(k)

    parts = plan_mismatches(plan, prog["plan"])
    parts["counters"] = counter_mismatches(
        layout, handed_counters(prog["handed"]), prog["front"])
    edges = sum(len(b[0]) for b in run.batches)
    handed_edges = (prog["handed"] // nb) * edges + sum(
        len(b[0]) for b in run.batches[:prog["handed"] % nb])
    parts["edges_not_in_front"] = abs(handed_edges - prog["front_edges"])
    records = [(e, run.requests[lo:hi], vals)
               for e, lo, hi, vals in prog["records"]]
    checked, bad, notes = answer_mismatches(layout, counters_at, records)
    run.plan, run.layout = plan, layout
    run.info["answers_checked"] = checked
    run.info["answer_notes"] = notes
    run.info["front_mismatches_by_part"] = {k: v for k, v in parts.items()
                                            if v}
    return {"front_mismatches": (sum(parts.values()), 0),
            "answer_mismatches": (bad, 0)}
