"""``bulk_ingest``: the paper's build (Fig. 6), the loop of
``launch/stream_ingest.run_pipeline`` with its batches made before the
clock starts.

Set-up: the stream's batches on the host from the seed, the program's
sample of the stream and its planned sketch, one pass of ingest.  Window:
pass after pass, each summarizing the whole stream into a fresh sketch
(the module's ``empty_like`` of the planned one, so no counter can
overflow whatever the rate), the batches handed in order through
``EdgeBatch.from_numpy`` and the module's ``ingest``.  The window closes
after the pass that crosses ``seconds``, with a synchronisation: every
edge handed was ingested inside it.

Parameters (``traffic/<mix>.json`` and the cell): ``batch_edges``, and for
a traced run ``trace_slice_s`` (the traced last stretch of the window).
"""
from __future__ import annotations

import gc
import time

import numpy as np

from portbench import program
from portbench.harness import Run
from portbench.reference.check import counter_mismatches, plan_mismatches
from portbench.reference.counters import Layout, batch_counters
from portbench.reference.plan import make_plan
from portbench.trace import Spans, TraceSlice
from portbench.traffic.stream import stream_from_config


def run(ctx) -> Run:
    import torch

    dev = ctx.device
    cuda = dev.type == "cuda"
    stream = stream_from_config(ctx.config,
                                batch_size=int(ctx.params["batch_edges"]),
                                seed=ctx.seed)
    batches = stream.edge_batches()
    tb = time.perf_counter()
    program.build_kernels(dev)
    build_s = time.perf_counter() - tb
    planned, mod = program.planned_sketch(ctx.config, stream, ctx.seed, dev)
    if ctx.module is not None:
        mod = ctx.module(mod, ctx)
    spans = Spans()

    def one_pass():
        with spans("empty_like"):
            sk = mod.empty_like(planned)
        for src, dst, w in batches:
            with spans("from_numpy"):
                eb = program.edge_batch(src, dst, w, dev)
            with spans("ingest"):
                mod.ingest(sk, eb)
        return sk

    one_pass()  # warm-up: every shape of the window, off the clock
    if cuda:
        torch.cuda.synchronize(dev)

    tr = TraceSlice(dev, spans) if ctx.trace else None
    if tr is not None:
        tr.warm()
    slice_s = float(ctx.params.get("trace_slice_s", 1.0))
    trace_on = max(0.0, ctx.seconds - slice_s)  # the window's last stretch
    out = Run(batches=batches, stream=stream)
    gc.collect()
    gc.freeze()  # set-up's objects are never traversed inside the window
    t0 = time.perf_counter()
    out.setup_s = t0 - ctx.t_process
    passes = 0
    last = None
    ends = []  # each pass's end (host clock, seconds from the window's start)
    while True:
        now = time.perf_counter() - t0
        if now >= ctx.seconds and passes:
            break
        if tr is not None and tr.t0 is None and now >= trace_on:
            tr.start()
        last = one_pass()
        passes += 1
        ends.append(time.perf_counter() - t0)
        if tr is not None and tr.t0 is not None and tr.t1 is None:
            out.slice_batches.extend(range(len(batches)))
    if cuda:
        torch.cuda.synchronize(dev)
    out.window_s = time.perf_counter() - t0
    gc.unfreeze()
    if tr is not None and tr.t0 is not None and tr.t1 is None:
        tr.stop()
    out.trace = tr if tr is not None and tr.t0 is not None else None
    ctx.read_peak()

    n_edges = sum(len(b[0]) for b in batches)
    out.edges_done = passes * n_edges
    out.attempted = passes * len(batches)
    out.program = {"plan": program.plan_of(planned),
                   "counters": program.counters_of(last)}
    per_s = np.bincount(np.asarray(ends, int))[:int(ctx.seconds)]
    out.info = {"passes": passes, "edges_per_pass": n_edges,
                "build_s": build_s,
                "medges_per_s_by_second": (per_s * n_edges / 1e6).tolist()}
    return out


def check(ctx, run: Run) -> dict:
    """The sketch of the window's last pass against the reference's: its
    plan and its counters, as one count of disagreements."""
    stream = run.stream
    plan = make_plan(ctx.config, (stream.batch_numpy(i)
                                  for i in range(stream.num_batches)),
                     ctx.seed)
    layout = Layout(plan)
    expected = sum(batch_counters(layout, *b) for b in run.batches)
    parts = plan_mismatches(plan, run.program["plan"])
    parts["counters"] = counter_mismatches(layout, expected,
                                           run.program["counters"])
    run.plan, run.layout = plan, layout
    run.info["sketch_mismatches_by_part"] = {k: v for k, v in parts.items()
                                             if v}
    return {"sketch_mismatches": (sum(parts.values()), 0)}
