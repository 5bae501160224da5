#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits nonzero without the final ``ok`` line):

  A. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
     (all at once) and print the card's name and power limit.
  C. The main path: the paper pipeline on the full cit-HepPh stream (scale
     1.0: 421,578 edges in 52 batches of 8192), 512 KB budget, depth 7,
     banded partitioner, 10,000 evaluation queries, through the port's
     ``stream_ingest`` entry point on ``cuda`` with the width-class layout.
     Launch counts are zeroed just before and read just after: every batch
     must launch ``matrix_ingest`` once per non-empty width class.  The same
     stream is ingested again through the flat layout on the card and
     through the plain versions on the CPU (which the CPU tests hold against
     the JAX package): counters and ARE must be identical.
  D. Reachability: the closure of the ingested sketch's connectivity layers
     through ``reach_step`` (one launch per squaring), 10,000 sampled pairs
     answered and compared with the CPU plain closure.
  E. A profile of the main path's ingest loop: host time per batch for
     making, copying and issuing it, the device's busy and idle shares, and
     the top operations by device and host time.
  B. Each kernel against its plain version on the card, on the inputs the
     main path gives it plus one wide shape: bit-equal results, and times
     of the kernel, the plain version and one PyTorch library call computing
     the same function, beside the least time the card could take
     (``bound_ms``).  ``ms`` keys are CUDA-event times of back-to-back calls
     after warm-up (host launch overhead included); ``device_ms`` keys are
     the launched kernels' own time from ``torch.profiler``.

The last lines are one ``{"kernels": [...]}`` JSON object and then
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # float32 outside the tensor cores

SLICE_FLAGS = ["--dataset", "cit-HepPh", "--scale", "1.0", "--budget-kb", "512",
               "--depth", "7", "--batch-size", "8192", "--partitioner", "banded",
               "--eval-queries", "10000", "--sketch-backend", "width_class"]
REACH_PAIRS = 10_000


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


def device_ms(torch, fn, iters: int = 20):
    """Device time per call of ``fn()`` from ``torch.profiler``: the summed
    duration of the kernels it launched, over ``iters`` calls.  Unlike
    ``time_ms`` it excludes the host's launch overhead.  None when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(_self_device_us(e) for e in prof.key_averages())
    return total_us / iters / 1e3 if total_us > 0 else None


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
    from repro_torch import interop
    from repro_torch.core import EdgeBatch
    from repro_torch.core import kmatrix as km
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.core.metrics import exact_edge_frequencies, lookup_exact
    from repro_torch.kernels import matrix_ingest, reach_step
    from repro_torch.launch import stream_ingest
    from repro_torch.streams import sample_stream

    parser = stream_ingest.build_parser()
    # warm-up on a small stream: first-call costs stay out of the timed run
    stream_ingest.inline_main(parser.parse_args(
        ["--scale", "0.03", "--eval-queries", "100", "--device", "cuda"]))

    matrix_ingest.launches = reach_step.launches = 0
    run = stream_ingest.inline_main(
        parser.parse_args([*SLICE_FLAGS, "--device", "cuda"]))
    launches = {"matrix_ingest": matrix_ingest.launches,
                "reach_step": reach_step.launches}
    sk = run["sketch"]
    classes = sum(1 for n in sk.class_counts if n)
    print(f"  classes widths={sk.class_widths} counts={sk.class_counts} "
          f"conn_w={sk.conn_w} capacity="
          f"{kma.dispatch_capacity(sk, 8192)} overflow={int(sk.overflow)}")
    print(f"  launches on the main path: {launches}")
    smoke.check(type(sk).__name__ == "KMatrixAccel", "width-class sketch")
    smoke.check(run["batches"] == 52, f"52 batches (got {run['batches']})")
    smoke.check(launches["matrix_ingest"] == run["batches"] * classes,
                f"matrix_ingest launches == batches x classes "
                f"({run['batches']} x {classes})")
    smoke.check(launches["reach_step"] == 0, "no reach_step launch in ingest")
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
    gl, gs = interop.export_state(sk)
    cl, cs = interop.export_state(cpu["sketch"])
    same = gs == cs and sorted(gl) == sorted(cl) and all(
        (gl[k] == cl[k]).all() for k in gl)
    smoke.check(same, "cuda sketch == cpu plain sketch: pools, conn, "
                      "overflow, routes, hashes")
    smoke.check(cpu["ARE"] == run["ARE"],
                f"ARE cuda == cpu ({run['ARE']!r} vs {cpu['ARE']!r})")
    return {"run": run, "cpu": cpu, "launches": launches, "rate": rate}


def phase_reach(smoke, sl):
    torch = smoke.torch
    from repro_torch.core import queries as q
    from repro_torch.kernels import matrix_ingest, reach_step

    import numpy as np

    sk, sk_cpu = sl["run"]["sketch"], sl["cpu"]["sketch"]
    rng = np.random.default_rng(7)
    n = sl["run"]["stream"].spec.n_nodes
    qs = torch.as_tensor(rng.integers(0, n, REACH_PAIRS).astype("int32"))
    qd = torch.as_tensor(rng.integers(0, n, REACH_PAIRS).astype("int32"))

    matrix_ingest.launches = reach_step.launches = 0
    closure = q.build_closure(q.closure_layers(sk))
    answers = q.reachability_from_closure(
        closure, q.reach_cells(sk, qs.cuda()), q.reach_cells(sk, qd.cuda()))
    torch.cuda.synchronize()
    launches = reach_step.launches
    steps = q._closure_steps(sk.conn_w, None)
    print(f"  reach_step launches: {launches} (closure steps for "
          f"w={sk.conn_w}: {steps})")
    smoke.check(launches == steps, "reach_step launches == _closure_steps(conn_w)")

    ref_closure = q.build_closure(q.closure_layers(sk_cpu))
    ref = q.reachability_from_closure(
        ref_closure, q.reach_cells(sk_cpu, qs), q.reach_cells(sk_cpu, qd))
    smoke.check(torch.equal(closure.cpu(), ref_closure),
                "kernel closure == cpu plain closure")
    smoke.check(torch.equal(answers.cpu(), ref),
                f"{REACH_PAIRS} reachability answers equal "
                f"({int(ref.sum())} reachable)")
    plain = q.build_closure(q.closure_layers(sk), backend="plain")
    smoke.check(torch.equal(plain, closure), "plain closure on cuda == kernel")
    return launches


def phase_profile(smoke, sl):
    """Where one batch's time goes on the main path: host time of making
    the batch, of copying it to the card and of issuing the ingest, and
    the device time of what the ingest launched (torch.profiler)."""
    torch = smoke.torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import EdgeBatch
    from repro_torch.core import kmatrix_accel as kma

    stream = sl["run"]["stream"]
    sk = kma.empty_like(sl["run"]["sketch"])
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
            kma.ingest(sk, batch)
            t3 = time.perf_counter()
            t["make"] += t1 - t0
            t["copy"] += t2 - t1
            t["issue"] += t3 - t2
        torch.cuda.synchronize()
        wall = time.perf_counter() - wall0
    events = prof.key_averages()
    device_ms = sum(_self_device_us(e) for e in events) / 1e3
    per_batch = {k: v / n * 1e3 for k, v in t.items()}
    print(f"  per batch (ms, host clock, profiler on): {json.dumps(per_batch)}; "
          f"wall {wall / n * 1e3:.3f}")
    print(f"  device busy {device_ms / n:.4f} ms/batch = "
          f"{device_ms / (wall * 1e3):.3%} of wall (idle share "
          f"{1 - device_ms / (wall * 1e3):.3%})")
    top = sorted(events, key=_self_device_us, reverse=True)[:12]
    for e in top:
        if _self_device_us(e) > 0:
            print(f"    device {_self_device_us(e) / n:9.2f} us/batch  "
                  f"x{e.count / n:5.1f}  {e.key[:90]}")
    top = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    for e in top:
        print(f"    host   {e.self_cpu_time_total / n:9.2f} us/batch  "
              f"x{e.count / n:5.1f}  {e.key[:90]}")
    return per_batch


def _capture_ingest_calls(torch, sk, batch):
    """The (pool, hi, hj, wt) inputs the main path hands ``matrix_ingest``
    for one batch, captured from a real ingest into an empty copy."""
    from repro_torch.core import kmatrix_accel as kma
    from repro_torch.kernels import ops

    calls = []
    real = ops.matrix_ingest

    def record(pool, hi, hj, wt):
        calls.append((pool.clone(), hi.clone(), hj.clone(), wt.clone()))
        return real(pool, hi, hj, wt)

    ops.matrix_ingest = record
    try:
        kma.ingest(kma.empty_like(sk), batch)
    finally:
        ops.matrix_ingest = real
    torch.cuda.synchronize()
    return calls


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


def _bench_reach(smoke, reach, label):
    torch = smoke.torch
    from repro_torch.kernels import reach_step, reach_step_plain

    d, w, _ = reach.shape
    out_k, out_p = reach_step(reach), reach_step_plain(reach)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    smoke.check(torch.equal(out_k, out_p), f"reach_step {label} bit-equal")
    ms = time_ms(torch, lambda: reach_step(reach))
    plain_ms = time_ms(torch, lambda: reach_step_plain(reach))
    library_ms = time_ms(torch, lambda: torch.bmm(reach, reach))
    dev = {"device_ms": device_ms(torch, lambda: reach_step(reach)),
           "plain_device_ms": device_ms(torch, lambda: reach_step_plain(reach)),
           "library_device_ms": device_ms(torch, lambda: torch.bmm(reach, reach))}
    bytes_ms = 2 * reach.numel() * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * d * w ** 3 / FP32_FLOPS * 1e3
    row = {"shape": f"reach{list(reach.shape)}", "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           **dev}
    print(f"  reach_step {label}: {json.dumps(row)}")
    return row


def phase_kernels(smoke, sl, reach_launches):
    torch = smoke.torch
    from repro_torch.core import EdgeBatch
    from repro_torch.core import queries as q
    from repro_torch.kernels import reach_step_plain

    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 bmm yardstick
    sk, stream = sl["run"]["sketch"], sl["run"]["stream"]
    batch = EdgeBatch.from_numpy(*stream.batch_numpy(0), device="cuda")
    rows = [_bench_ingest(smoke, *call, f"main path class {i}")
            for i, call in enumerate(_capture_ingest_calls(torch, sk, batch))]
    smoke.check(len(rows) == sum(1 for n in sk.class_counts if n),
                "one captured launch per non-empty class")
    gen = torch.Generator(device="cuda").manual_seed(0)
    d, p, w, c = 7, 64, 128, 8192
    wt = torch.zeros((p, c), dtype=torch.int32, device="cuda")
    wt[:, : c // p] = 1  # one batch of 8192 edges over 64 partitions
    _bench_ingest(
        smoke, torch.zeros((d, p, w, w), dtype=torch.int32, device="cuda"),
        torch.randint(0, w, (d, p, c), generator=gen, device="cuda",
                      dtype=torch.int32),
        torch.randint(0, w, (d, p, c), generator=gen, device="cuda",
                      dtype=torch.int32), wt, "wide")

    # reach_step: every squaring of the main path's closure, then a wide one
    adj = (q.closure_layers(sk) > 0).float()
    reach = torch.clamp(adj + torch.eye(sk.conn_w, device="cuda"), max=1.0)
    main = _bench_reach(smoke, reach, "main path step 1")
    for step in range(2, q._closure_steps(sk.conn_w, None) + 1):
        reach = reach_step_plain(reach)
        _bench_reach(smoke, reach, f"main path step {step}")
    wide = (torch.rand((7, 1024, 1024), generator=gen, device="cuda")
            < 0.002).float()
    _bench_reach(smoke, torch.clamp(wide + torch.eye(1024, device="cuda"),
                                    max=1.0), "wide")

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
            "plain_device_ms", "library_device_ms")
    total = {k: (None if any(r[k] is None for r in rows)
                 else sum(r[k] for r in rows)) for k in keys}
    dev_keys = ("device_ms", "plain_device_ms", "library_device_ms")
    return [
        {"name": "matrix_ingest", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/matrix_ingest.cu",
         "replaces": "src/repro/kernels/matrix_ingest.py:56",
         "launches": sl["launches"]["matrix_ingest"],
         "max_abs_err": max(r["max_abs_err"] for r in rows),
         "exact": all(r["max_abs_err"] == 0 for r in rows),
         # one batch of the main path: its launches summed over the classes
         "ms": total["ms"], "kernel_ms": total["ms"],
         "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
         "bound_by": "bytes", "library_ms": total["library_ms"],
         **{k: total[k] for k in dev_keys}},
        {"name": "reach_step", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/reach_closure.cu",
         "replaces": "src/repro/kernels/reach_closure.py:39",
         "launches": reach_launches, "max_abs_err": main["max_abs_err"],
         "exact": main["max_abs_err"] == 0,
         "ms": main["ms"], "kernel_ms": main["ms"],
         "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
         "bound_by": main["bound_by"], "library_ms": main["library_ms"],
         **{k: main[k] for k in dev_keys}},
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
    sl = smoke.phase("C. slice", phase_slice, smoke) if card else None
    reach = smoke.phase("D. reachability", phase_reach, smoke, sl) if sl else None
    if reach is not None:
        smoke.phase("E. where the ingest time goes", phase_profile, smoke, sl)
    kernels = (smoke.phase("B. kernels vs plain", phase_kernels, smoke, sl, reach)
               if reach is not None else None)
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
