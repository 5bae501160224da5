"""Background ingest runtime tour: workers, backpressure, crash recovery.

    python -m repro_torch.examples.background_ingest [--device cpu]

The JAX package's ``examples/background_ingest.py`` on the port; walks the
``repro_torch.runtime`` layer end to end:

  1. concurrency — two tenants ingest their streams in background worker
     threads while the main thread fires queries the whole time; epochs
     advance under live query load, answers stay snapshot-consistent;
  2. lifecycle + metrics — live queue depth / edges-per-s / publish latency
     while running, then a graceful drain-and-stop whose conservation
     report accounts every offered edge (published + drops, zero silent);
  3. crash safety — a second run is killed mid-stream, restored from its
     last checkpoint into a fresh registry, resumed, and ends bit-identical
     to the never-crashed sketch (seekable streams + additive counters).

The registries name the flat kMatrix layout, as the JAX example builds.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import torch

from repro_torch.core import kmatrix
from repro_torch.launch.stream_ingest import require_device
from repro_torch.runtime import Runtime
from repro_torch.serving import QueryEngine, SketchRegistry
from repro_torch.serving import engine as eng


def wait_until(cond, timeout_s=60.0, poll_s=0.01):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() >= deadline:
            raise TimeoutError("timed out")
        time.sleep(poll_s)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"failed: {what}")


def registry(device) -> SketchRegistry:
    return SketchRegistry(depth=3, batch_size=2048, scale=0.05,
                          sketch_backend="flat", device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits if no card) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    # ---- 1 + 2: two tenants ingesting in the background under query load --
    reg = registry(device)
    t_small = reg.open("cit-HepPh", "kmatrix", 128, seed=0)
    t_large = reg.open("cit-HepPh", "kmatrix", 512, seed=0)

    runtime = Runtime(queue_capacity=8, backpressure="block",
                      publish_policy="every:2", reservoir_k=1024)
    for tenant in (t_small, t_large):
        runtime.attach(tenant, throttle_s=0.02)  # throttle: keep it watchable

    engine = QueryEngine(min_bucket=8)
    queries = [eng.edge_freq(1, 2), eng.node_out(7), eng.reach(3, 11)]
    engine.execute(t_small.snapshot, queries)  # warm up before the clock

    runtime.start()
    epochs_seen: list[int] = []
    while not runtime.join_pumps(timeout=0.05):
        res = engine.execute(t_small.snapshot, queries)
        check(len({r.epoch for r in res}) == 1, "one batch, one epoch")
        epochs_seen.append(res[0].epoch)
    m = runtime.metrics()[t_small.key.tenant_id]
    print(f"live metrics: depth={m['queue_depth']} "
          f"edges/s={m['edges_per_s_ewma']} epoch={m['epoch']} "
          f"publish_ms={m['last_publish_latency_ms']}")
    # HOW MANY distinct epochs the loop catches is scheduling-dependent;
    # what is guaranteed is that the ones it sees never regress
    check(epochs_seen == sorted(epochs_seen), "epochs never regress")
    print(f"queried across {len(set(epochs_seen))} live epoch(s): "
          f"{sorted(set(epochs_seen))}")

    report = runtime.stop(drain=True)
    check(t_small.epoch > 0, "background ingest published")
    for tid, r in report.items():
        print(f"{tid}: offered={r['offered_edges']} "
              f"published={r['published_edges']} dropped={r['dropped_edges']} "
              f"unaccounted={r['unaccounted_edges']}")
        check(r["unaccounted_edges"] == 0, "graceful drain lost no edge")
    sample = runtime.handles()[0].worker.reservoir.sample
    print(f"online reservoir sample: {len(sample[0])} edges maintained")

    # ---- 3: kill mid-stream, restore from checkpoint, resume --------------
    ckpt_dir = tempfile.mkdtemp(prefix="runtime_ckpt_")
    try:
        victim = registry(device).open("cit-HepPh", "kmatrix", 128, seed=7)
        rt_a = Runtime(queue_capacity=2, publish_policy="every:2",
                       checkpoint_dir=ckpt_dir, checkpoint_every=1,
                       poll_s=0.01)
        handle = rt_a.attach(victim, throttle_s=0.05)
        rt_a.start()
        wait_until(lambda: handle.worker.metrics.checkpoints >= 2)
        rt_a.kill()  # crash-like: queued + in-delta work is abandoned
        print(f"killed mid-stream at offset {victim.offset} "
              f"({handle.worker.metrics.checkpoints} checkpoints on disk)")

        resumed = registry(device).open("cit-HepPh", "kmatrix", 128, seed=7)
        rt_b = Runtime(queue_capacity=8, publish_policy="every:2",
                       checkpoint_dir=ckpt_dir)
        rt_b.attach(resumed, restore=True)
        print(f"restored: epoch={resumed.epoch} offset={resumed.offset}")
        rt_b.start()
        check(rt_b.join_pumps(120), "the resumed stream drained")
        rt_b.stop(drain=True)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # oracle: the same stream ingested once, no crash
    oracle = registry(device).open("cit-HepPh", "kmatrix", 128, seed=7)
    sk = kmatrix.empty_like(oracle.snapshot.sketch)
    for i in range(oracle.stream.num_batches):
        kmatrix.ingest(sk, oracle.stream.batch(i, device=device))
    got = resumed.snapshot.sketch
    check(torch.equal(got.pool, sk.pool) and torch.equal(got.conn, sk.conn),
          "crash -> restore -> resume equals a clean run")
    print("crash -> restore -> resume is bit-identical to a clean run ✓")


if __name__ == "__main__":
    main()
