"""Serving tour: snapshot-isolated queries over a live-ingesting kMatrix.

    python -m repro_torch.examples.query_serving [--device cpu]

The JAX package's ``examples/query_serving.py`` on the port.  Opens two
tenants in a sketch registry (same dataset, different budgets),
interleaves ingest with a mixed query batch through the batched engine,
and demonstrates the three serving guarantees:

  1. snapshot isolation — a held snapshot answers identically even after
     more stream batches are ingested and published;
  2. exactness — engine answers == direct repro_torch.core.queries answers;
  3. closure caching — repeated reachability on one epoch hits the cached
     boolean-closure matrices instead of re-running the squarings.

The registry names the flat kMatrix layout (the JAX package's default off
the TPU; the port's own default is the width-class layout), so its lines
equal the JAX example's.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.stream_ingest import require_device
from repro_torch.serving import (
    QueryEngine,
    SketchRegistry,
    WorkloadMix,
    synth_requests,
)
from repro_torch.serving import engine as eng


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits if no card) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    registry = SketchRegistry(depth=5, scale=0.1, sketch_backend="flat",
                              device=device)
    small = registry.open("cit-HepPh", "kmatrix", 128, seed=0)
    large = registry.open("cit-HepPh", "kmatrix", 512, seed=0)
    print(f"registry: {len(registry)} tenants")

    # ingest a prefix of the stream and publish epoch 1 on both tenants
    registry.step_all(3)
    registry.publish_all()

    engine = QueryEngine()
    n_nodes = small.stream.spec.n_nodes
    requests = [
        eng.edge_freq(1, 2),
        eng.node_out(7),
        eng.reach(3, 40),
        eng.path_weight([1, 2, 3, 4]),
        eng.subgraph_weight([(1, 2), (2, 3)]),
        eng.heavy_nodes(n_nodes, threshold=200.0),
    ]

    for tenant in (small, large):
        res = engine.execute(tenant.snapshot, requests)
        printable = [
            (r.family, r.value if r.family != "heavy_nodes"
             else f"{len(r.value[0])} heavy ids") for r in res]
        print(f"{tenant.key.tenant_id} epoch {tenant.epoch}: {printable}")

    # --- 1. snapshot isolation -------------------------------------------
    held = small.snapshot
    before = [r.value for r in engine.execute(held, requests[:3])]
    small.step(2)           # keep ingesting...
    small.publish()         # ...and publish a NEW epoch
    after_held = [r.value for r in engine.execute(held, requests[:3])]
    after_new = [r.value for r in engine.execute(small.snapshot, requests[:3])]
    if before != after_held:
        raise SystemExit("held snapshot must not move")
    print(f"isolation: held epoch {held.epoch} answers stable "
          f"{before} vs new epoch {small.epoch} answers {after_new}")

    # --- 2. exactness vs direct module-level queries ----------------------
    direct = eng.direct_answers(small.snapshot, requests[:5])
    batched = [r.value for r in engine.execute(small.snapshot, requests[:5])]
    if batched != direct:
        raise SystemExit(f"engine answers {batched} != direct {direct}")
    print(f"exactness: engine == direct for {len(direct)} mixed queries")

    # --- 3. closure cache across a mixed workload ------------------------
    mix = WorkloadMix(edge_freq=0.3, reach=0.7, node_out=0.0,
                      path_weight=0.0, subgraph_weight=0.0, heavy_nodes=0.0)
    workload = synth_requests(400, mix, n_nodes=n_nodes, seed=3)
    engine.execute(small.snapshot, workload)
    engine.execute(small.snapshot, workload)
    s = engine.stats
    print(f"closure cache: {s['closure_hits']} hits / "
          f"{s['closure_misses']} misses across "
          f"{s['batches_planned']} planned batches")


if __name__ == "__main__":
    main()
