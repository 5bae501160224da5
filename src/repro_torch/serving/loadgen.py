"""Open-loop load generator for mixed-query serving benchmarks.

Open loop means arrivals are scheduled by a clock, not by completions: a
request that arrives while the engine is busy *waits*, and its measured
latency includes that queueing delay.  This is the honest way to measure a
service under a target offered load (closed-loop generators hide overload by
slowing down with the server).

The generator synthesizes a Zipf-skewed workload over the tenant's node
universe (matching the graph-stream setting: hot vertices are queried more),
batches whatever has arrived each time the engine frees up (up to
``batch_max``) and reports achieved QPS plus p50/p99/mean/max latency.
``synth_requests`` is numpy only and draws the same requests as the JAX
package's for the same seed.  The network client (``NetLoadGen``) is not
ported yet (ROADMAP item 12).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable

import numpy as np

from repro_torch.obs.hub import Histogram, hist_summary
from repro_torch.serving import engine as eng
from repro_torch.serving.snapshot import Snapshot


def _latency_summary_ms(hstate: dict) -> dict:
    """``hist_summary`` of a seconds-ladder state, rescaled to ms for the
    JSON report (counts stay counts; every value field becomes *_ms)."""
    s = hist_summary(hstate)
    return {k: (v if k == "count" else round(v * 1e3, 4))
            for k, v in s.items()}


@dataclasses.dataclass(frozen=True)
class WorkloadMix:
    """Relative weights of query families in the synthetic workload."""

    edge_freq: float = 0.55
    reach: float = 0.25
    node_out: float = 0.10
    path_weight: float = 0.05
    subgraph_weight: float = 0.03
    heavy_nodes: float = 0.02

    def normalized(self) -> dict[str, float]:
        pairs = dataclasses.asdict(self)
        total = sum(pairs.values())
        assert total > 0, "empty workload mix"
        return {k: v / total for k, v in pairs.items()}


def mix_for_sketch(kind: str) -> WorkloadMix:
    """Default workload for a sketch kind: Type I sketches (countmin,
    gsketch) cannot answer node/reach families, so their mix degrades to
    edge-level queries instead of erroring mid-benchmark."""
    if kind in ("countmin", "gsketch"):
        return WorkloadMix(edge_freq=0.8, reach=0.0, node_out=0.0,
                           path_weight=0.1, subgraph_weight=0.1,
                           heavy_nodes=0.0)
    return WorkloadMix()


def warm_bucket_ladder(engine, snapshot, requests, start: int = 16) -> None:
    """Walk the engine's power-of-two bucket ladder off the clock.

    Arrival batching produces batches of many sizes; walking doubling
    prefixes (plus one full-size batch) makes the measured run hit buckets
    that every family has already run (allocator pools, the closure of the
    current epoch)."""
    size = start
    while size < len(requests):
        engine.execute(snapshot, requests[:size])
        size *= 2
    engine.execute(snapshot, requests)


def synth_requests(n: int, mix: WorkloadMix, *, n_nodes: int, seed: int = 0,
                   zipf_a: float = 1.2, path_len: int = 4,
                   subgraph_edges: int = 3, heavy_universe: int | None = None,
                   heavy_threshold: float = 100.0) -> list[eng.Request]:
    """Draw ``n`` requests with Zipf-skewed endpoints over ``[0, n_nodes)``."""
    rng = np.random.default_rng(seed)
    norm = mix.normalized()
    fams = list(norm)
    choice = rng.choice(len(fams), size=n, p=[norm[f] for f in fams])

    def node() -> int:
        return int(min(rng.zipf(zipf_a) - 1, n_nodes - 1))

    reqs: list[eng.Request] = []
    for c in choice:
        fam = fams[c]
        if fam == "edge_freq":
            reqs.append(eng.edge_freq(node(), node()))
        elif fam == "reach":
            reqs.append(eng.reach(node(), node()))
        elif fam == "node_out":
            reqs.append(eng.node_out(node()))
        elif fam == "path_weight":
            reqs.append(eng.path_weight([node() for _ in range(path_len)]))
        elif fam == "subgraph_weight":
            reqs.append(eng.subgraph_weight(
                [(node(), node()) for _ in range(subgraph_edges)]))
        else:
            reqs.append(eng.heavy_nodes(heavy_universe or n_nodes,
                                        heavy_threshold))
    return reqs


@dataclasses.dataclass
class LoadReport:
    n_requests: int
    duration_s: float
    offered_qps: float
    achieved_qps: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    p999_ms: float
    mean_ms: float
    max_ms: float
    n_batches: int
    family_counts: dict[str, int]
    # summary of the mergeable log-bucket histogram the latencies were also
    # fed through (repro_torch.obs.hub ladder "latency"); p* here are bucket-
    # interpolated, the raw-array percentiles above stay exact
    latency_hist: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(_round_floats(dataclasses.asdict(self)))


def _round_floats(d):
    if isinstance(d, float):
        return round(d, 4)
    if isinstance(d, dict):
        return {k: _round_floats(v) for k, v in d.items()}
    return d


class OpenLoopLoadGen:
    """Drives a QueryEngine at a target offered QPS."""

    def __init__(self, *, target_qps: float = 2000.0,
                 batch_max: int = 1024) -> None:
        self.target_qps = target_qps
        self.batch_max = batch_max

    def run(self, engine: eng.QueryEngine,
            snapshot_fn: Callable[[], Snapshot],
            requests: list[eng.Request],
            between_batches: Callable[[], None] | None = None) -> LoadReport:
        """Serve ``requests`` open-loop; latency includes queueing delay.

        ``snapshot_fn`` is polled per batch so a concurrently-publishing
        tenant hands new epochs to the engine mid-run; ``between_batches``
        (e.g. an ingest step) runs after each served batch — engine time
        spent there shows up as queueing latency, exactly as a co-located
        ingest loop would in production.
        """
        n = len(requests)
        interval = 1.0 / self.target_qps
        arrivals = np.arange(n) * interval
        latencies = np.zeros(n)
        family_counts: dict[str, int] = {}
        for r in requests:
            family_counts[r.family] = family_counts.get(r.family, 0) + 1

        t0 = time.perf_counter()
        served = 0
        n_batches = 0
        while served < n:
            now = time.perf_counter() - t0
            if arrivals[served] > now:
                time.sleep(min(arrivals[served] - now, 0.05))
                continue
            hi = served
            while hi < n and arrivals[hi] <= now and hi - served < self.batch_max:
                hi += 1
            batch = requests[served:hi]
            engine.execute(snapshot_fn(), batch)
            done = time.perf_counter() - t0
            latencies[served:hi] = done - arrivals[served:hi]
            served = hi
            n_batches += 1
            if between_batches is not None:
                between_batches()
        duration = time.perf_counter() - t0

        # feed the same latencies (seconds) through a mergeable log-bucket
        # histogram so the report carries a state other runs can sum with
        hist = Histogram("loadgen_latency_seconds", {})
        hist.observe_many(latencies)
        hstate = hist.state()

        lat_ms = latencies * 1e3
        return LoadReport(
            n_requests=n,
            duration_s=duration,
            offered_qps=self.target_qps,
            achieved_qps=n / duration,
            p50_ms=float(np.percentile(lat_ms, 50)),
            p90_ms=float(np.percentile(lat_ms, 90)),
            p99_ms=float(np.percentile(lat_ms, 99)),
            p999_ms=float(np.percentile(lat_ms, 99.9)),
            mean_ms=float(lat_ms.mean()),
            max_ms=float(lat_ms.max()),
            n_batches=n_batches,
            family_counts=family_counts,
            latency_hist=_latency_summary_ms(hstate),
        )


# ------------------------------------------------------------ network mode --
