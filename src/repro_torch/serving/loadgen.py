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
package's for the same seed.  ``NetLoadGen`` drives the same open loop over
TCP connections against a ``QueryServer`` (``python -m
repro_torch.serving.loadgen --connect HOST:PORT``).
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable

import numpy as np

from repro_torch.obs.hub import Histogram, hist_summary, merge_hist_states
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


@dataclasses.dataclass
class NetLoadReport:
    """Open-loop report for a run against a network query server."""

    n_requests: int
    accepted: int
    shed: int
    shed_rate: float  # shed / offered — the accounted overload signal
    errors: int
    # transport casualties are NOT sheds: a connection that died (reset,
    # timeout) aborts its unsent/unanswered remainder, accounted here so a
    # client-side failure can't masquerade as server admission control
    aborted: int
    transport_error: str | None
    connections: int
    duration_s: float
    offered_qps: float
    achieved_qps: float  # accepted / duration
    p50_ms: float
    p90_ms: float
    p99_ms: float
    p999_ms: float
    mean_ms: float
    max_ms: float
    n_batches: int
    mean_retry_after_ms: float
    last_epoch: int | None  # freshest epoch stamped on any answer
    # per-connection log-bucket histograms merged parent-side — the same
    # exact-sum merge the obs tier uses across workers, so per-connection
    # latency distributions compose without shipping raw samples
    latency_hist: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(_round_floats(dataclasses.asdict(self)))


class NetLoadGen:
    """Multi-connection open-loop load against a TCP query server.

    One global arrival clock, ``connections`` concurrent client
    connections taking requests round-robin — so the *offered* load is
    connection-count-invariant and connection count only changes how much
    concurrency the server sees.  Latency (arrival→answer, queueing
    included) is measured for ACCEPTED requests; rejections count as shed.
    """

    def __init__(self, *, target_qps: float = 500.0, connections: int = 4,
                 batch_max: int = 64, tenant: str = "default",
                 auth_token: str | None = None) -> None:
        assert connections >= 1
        self.target_qps = target_qps
        self.connections = connections
        self.batch_max = batch_max
        self.tenant = tenant
        self.auth_token = auth_token

    def run(self, address: tuple[str, int],
            requests: list[eng.Request]) -> NetLoadReport:
        from repro_torch.net import wire
        from repro_torch.net.query_server import QueryClient

        n = len(requests)
        interval = 1.0 / self.target_qps
        arrivals = np.arange(n) * interval
        lat_ms = np.full(n, np.nan)
        accepted = np.zeros(n, dtype=bool)
        errored = np.zeros(n, dtype=bool)
        aborted = np.zeros(n, dtype=bool)
        retry_hints: list[float] = []
        transport_errors: list[str] = []
        batches = [0]
        last_epoch: list[int | None] = [None]
        lock = threading.Lock()
        t0 = [0.0]
        # one mergeable histogram per connection; merged after the join so
        # the report's distribution is the exact sum of per-connection ones
        conn_hists = [Histogram(f"conn{c}_latency_seconds", {})
                      for c in range(self.connections)]

        def connection_loop(conn_idx: int) -> None:
            mine = list(range(conn_idx, n, self.connections))
            hist = conn_hists[conn_idx]
            served = 0
            client = None
            try:
                client = QueryClient(address, tenant=self.tenant,
                                     auth_token=self.auth_token)
                while served < len(mine):
                    now = time.perf_counter() - t0[0]
                    first = arrivals[mine[served]]
                    if first > now:
                        time.sleep(min(first - now, 0.02))
                        continue
                    hi = served
                    while (hi < len(mine) and arrivals[mine[hi]] <= now
                           and hi - served < self.batch_max):
                        hi += 1
                    idx = mine[served:hi]
                    payload = client.call([requests[i] for i in idx])
                    done = time.perf_counter() - t0[0]
                    with lock:
                        batches[0] += 1
                        if payload["kind"] == "result":
                            accepted[idx] = True
                            lat_ms[idx] = (done - arrivals[idx]) * 1e3
                            hist.observe_many(done - arrivals[idx])
                            if payload["epoch"] is not None:
                                last_epoch[0] = max(
                                    last_epoch[0] or 0, payload["epoch"])
                        elif payload["kind"] == "reject":
                            retry_hints.append(payload["retry_after_ms"])
                        else:  # server-side error: accounted, not shed
                            errored[idx] = True
                    served = hi
            except (ConnectionError, TimeoutError, OSError,
                    wire.WireError) as exc:
                # the transport died, not the server's admission control:
                # the in-flight batch and the unsent remainder are aborted,
                # never folded into the shed count
                with lock:
                    transport_errors.append(repr(exc))
                    if mine[served:]:
                        aborted[mine[served:]] = True
            finally:
                if client is not None:
                    client.close()

        threads = [threading.Thread(target=connection_loop, args=(c,),
                                    daemon=True, name=f"loadgen-conn-{c}")
                   for c in range(self.connections)]
        t0[0] = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        duration = time.perf_counter() - t0[0]

        ok = lat_ms[accepted]
        n_acc = int(accepted.sum())
        n_err = int(errored.sum())
        n_abort = int(aborted.sum())
        shed = n - n_acc - n_err - n_abort
        merged = conn_hists[0].state()
        for h in conn_hists[1:]:
            merged = merge_hist_states(merged, h.state())
        return NetLoadReport(
            n_requests=n,
            accepted=n_acc,
            shed=shed,
            shed_rate=shed / n if n else 0.0,
            errors=n_err,
            aborted=n_abort,
            transport_error=transport_errors[0] if transport_errors else None,
            connections=self.connections,
            duration_s=duration,
            offered_qps=self.target_qps,
            achieved_qps=n_acc / duration if duration > 0 else 0.0,
            p50_ms=float(np.percentile(ok, 50)) if n_acc else float("nan"),
            p90_ms=float(np.percentile(ok, 90)) if n_acc else float("nan"),
            p99_ms=float(np.percentile(ok, 99)) if n_acc else float("nan"),
            p999_ms=(float(np.percentile(ok, 99.9))
                     if n_acc else float("nan")),
            mean_ms=float(ok.mean()) if n_acc else float("nan"),
            max_ms=float(ok.max()) if n_acc else float("nan"),
            n_batches=batches[0],
            mean_retry_after_ms=(float(np.mean(retry_hints))
                                 if retry_hints else 0.0),
            last_epoch=last_epoch[0],
            latency_hist=_latency_summary_ms(merged),
        )


def main(argv: list[str] | None = None) -> int:
    """CLI client: load a remote query server (a port one or a JAX one)."""
    import argparse

    from repro_torch.net import wire

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.loadgen",
        description="open-loop load generator for a query server")
    p.add_argument("--connect", required=True, metavar="HOST:PORT")
    p.add_argument("--qps", type=float, default=500.0)
    p.add_argument("--n-requests", type=int, default=2000)
    p.add_argument("--connections", type=int, default=4)
    p.add_argument("--batch-max", type=int, default=64)
    p.add_argument("--tenant", default="default")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--auth-token", default="",
                   help="shared token for a remote server "
                        "(default: $KMATRIX_NET_TOKEN)")
    args = p.parse_args(argv)

    from repro_torch.net.query_server import QueryClient

    address = wire.parse_hostport(args.connect)
    probe = QueryClient(address, tenant=args.tenant,
                        auth_token=args.auth_token or None)
    info = probe.info()
    probe.close()
    n_nodes = int(info.get("n_nodes", 0)) or 1024
    mix = mix_for_sketch(str(info.get("kind", "kmatrix")))
    requests = synth_requests(args.n_requests, mix, n_nodes=n_nodes,
                              seed=args.seed, heavy_universe=256,
                              heavy_threshold=5.0)
    gen = NetLoadGen(target_qps=args.qps, connections=args.connections,
                     batch_max=args.batch_max, tenant=args.tenant,
                     auth_token=args.auth_token or None)
    report = gen.run(address, requests)
    print(report.to_json())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
