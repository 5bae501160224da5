"""Batched query planner over published snapshots.

Serving-side counterpart of ``repro_torch.core.queries``: accepts a
heterogeneous list of ``Request``s, groups them by query family, pads each
group to a power-of-two bucket and answers every group with one batched
call on the snapshot's device.  Two properties matter:

  exactness — the engine is a *planner*, not an approximation layer: for a
    given snapshot its answers are bit-identical to calling the module-level
    query functions directly (``direct_answers``), and to the JAX package's
    engine on the same counters.

  closure caching — reachability closes every connectivity layer
    (``core.queries.build_closure``: one ``reach_closure`` launch on the
    card where a layer fits one block).  A closure depends only on
    (tenant, epoch, max_hops), so the engine caches it LRU-style under that
    key — never under a tensor's identity, which in-place ingest keeps.
    Publish bumps the epoch, which *is* the invalidation rule.

On a CUDA snapshot the padded arrays are made on the card: TCM/gMatrix
edge, path and subgraph groups are one ``matrix_lookup_edges`` launch each,
the width-class kMatrix's are plain gathers (outside any kernel in the JAX
package too).  Every handler brings its answers to the host before
``execute`` returns, so a caller's latency counts their completion.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import CountMin, GSketch, KMatrix, KMatrixAccel, MatrixSketch
from repro_torch.core import (
    countmin,
    gsketch,
    kmatrix,
    kmatrix_accel,
    matrix_sketch,
    queries,
)
from repro_torch.obs.hub import get_hub
from repro_torch.serving.snapshot import Snapshot, sketch_device

EDGE_FREQ = "edge_freq"
NODE_OUT = "node_out"
NODE_IN = "node_in"
REACH = "reach"
PATH_WEIGHT = "path_weight"
SUBGRAPH_WEIGHT = "subgraph_weight"
HEAVY_NODES = "heavy_nodes"

FAMILIES = (EDGE_FREQ, NODE_OUT, NODE_IN, REACH, PATH_WEIGHT,
            SUBGRAPH_WEIGHT, HEAVY_NODES)


@dataclasses.dataclass(frozen=True)
class Request:
    """One query; use the constructors below rather than raw instantiation."""

    family: str
    src: int = 0
    dst: int = 0
    node: int = 0
    nodes: tuple[int, ...] = ()
    edges: tuple[tuple[int, int], ...] = ()
    universe: int = 0
    threshold: float = 0.0
    max_hops: int | None = None


def edge_freq(src: int, dst: int) -> Request:
    return Request(EDGE_FREQ, src=int(src), dst=int(dst))


def node_out(node: int) -> Request:
    return Request(NODE_OUT, node=int(node))


def node_in(node: int) -> Request:
    return Request(NODE_IN, node=int(node))


def reach(src: int, dst: int, max_hops: int | None = None) -> Request:
    return Request(REACH, src=int(src), dst=int(dst), max_hops=max_hops)


def path_weight(nodes) -> Request:
    return Request(PATH_WEIGHT, nodes=tuple(int(v) for v in nodes))


def subgraph_weight(edges) -> Request:
    return Request(SUBGRAPH_WEIGHT,
                   edges=tuple((int(s), int(d)) for s, d in edges))


def heavy_nodes(universe: int, threshold: float) -> Request:
    return Request(HEAVY_NODES, universe=int(universe),
                   threshold=float(threshold))


@dataclasses.dataclass(frozen=True)
class Result:
    family: str
    epoch: int
    value: Any  # int | bool | (ids ndarray, freqs ndarray) for heavy_nodes


_MODULES = {KMatrix: kmatrix, KMatrixAccel: kmatrix_accel,
            MatrixSketch: matrix_sketch,
            GSketch: gsketch, CountMin: countmin}


def sketch_module(sk: Any):
    mod = _MODULES.get(type(sk))
    if mod is None:
        raise TypeError(f"no query module for sketch type {type(sk).__name__}")
    return mod


def _bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power-of-two >= n within [lo, hi]."""
    b = lo
    while b < n and b < hi:
        b <<= 1
    return b


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


class ClosureCache:
    """LRU of per-layer boolean closures keyed by
    (tenant_id, epoch, max_hops)."""

    def __init__(self, capacity: int = 8) -> None:
        self.capacity = capacity
        self._entries: OrderedDict[tuple, torch.Tensor] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, snapshot: Snapshot, max_hops: int | None) -> torch.Tensor:
        return self.get_or_build(
            (snapshot.tenant_id, snapshot.epoch, max_hops),
            lambda: queries.build_closure(
                queries.closure_layers(snapshot.sketch), max_hops))

    def get_or_build(self, key: tuple, build: Callable) -> torch.Tensor:
        """LRU lookup under an arbitrary key, calling ``build()`` on miss."""
        closure = self._entries.get(key)
        if closure is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            return closure
        self.misses += 1
        closure = build()
        self._entries[key] = closure
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
        return closure

    def clear(self) -> None:
        self._entries.clear()


class QueryEngine:
    """Plans heterogeneous request batches into batched calls."""

    def __init__(self, *, min_bucket: int = 64, max_bucket: int = 1 << 14,
                 heavy_chunk: int = 4096, closure_capacity: int = 8) -> None:
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.heavy_chunk = heavy_chunk
        self.closures = ClosureCache(closure_capacity)
        self.batches_planned = 0

    # ------------------------------------------------------------- plumbing
    @staticmethod
    def _pad(vals: list[int], bucket: int, device) -> torch.Tensor:
        arr = np.zeros(bucket, np.int32)
        arr[: len(vals)] = vals
        return torch.as_tensor(arr, device=device)

    @staticmethod
    def _pair_sum(sk, mod, src: np.ndarray, dst: np.ndarray,
                  mask: np.ndarray) -> np.ndarray:
        """Masked int32 sum of edge frequencies along the last axis
        (shared by path_weight and subgraph_weight)."""
        dev = sketch_device(sk)
        est = mod.edge_freq(sk, torch.as_tensor(src, device=dev),
                            torch.as_tensor(dst, device=dev))
        keep = torch.as_tensor(mask, device=dev)
        return _host(torch.where(keep, est, 0).sum(dim=-1, dtype=torch.int32))

    # ------------------------------------------------------------- planning
    def execute(self, snapshot: Snapshot, requests: list[Request]
                ) -> list[Result]:
        """Answer ``requests`` (any mix of families) against one snapshot.

        Returns results in request order.  Exact: each family is routed to
        the same ``repro_torch.core`` functions a direct caller would use.
        """
        sk = snapshot.sketch
        mod = sketch_module(sk)
        values: list[Any] = [None] * len(requests)

        groups: dict[tuple, list[int]] = {}
        for i, r in enumerate(requests):
            groups.setdefault(self._group_key(r), []).append(i)

        hub = get_hub()
        for key, idxs in groups.items():
            family = key[0]
            handler = self._HANDLERS[family]
            t0 = time.perf_counter()
            # a group can exceed the largest bucket; split it rather than
            # overflowing the padded arrays
            for lo in range(0, len(idxs), self.max_bucket):
                handler(self, snapshot, sk, mod, key,
                        idxs[lo:lo + self.max_bucket], requests, values)
                self.batches_planned += 1
            hub.counter("repro_engine_requests_total",
                        "requests planned, by query class",
                        family=family).inc(len(idxs))
            hub.histogram("repro_engine_group_seconds",
                          "handler wall time per planned group, "
                          "by query class",
                          family=family).observe(time.perf_counter() - t0)

        return [Result(requests[i].family, snapshot.epoch, values[i])
                for i in range(len(requests))]

    def _group_key(self, r: Request) -> tuple:
        if r.family == REACH:
            return (REACH, r.max_hops)
        if r.family == PATH_WEIGHT:
            if len(r.nodes) > self.max_bucket:
                raise ValueError(
                    f"path_weight request with {len(r.nodes)} nodes exceeds "
                    f"max_bucket={self.max_bucket}; split the path")
            return (PATH_WEIGHT,
                    _bucket(len(r.nodes), 2, self.max_bucket))
        if r.family == SUBGRAPH_WEIGHT:
            if len(r.edges) > self.max_bucket:
                raise ValueError(
                    f"subgraph_weight request with {len(r.edges)} edges "
                    f"exceeds max_bucket={self.max_bucket}; split the edge set")
            return (SUBGRAPH_WEIGHT,
                    _bucket(max(len(r.edges), 1), 1, self.max_bucket))
        return (r.family,)

    # ------------------------------------------------------------- handlers
    def _run_edge_freq(self, snapshot, sk, mod, key, idxs, requests, values):
        n = len(idxs)
        b = _bucket(n, self.min_bucket, self.max_bucket)
        dev = sketch_device(sk)
        src = self._pad([requests[i].src for i in idxs], b, dev)
        dst = self._pad([requests[i].dst for i in idxs], b, dev)
        est = _host(mod.edge_freq(sk, src, dst))[:n]
        for j, i in enumerate(idxs):
            values[i] = int(est[j])

    def _run_node_agg(self, snapshot, sk, mod, key, idxs, requests, values):
        family = key[0]
        name = "node_out_freq" if family == NODE_OUT else "node_in_freq"
        fn = getattr(mod, name, None)
        if fn is None:
            raise ValueError(
                f"{family} is not answerable by {type(sk).__name__} "
                f"(no {name})")
        n = len(idxs)
        b = _bucket(n, self.min_bucket, self.max_bucket)
        nodes = self._pad([requests[i].node for i in idxs], b,
                          sketch_device(sk))
        est = _host(fn(sk, nodes))[:n]
        for j, i in enumerate(idxs):
            values[i] = int(est[j])

    def _run_reach(self, snapshot, sk, mod, key, idxs, requests, values):
        _, max_hops = key
        closure = self.closures.get(snapshot, max_hops)
        n = len(idxs)
        b = _bucket(n, self.min_bucket, self.max_bucket)
        dev = sketch_device(sk)
        src = self._pad([requests[i].src for i in idxs], b, dev)
        dst = self._pad([requests[i].dst for i in idxs], b, dev)
        out = _host(queries.reachability_from_closure(
            closure, queries.reach_cells(sk, src),
            queries.reach_cells(sk, dst)))[:n]
        for j, i in enumerate(idxs):
            values[i] = bool(out[j])

    def _run_path(self, snapshot, sk, mod, key, idxs, requests, values):
        _, node_bucket = key
        n = len(idxs)
        b = _bucket(n, 1, self.max_bucket)
        src = np.zeros((b, node_bucket - 1), np.int32)
        dst = np.zeros((b, node_bucket - 1), np.int32)
        mask = np.zeros((b, node_bucket - 1), bool)
        for j, i in enumerate(idxs):
            nodes = requests[i].nodes
            k = len(nodes) - 1
            src[j, :k] = nodes[:-1]
            dst[j, :k] = nodes[1:]
            mask[j, :k] = True
        out = self._pair_sum(sk, mod, src, dst, mask)[:n]
        for j, i in enumerate(idxs):
            values[i] = int(out[j])

    def _run_subgraph(self, snapshot, sk, mod, key, idxs, requests, values):
        _, edge_bucket = key
        n = len(idxs)
        b = _bucket(n, 1, self.max_bucket)
        src = np.zeros((b, edge_bucket), np.int32)
        dst = np.zeros((b, edge_bucket), np.int32)
        mask = np.zeros((b, edge_bucket), bool)
        for j, i in enumerate(idxs):
            edges = requests[i].edges
            for k, (s, d) in enumerate(edges):
                src[j, k], dst[j, k], mask[j, k] = s, d, True
        out = self._pair_sum(sk, mod, src, dst, mask)[:n]
        for j, i in enumerate(idxs):
            values[i] = int(out[j])

    def _run_heavy(self, snapshot, sk, mod, key, idxs, requests, values):
        if getattr(mod, "node_out_freq", None) is None:
            raise ValueError(
                f"heavy_nodes is not answerable by {type(sk).__name__}")
        # identical sweeps are common in real workloads: answer each
        # (universe, threshold) once per batch
        unique: dict[tuple, Any] = {}
        for i in idxs:
            r = requests[i]
            qkey = (r.universe, r.threshold)
            if qkey not in unique:
                chunk = min(self.heavy_chunk,
                            _bucket(r.universe, 64, self.heavy_chunk))
                ids, freqs = queries.heavy_nodes(
                    lambda v: mod.node_out_freq(sk, v), r.universe,
                    r.threshold, chunk=chunk, device=sketch_device(sk))
                ids = _host(ids)
                keep = ids >= 0
                unique[qkey] = (ids[keep], _host(freqs)[keep])
            values[i] = unique[qkey]

    _HANDLERS = {
        EDGE_FREQ: _run_edge_freq,
        NODE_OUT: _run_node_agg,
        NODE_IN: _run_node_agg,
        REACH: _run_reach,
        PATH_WEIGHT: _run_path,
        SUBGRAPH_WEIGHT: _run_subgraph,
        HEAVY_NODES: _run_heavy,
    }

    @property
    def stats(self) -> dict:
        return {
            "batches_planned": self.batches_planned,
            "closure_hits": self.closures.hits,
            "closure_misses": self.closures.misses,
        }


def direct_answers(snapshot: Snapshot, requests: list[Request]) -> list[Any]:
    """Reference oracle: answer each request one-by-one through the
    module-level ``repro_torch.core`` query functions (no planner, no
    padding, no closure cache), on the snapshot's device.  The engine must
    match this exactly for the same snapshot.
    """
    sk = snapshot.sketch
    mod = sketch_module(sk)
    dev = sketch_device(sk)

    def ids(vals) -> torch.Tensor:
        return torch.as_tensor(np.asarray(vals, np.int32), device=dev)

    ef = lambda s, d: mod.edge_freq(sk, s, d)  # noqa: E731
    out: list[Any] = []
    for r in requests:
        if r.family == EDGE_FREQ:
            out.append(int(ef(ids([r.src]), ids([r.dst]))[0]))
        elif r.family == NODE_OUT:
            out.append(int(mod.node_out_freq(sk, ids([r.node]))[0]))
        elif r.family == NODE_IN:
            out.append(int(mod.node_in_freq(sk, ids([r.node]))[0]))
        elif r.family == REACH:
            # through closure_layers/reach_cells so Type I sketches are
            # rejected exactly like the engine rejects them
            closure = queries.build_closure(queries.closure_layers(sk),
                                            r.max_hops)
            out.append(bool(queries.reachability_from_closure(
                closure, queries.reach_cells(sk, ids([r.src])),
                queries.reach_cells(sk, ids([r.dst])))[0]))
        elif r.family == PATH_WEIGHT:
            out.append(int(queries.path_weight(ef, ids(r.nodes))))
        elif r.family == SUBGRAPH_WEIGHT:
            out.append(int(queries.subgraph_weight(
                ef, ids([e[0] for e in r.edges]),
                ids([e[1] for e in r.edges]))))
        elif r.family == HEAVY_NODES:
            hid, freqs = queries.heavy_nodes(
                lambda v: mod.node_out_freq(sk, v), r.universe, r.threshold,
                device=dev)
            hid = _host(hid)
            keep = hid >= 0
            out.append((hid[keep], _host(freqs)[keep]))
        else:
            raise ValueError(f"unknown family {r.family!r}")
    return out
