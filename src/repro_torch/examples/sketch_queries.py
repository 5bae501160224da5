"""Tour of the Type II query surface on kMatrix (what CountMin can't do).

    python -m repro_torch.examples.sketch_queries [--device cpu]

The JAX package's ``examples/sketch_queries.py`` on the port: a small
social-network-like stream, then edge frequency, node in/out aggregates,
reachability (against a plain BFS over the stream's edges), heavy nodes
via the vectorized reverse sweep, and path weights.  Its lines equal the
JAX example's.
"""
from __future__ import annotations

import argparse
from collections import deque

import numpy as np
import torch

from repro_torch.core import (EdgeBatch, KMatrix, kmatrix, queries,
                              vertex_stats_from_sample)
from repro_torch.core.metrics import exact_edge_frequencies, lookup_exact
from repro_torch.launch.stream_ingest import require_device


def has_path(adj: dict, a: int, b: int) -> bool:
    """Ground-truth reachability: a breadth-first search from ``a``."""
    seen, todo = {a}, deque([a])
    while todo:
        u = todo.popleft()
        if u == b:
            return True
        for v in adj.get(u, ()):
            if v not in seen:
                seen.add(v)
                todo.append(v)
    return False


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; exits if no card) or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)

    rng = np.random.default_rng(7)
    n_nodes = 400
    # hub structure: node 7 posts a lot; a few chains for reachability
    src = np.concatenate([
        np.full(600, 7, np.int32),
        rng.integers(0, n_nodes, 2400).astype(np.int32),
        np.asarray([100, 101, 102, 103], np.int32),
    ])
    dst = np.concatenate([
        rng.integers(0, n_nodes, 600).astype(np.int32),
        rng.integers(0, n_nodes, 2400).astype(np.int32),
        np.asarray([101, 102, 103, 104], np.int32),
    ])
    keep = src != dst
    src, dst = src[keep], dst[keep]

    def ids(values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, np.int32), device=device)

    stats = vertex_stats_from_sample(src[:1500], dst[:1500])
    sk = KMatrix.create(bytes_budget=128 * 1024, stats=stats, depth=5, seed=0,
                        conn_frac=0.3, device=device)
    kmatrix.ingest(sk, EdgeBatch.from_numpy(src, dst, device=device))

    # --- edge frequency --------------------------------------------------
    fmap = exact_edge_frequencies(src, dst, np.ones_like(src))
    qs, qd = src[:8], dst[:8]
    est = kmatrix.edge_freq(sk, ids(qs), ids(qd)).tolist()
    true = lookup_exact(fmap, qs, qd)
    print("edge freq (est vs true):",
          list(zip(est, true.astype(int).tolist())))

    # --- node aggregates --------------------------------------------------
    out7 = int(kmatrix.node_out_freq(sk, ids([7]))[0])
    out_typical = int(kmatrix.node_out_freq(sk, ids([42]))[0])
    print(f"node 7 out-aggregate ~{out7} (true {int((src == 7).sum())}); "
          f"node 42 ~{out_typical} (true {int((src == 42).sum())})")

    # --- heavy nodes: reverse sweep over the universe ---------------------
    heavy, _freqs = queries.heavy_nodes(
        lambda v: kmatrix.node_out_freq(sk, v), n_nodes, threshold=300,
        chunk=128, device=device)
    heavy = heavy.cpu().numpy()
    print("heavy nodes (threshold 300):",
          sorted(set(heavy[heavy >= 0].tolist())))

    # --- reachability vs a BFS over the stream ----------------------------
    adj: dict = {}
    for a, b in zip(src.tolist(), dst.tolist()):
        adj.setdefault(a, []).append(b)
    pairs = [(100, 104), (104, 100), (100, 103)]
    est_reach = queries.kmatrix_reachability(
        sk, ids([p[0] for p in pairs]), ids([p[1] for p in pairs])).tolist()
    for (a, b), e in zip(pairs, est_reach):
        t = has_path(adj, a, b)
        print(f"reach {a}->{b}: sketch={bool(e)} true={t}"
              f"{'  (false positive)' if e and not t else ''}")

    # --- path weight -------------------------------------------------------
    pw = float(queries.path_weight(
        lambda s, d: kmatrix.edge_freq(sk, s, d),
        ids([100, 101, 102, 103, 104])))
    print(f"path 100->...->104 weight >= {pw:.0f} (true 4)")


if __name__ == "__main__":
    main()
