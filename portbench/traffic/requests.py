"""The benchmark's query generator and arrival schedules: frozen copies.

``MIX_DEFAULT`` and ``synth_requests`` are copied from
``src/repro_torch/serving/loadgen.py`` (``WorkloadMix`` and
``synth_requests``) at commit cbdfd1d8e666db7c6b1c59ee99c9e22d4d3a7c8d,
drawing the same requests for the same seed.  The copy returns plain tuples,
not the program's ``Request`` objects, so that the reference reads what was
asked without importing the program:

  ("edge_freq", src, dst)          ("reach", src, dst)
  ("node_out", v)                  ("path_weight", (v0, v1, ...))
  ("subgraph_weight", ((s, d), ...))
  ("heavy_nodes", universe, threshold)

``arrival_times`` is the open loop's schedule: ``OpenLoopLoadGen.run``
schedules at a fixed interval.
"""
from __future__ import annotations

import numpy as np

FAMILIES = ("edge_freq", "reach", "node_out", "path_weight",
            "subgraph_weight", "heavy_nodes")

# The JAX package's and the port's default mix (``WorkloadMix()``).
MIX_DEFAULT = {"edge_freq": 0.55, "reach": 0.25, "node_out": 0.10,
               "path_weight": 0.05, "subgraph_weight": 0.03,
               "heavy_nodes": 0.02}


def synth_requests(n: int, mix: dict, *, n_nodes: int, seed: int,
                   zipf_a: float = 1.2, path_len: int = 4,
                   subgraph_edges: int = 3, heavy_universe: int | None = None,
                   heavy_threshold: float = 100.0) -> list[tuple]:
    """Draw ``n`` requests with Zipf-skewed endpoints over ``[0, n_nodes)``;
    ``mix`` maps each family of ``FAMILIES`` (in that order) to a weight.

    The program draws each endpoint with its own ``rng.zipf`` call, in
    request order; one call for all of them draws the same numbers."""
    rng = np.random.default_rng(seed)
    weights = np.asarray([float(mix.get(f, 0.0)) for f in FAMILIES])
    if weights.sum() <= 0:
        raise ValueError("empty workload mix")
    probs = weights / weights.sum()
    choice = rng.choice(len(FAMILIES), size=n, p=probs)
    per_family = np.asarray([2, 2, 1, path_len, 2 * subgraph_edges, 0])
    nodes = np.minimum(rng.zipf(zipf_a, size=int(per_family[choice].sum())) - 1,
                       n_nodes - 1).tolist()
    heavy = ("heavy_nodes", int(heavy_universe or n_nodes),
             float(heavy_threshold))
    reqs: list[tuple] = []
    k = 0
    for c in choice.tolist():
        fam = FAMILIES[c]
        if fam in ("edge_freq", "reach"):
            reqs.append((fam, nodes[k], nodes[k + 1]))
            k += 2
        elif fam == "node_out":
            reqs.append((fam, nodes[k]))
            k += 1
        elif fam == "path_weight":
            reqs.append((fam, tuple(nodes[k:k + path_len])))
            k += path_len
        elif fam == "subgraph_weight":
            flat = nodes[k:k + 2 * subgraph_edges]
            reqs.append((fam, tuple(zip(flat[0::2], flat[1::2]))))
            k += 2 * subgraph_edges
        else:
            reqs.append(heavy)
    return reqs


def arrival_times(n: int, qps: float) -> np.ndarray:
    """Scheduled arrival offsets (seconds from the window's start) of ``n``
    requests, one every ``1/qps``."""
    if qps <= 0:
        raise ValueError(f"qps must be positive, got {qps}")
    return np.arange(n) / qps
