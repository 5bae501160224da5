"""Type II query surface on matrix sketches (TCM / gMatrix / kMatrix).

  * edge frequency              (per-sketch ``edge_freq``)
  * node out/in aggregate       (row/col sums, per-sketch)
  * reachability                boolean transitive closure per layer; a pair
                                is declared reachable only if EVERY layer
                                agrees (one-sided error, like CountMin)
  * heavy nodes / heavy edges   "reverse" sweeps over a vertex universe or
                                a candidate set
  * path / subgraph weight      composition of edge queries

The closure of a layer is O(log w) boolean squarings: one launch of the
``reach_closure`` kernel for all of them where a layer fits one block, else
one ``reach_step`` launch per squaring of all d layers.  ``build_closure`` and
the per-pair lookup are split so that a caller can close the layers once and
answer many pairs.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import kmatrix as km
from repro_torch.core import kmatrix_accel as kma
from repro_torch.core import matrix_sketch as ms
from repro_torch.kernels.ops import accel_reach_closure
from repro_torch.kernels.reach_closure import reach_step, reach_step_plain
from repro_torch.obs.profile import profile_call

CLOSURE_BACKENDS = ("kernel", "plain")


def _closure_steps(w: int, max_hops: int | None) -> int:
    """Number of squarings covering paths of length ``max_hops`` (or any)."""
    return (max(1, (w - 1).bit_length()) if max_hops is None
            else max(1, max_hops.bit_length()))


def closure_backend(backend: str | None = None) -> str:
    """Resolve the closure backend: the kernels unless the caller names
    ``"plain"`` (the plain PyTorch squaring, on any device)."""
    backend = backend or "kernel"
    if backend not in CLOSURE_BACKENDS:
        raise ValueError(f"unknown closure backend {backend!r} "
                         f"(expected one of {CLOSURE_BACKENDS})")
    return backend


def build_closure(adj_layers: torch.Tensor, max_hops: int | None = None, *,
                  backend: str | None = None) -> torch.Tensor:
    """Per-layer boolean closure: counter layers [d, w, w] -> bool [d, w, w].

    Equal to the JAX package's ``build_closure`` under either of its
    backends: squarings of a 0/1 float32 matrix are exact for w < 2^24.
    """
    backend = closure_backend(backend)
    step = reach_step if backend == "kernel" else reach_step_plain
    return profile_call(f"closure:{backend}", accel_reach_closure, adj_layers,
                        n_steps=_closure_steps(adj_layers.shape[-1], max_hops),
                        step=step)


def reachability_from_closure(closure: torch.Tensor, hi: torch.Tensor,
                              hj: torch.Tensor) -> torch.Tensor:
    """Pair lookup against a prebuilt closure; ``hi``/``hj`` are per-layer
    node slots [d, *S]."""
    d = closure.shape[0]
    rows = torch.arange(d, device=closure.device).view(
        (d,) + (1,) * (hi.dim() - 1))
    return closure[rows, hi.long(), hj.long()].all(dim=0)


def closure_layers(sk) -> torch.Tensor:
    """The [d, w, w] adjacency layers a sketch uses for connectivity queries.

    Only matrix-shaped Type II sketches qualify; CountMin/gSketch hash the
    whole edge to one cell, so they have no adjacency structure to close.
    """
    if isinstance(sk, (km.KMatrix, kma.KMatrixAccel)):
        if sk.conn_w == 0:
            raise ValueError(
                "kMatrix built with conn_frac=0 cannot answer reachability")
        return sk.conn
    if isinstance(sk, ms.MatrixSketch):
        return sk.table
    raise ValueError(
        f"reachability is not answerable by {type(sk).__name__}: "
        "no [d, w, w] adjacency layers")


def reach_cells(sk, v: torch.Tensor) -> torch.Tensor:
    """Per-layer connectivity-matrix slot of vertex ``v`` -> int32[d, *S]."""
    if isinstance(sk, km.KMatrix):
        return km.conn_cells(sk, v)
    if isinstance(sk, kma.KMatrixAccel):
        return kma.conn_cells(sk, v)
    if isinstance(sk, ms.MatrixSketch):
        return ms.node_cells(sk, v)
    raise ValueError(
        f"reachability is not answerable by {type(sk).__name__}: "
        "no [d, w, w] adjacency layers")


def reachability(sk: ms.MatrixSketch, src: torch.Tensor, dst: torch.Tensor,
                 max_hops: int | None = None) -> torch.Tensor:
    """Estimated reachability src ->* dst on a TCM / gMatrix table.  True
    may be a false positive (hash collisions merge nodes) but never a false
    negative."""
    closure = build_closure(sk.table, max_hops)  # [d, w, w]
    return reachability_from_closure(
        closure, ms.node_cells(sk, src), ms.node_cells(sk, dst))


def kmatrix_reachability(sk, src: torch.Tensor, dst: torch.Tensor,
                         max_hops: int | None = None) -> torch.Tensor:
    """Reachability on a kMatrix (either layout) via its global
    connectivity matrix."""
    closure = build_closure(closure_layers(sk), max_hops)
    return reachability_from_closure(
        closure, reach_cells(sk, src), reach_cells(sk, dst))


def heavy_nodes(
    node_freq_fn: Callable[[torch.Tensor], torch.Tensor],
    universe_size: int,
    threshold: float,
    *,
    chunk: int = 65536,
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reverse sweep: score every vertex id in [0, universe) and return
    (ids, freqs) of those with estimated aggregate >= threshold.

    Returns dense tensors of length ``universe_size`` rounded up to
    ``chunk``, with -1 ids (and 0 freqs) on misses, as the JAX package
    does; callers filter on the host.  The chunks are scored one after
    another on ``device``.
    """
    n_chunks = -(-universe_size // chunk)
    offsets = torch.arange(chunk, dtype=torch.int32, device=device)
    ids_out, freqs_out = [], []
    for start in range(0, n_chunks * chunk, chunk):
        ids = start + offsets
        freqs = node_freq_fn(ids)
        valid = (ids < universe_size) & (freqs >= threshold)
        ids_out.append(torch.where(valid, ids, -1))
        freqs_out.append(torch.where(valid, freqs, 0))
    if not ids_out:
        empty = torch.empty(0, dtype=torch.int32, device=device)
        return empty, empty.clone()
    return torch.cat(ids_out), torch.cat(freqs_out)


def heavy_edges(
    edge_freq_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    cand_src: torch.Tensor,
    cand_dst: torch.Tensor,
    threshold: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Candidate-set heavy-edge query: (mask, estimates, masked estimates)."""
    est = edge_freq_fn(cand_src, cand_dst)
    keep = est >= threshold
    return keep, est, torch.where(keep, est, 0)


def path_weight(
    edge_freq_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    path_nodes: torch.Tensor,
) -> torch.Tensor:
    """Aggregate (sum of estimated frequencies) along a node path [k]."""
    est = edge_freq_fn(path_nodes[:-1], path_nodes[1:])
    return est.sum(dtype=est.dtype)


def subgraph_weight(
    edge_freq_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    src: torch.Tensor,
    dst: torch.Tensor,
) -> torch.Tensor:
    """Total estimated weight of an explicit edge set."""
    est = edge_freq_fn(src, dst)
    return est.sum(dtype=est.dtype)
