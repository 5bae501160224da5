"""Shared hard-gate helpers: conservation + exactness checks for serving.

Everything here is pure checking: no timing, no I/O, no policy.  The two
invariant families:

  conservation   after a graceful drain, published counter mass + accounted
                 drops == stream total, per worker and summed;
  exactness      engine answers == direct module-level answers, and a
                 sketch is bit-identical — counters AND estimates — to a
                 single-sketch replay of the same stream.

Counters are compared on the host, so a sketch on the card can be held
against a replay on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving import engine as eng
from repro_torch.serving.snapshot import Snapshot, private_copy, sketch_device


def values_match(a, b) -> bool:
    """Equality for query answers (heavy-nodes answers are array pairs)."""
    if isinstance(a, tuple):
        return (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
    return a == b


def mismatched_indices(got: list, want: list) -> list[int]:
    """Indices where engine answers diverge from oracle answers."""
    return [i for i, (g, w) in enumerate(zip(got, want))
            if not values_match(g, w)]


def _equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    return torch.equal(x.cpu(), y.cpu())


def layout_counters_equal(a, b) -> bool:
    """Bit-equality of a sketch's counter state (pool(s) + conn), layout
    aware, wherever each sketch lives; the ``overflow`` diagnostic is
    deliberately excluded — dispatch capacity differs between sub-batch
    shapes, so runs with identical counters can tally different volumes."""
    if hasattr(a, "pools"):
        return (len(a.pools) == len(b.pools)
                and all(_equal(x, y) for x, y in zip(a.pools, b.pools))
                and _equal(a.conn, b.conn))
    if hasattr(a, "pool"):  # flat kMatrix (pool + conn) or gSketch (pool)
        return _equal(a.pool, b.pool) and (
            not hasattr(a, "conn") or _equal(a.conn, b.conn))
    return _equal(a.table, b.table)


def replay_sketch(mod, template, stream, n_batches: int):
    """Single-sketch oracle: ingest stream batches ``[0, n_batches)`` into a
    private copy of ``template`` (usually an ``empty_like`` clone sharing
    the layout under test), on the template's device.  The module's ingest
    writes in place, so the copy is what leaves ``template`` as it was."""
    sk = private_copy(template)
    dev = sketch_device(sk)
    for i in range(n_batches):
        sk = mod.ingest(sk, stream.batch(i, device=dev))
    return sk


def replay_exactness(snapshot: Snapshot, replay, requests,
                     *, answers=None) -> dict:
    """Gate a snapshot against a replayed sketch: bit-identical counters
    AND bit-identical direct estimates for ``requests``.

    ``replay`` must share the snapshot sketch's layout.  ``answers`` lets a
    caller reuse direct answers it already computed for the snapshot (the
    per-request oracle is the slow half of the gate).  Returns the
    ``counters_equal`` / ``estimates_equal`` / ``ok`` verdict dict.
    """
    counters_equal = layout_counters_equal(snapshot.sketch, replay)
    replay_snap = Snapshot(snapshot.tenant_id + "/replay", snapshot.epoch,
                           replay, snapshot.kind, snapshot.n_edges)
    if answers is None:
        answers = eng.direct_answers(snapshot, requests)
    replay_answers = eng.direct_answers(replay_snap, requests)
    estimates_equal = all(values_match(a, b)
                          for a, b in zip(answers, replay_answers))
    return {
        "counters_equal": bool(counters_equal),
        "estimates_equal": bool(estimates_equal),
        "ok": bool(counters_equal and estimates_equal),
    }


def conservation_verdict(published: int, dropped: int, stream_total: int,
                         unaccounted) -> dict:
    """Edge-mass verdict: published + accounted drops must equal the stream
    total AND every worker must individually balance (``unaccounted`` is
    one int or a per-worker list)."""
    per_worker = (list(unaccounted) if hasattr(unaccounted, "__len__")
                  else [unaccounted])
    return {
        "published_edges": published,
        "dropped_edges": dropped,
        "stream_total_edges": stream_total,
        "unaccounted_edges": sum(per_worker),
        "conservation_ok": bool(
            published + dropped == stream_total
            and all(u == 0 for u in per_worker)),
    }
