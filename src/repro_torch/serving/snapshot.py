"""Double-buffered, epoch-stamped read snapshots over live-ingesting sketches.

The serving contract: queries never observe a half-ingested sketch.  Each
tenant owns a ``SnapshotBuffer`` with two sides:

  front  — the *published* ``Snapshot``: an epoch-stamped sketch that every
           query in flight reads.
  back   — the *delta*: an ``empty_like`` twin (same layout, routing and
           hash seeds) that absorbs ingest batches.

``publish()`` folds the delta into the front through the module's
counter-additive ``merge``, bumps the epoch and starts a zeroed delta.  The
epoch number is the cache key for everything derived from a snapshot
(notably the closures the query engine caches).

Isolation.  The JAX package gets it from immutable arrays.  Here every
sketch module's ``ingest`` adds into its tensors *in place*, so the buffer
keeps one rule instead: no tensor of a front that has been handed out is
ever written again.

  * ``ingest`` writes only into the private delta;
  * ``publish`` and ``adopt_published`` build the new front with ``merge``,
    which returns fresh counter storage (the front and the incoming delta
    are only read); the delta is replaced by a fresh ``empty_like``, and a
    ``capture_publish_delta`` stash keeps the old one, which nothing
    writes again;
  * ``state()`` hands out private copies of the delta and of the pending
    count, and ``load_state`` copies what it is given.

A reader holding epoch N therefore keeps a consistent view however much is
ingested and published after it, at the cost of one fresh front per
publish (one elementwise add over the counters).

The pending edge count stays on the device (a 0-d int64 tensor each ingest
adds to) and is read on the host only by ``publish``, ``pending_edges`` and
``state``: no host sync per batch.  The JAX package's buffer donation has
no counterpart: there is one ingest, in place into the private delta.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any

import torch

from repro_torch.common.struct import is_static
from repro_torch.core.types import EdgeBatch
from repro_torch.obs.profile import profile_span


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """A point-in-time view of a tenant's sketch.

    ``epoch`` is monotonically increasing per tenant and uniquely identifies
    the counter state: two queries against the same (tenant_id, epoch) are
    guaranteed to see identical answers.  Nothing writes to ``sketch`` once
    it is published.
    """

    tenant_id: str
    epoch: int
    sketch: Any  # KMatrixAccel | KMatrix | MatrixSketch | GSketch | CountMin
    kind: str
    n_edges: int  # cumulative non-padding stream updates folded in

    def __repr__(self) -> str:  # keep tensor payload out of logs
        return (f"Snapshot({self.tenant_id!r}, epoch={self.epoch}, "
                f"kind={self.kind!r}, n_edges={self.n_edges})")


class StaleDelta(RuntimeError):
    """A delta publish was based on an epoch that is not the current front.

    Raised by :meth:`SnapshotBuffer.adopt_published` in delta mode when the
    shipped ``base_epoch`` disagrees with the front's epoch — folding the
    delta in would double- or under-count.  The adopting transport reacts
    by skipping the publish and requesting a full resync from the worker.
    """


_anon_ids = itertools.count()


def sketch_device(sk) -> torch.device:
    """The device a sketch's tensors live on (every kind has ``hashes``)."""
    return sk.hashes.a.device


def private_copy(obj, device=None):
    """A copy of a sketch (or any nest of tensor dataclasses and tuples)
    whose every tensor is fresh storage, on ``device`` if given."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device or obj.device, copy=True)
    if isinstance(obj, tuple):
        return tuple(private_copy(x, device) for x in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: private_copy(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if not is_static(f)})
    return obj


class _Done:
    """The completion fence of work that is already complete (the CPU's):
    the subset of ``torch.cuda.Event`` that a waiter uses."""

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass

    def wait(self, stream=None) -> None:
        pass


DONE = _Done()


class SnapshotBuffer:
    """Double buffer: live delta sketch (ingest side) + published Snapshot."""

    def __init__(self, sketch: Any, mod: Any, *, tenant_id: str | None = None,
                 kind: str = "") -> None:
        self._mod = mod
        # tenant_id keys every per-(tenant, epoch) cache downstream (notably
        # the engine's closure cache).  Two buffers must never share an id:
        # same-named tenants from differently-configured registries reach
        # the same epoch with different counters, and a shared engine would
        # serve one tenant the other's closures.  The instance suffix makes
        # the id unique per buffer while keeping the readable prefix.
        self._tenant_id = f"{tenant_id or 'anon'}#{next(_anon_ids)}"
        self._kind = kind or getattr(sketch, "kind", type(sketch).__name__.lower())
        self.device = sketch_device(sketch)
        self._front = Snapshot(self._tenant_id, 0, sketch,  # guarded-by(writes): _lock
                               self._kind, 0)
        self._delta = mod.empty_like(sketch)  # guarded-by: _lock
        self._pending = torch.zeros((), dtype=torch.int64,  # guarded-by: _lock
                                    device=self.device)
        self._fence: Any = DONE  # guarded-by: _lock
        # ingest calls so far (each one dispatch of a batch)
        self.ingests = 0  # guarded-by(writes): _lock
        # Delta publication: with the flag on, each publish() keeps the
        # pre-merge delta (and starts a fresh one) so a remote worker can
        # ship only what accumulated since the previous epoch.
        self.capture_publish_delta = False
        self.last_publish_delta: Any = None
        # Guards the back buffer (_delta/_pending) and the front swap against
        # a checkpointing thread reading ``state()`` mid-operation.  Readers
        # of ``snapshot`` need no lock: the property is one reference read
        # and nothing writes to the sketch behind it.
        self._lock = threading.Lock()

    @property
    def snapshot(self) -> Snapshot:
        return self._front

    @property
    def epoch(self) -> int:
        return self._front.epoch

    @property
    def pending_edges(self) -> int:
        """Non-padding updates sitting in the delta (host sync; diagnostics
        and conservation accounting only — not the ingest hot path)."""
        with self._lock:
            return int(self._pending)

    @property
    def overflow_edges(self) -> int:
        """Ingest updates beyond the width-class dispatch capacity (the
        ``overflow`` tally), front + live delta.  0 for layouts without
        overflow accounting.  Host sync; diagnostics only."""
        with self._lock:
            front = getattr(self._front.sketch, "overflow", None)
            delta = getattr(self._delta, "overflow", None)
            delta_total = int(delta) if delta is not None else 0
        if front is None:
            return 0
        return int(front) + delta_total

    def ingest(self, batch: EdgeBatch, count: int | None = None) -> None:
        """Absorb a batch into the back buffer; published readers unaffected.

        ``count`` (optional) is the number of weight>0 updates the batch
        *represents*, for a caller that pre-aggregated duplicate rows on the
        host; by default the device counts the batch's weight>0 rows.
        """
        with self._lock, profile_span("snapshot.ingest"):
            self._mod.ingest(self._delta, batch)  # writes: 0 (the private delta)
            self.ingests += 1
            if count is None:
                self._pending += (batch.weight > 0).sum()
            else:
                self._pending += int(count)
            if self.device.type == "cuda":
                self._fence = torch.cuda.Event()
                self._fence.record()

    def dispatch_token(self):
        """Completion fence for everything ingested so far: a
        ``torch.cuda.Event`` recorded after the last ingest of a CUDA
        buffer (``query()``, ``synchronize()``, ``wait(stream)``), or, on
        the CPU and before any ingest, a fence that is always complete.  A
        pipelined caller waits on it before reusing a host staging buffer
        that an ingest may still be reading."""
        with self._lock:
            return self._fence

    def publish(self) -> Snapshot:
        """Fold the delta into a fresh front and stamp a new epoch.

        This is the only host sync point in the ingest path (the pending
        edge count is read to stamp the snapshot).
        """
        with self._lock, profile_span("snapshot.publish",
                                      self._front.epoch + 1):
            pending = int(self._pending)
            merged = self._mod.merge(self._front.sketch, self._delta)
            if self.capture_publish_delta:
                # exactly what this publish folds in; nothing writes to it
                # again, since the buffer moves on to a fresh delta
                self.last_publish_delta = self._delta
            self._delta = self._mod.empty_like(self._delta)
            self._front = Snapshot(
                self._tenant_id,
                self._front.epoch + 1,
                merged,
                self._kind,
                self._front.n_edges + pending,
            )
            self._pending = torch.zeros_like(self._pending)
            return self._front

    def adopt_published(self, sketch: Any, epoch: int, n_edges: int, *,
                        delta: Any = None,
                        base_epoch: int | None = None) -> Snapshot:
        """Install an externally-produced published front.

        A remote ingest worker folds batches into a sketch of its own and
        ships each published epoch back; this swaps that state in as the
        new front WITHOUT touching the local delta.  Readers holding the
        previous front keep a consistent epoch.  The caller must adopt
        epochs in publication order.

        Two modes:

          full   ``sketch`` is the worker's whole published front; installed
                 as it is (the caller hands it over and does not write it).
          delta  ``sketch`` is ignored; ``delta`` is what the worker
                 accumulated since its previous publish, folded into the
                 current front through the same ``merge`` the worker's
                 publish used (fresh storage; ``delta`` is only read).
                 ``base_epoch`` must equal the current front epoch or the
                 fold would mis-count: any gap raises :class:`StaleDelta`.
        """
        with self._lock:
            if delta is not None:
                if base_epoch is None or int(base_epoch) != self._front.epoch:
                    raise StaleDelta(
                        f"delta publish for epoch {epoch} is based on epoch "
                        f"{base_epoch}, but the front is at epoch "
                        f"{self._front.epoch}; a full resync is required")
                sketch = self._mod.merge(self._front.sketch, delta)
            self._front = Snapshot(self._tenant_id, int(epoch),
                                   sketch, self._kind, int(n_edges))
            return self._front

    # ------------------------------------------------------------ checkpoint
    def state(self) -> dict:
        """Mutually-consistent (front, delta, pending, epoch, n_edges) view.

        The front is handed out by reference (nothing writes to it); the
        delta and the pending count are private copies, since the next
        ingest writes into the live ones in place.
        """
        with self._lock:
            return {
                "front": self._front.sketch,
                "delta": private_copy(self._delta),
                "pending": self._pending.clone(),
                "epoch": self._front.epoch,
                "n_edges": self._front.n_edges,
            }

    def load_state(self, state: dict) -> Snapshot:
        """Restore a ``state()`` (same sketch layout required).  Front and
        delta are copied into private storage on the buffer's device, so
        the caller's tensors are never written."""
        with self._lock:
            self._front = Snapshot(
                self._tenant_id,
                int(state["epoch"]),
                private_copy(state["front"], self.device),
                self._kind,
                int(state["n_edges"]),
            )
            self._delta = private_copy(state["delta"], self.device)
            self._pending = torch.tensor(int(state["pending"]),
                                         dtype=torch.int64, device=self.device)
            return self._front
