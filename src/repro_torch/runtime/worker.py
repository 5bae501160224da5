"""Per-tenant background ingest worker (DESIGN.md §Runtime).

# analysis: hot-path — the per-batch ingest loop; the no-pickle-hot-path
# rule keeps serialization out of this module (checkpoints go through
# repro_torch.checkpoint.store, never inline pickle).

The JAX package's ``runtime/worker.py`` on PyTorch.  One ``IngestWorker``
thread owns one tenant's write path end to end: it pulls ``QueueItem``s
from the tenant's bounded queue, folds them into the registry's delta
sketch (``SnapshotBuffer.ingest``), feeds the tenant's online reservoir
sample, publishes epochs when its ``PublishPolicy`` says so, and writes
crash-safe checkpoints through ``repro_torch.checkpoint.store`` (the JAX
on-disk layout, so either package restores the other's).

Single-writer discipline: everything the worker mutates (delta buffer,
stream offset, reservoir, metrics) is touched by this thread only, EXCEPT
checkpoint capture, which any thread may request — ``_state_lock`` makes
the (buffer state, ingested offset, reservoir) triple mutually consistent
for that one reader.  Queries never take any of these locks: they read the
published snapshot reference, whose tensors nothing writes again.

On the card, the worker thread and the query thread issue their work on
the same stream, the device's current (default) one: ``merge`` builds each
published front on it, so every query kernel issued after the front is
swapped in runs after the front is complete, with no event between them.
A side stream for ingest would need an event wait at publish and
``record_stream`` on every tensor crossing it.

Worker lifecycle::

    CREATED --start()--> RUNNING --request_stop(drain=True)--> DRAINING
        RUNNING/DRAINING --queue empty--> STOPPED   (final publish + ckpt)
        RUNNING --request_stop(drain=False)--> STOPPED  (crash-like: no
                final publish, no final checkpoint — restore must replay)
        any ----unhandled exception----> FAILED     (error kept for health())
"""
from __future__ import annotations

import threading
import time
import traceback

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.core.types import EdgeBatch
from repro_torch.obs.profile import profile_span
from repro_torch.obs.trace import get_trace_log
from repro_torch.runtime.metrics import WorkerMetrics
from repro_torch.runtime.policies import PublishPolicy
from repro_torch.runtime.queueing import BoundedEdgeQueue, QueueItem
from repro_torch.streams.reservoir import Reservoir

CREATED = "created"
RUNNING = "running"
DRAINING = "draining"
STOPPED = "stopped"
FAILED = "failed"


def _item_nbytes(item: QueueItem) -> int:
    """Host bytes one queued item contributes to a coalesced dispatch, from
    its ACTUAL column dtypes (externally submitted wide-weight columns can
    arrive as int64)."""
    return item.src.shape[0] * (item.src.dtype.itemsize
                                + item.dst.dtype.itemsize
                                + item.weight.dtype.itemsize)


def preaggregate_edges(src: np.ndarray, dst: np.ndarray,
                       weight: np.ndarray):
    """Exact (src, dst) duplicate-edge pre-aggregation for linear sketches.

    Returns ``(usrc, udst, uweight)`` int32 arrays with one row per
    distinct (src, dst) pair, weights summed, zero-sum rows dropped.

    Sketch counters are linear — every update is ``cell += weight`` — and
    int32 addition modulo 2^32 is commutative and associative, so
    scattering one summed row equals scattering each duplicate in turn.
    The group sum runs in int64 and truncates back to int32, which equals
    the sequential wrap-add chain mod 2^32.  Negative weights (turnstile
    deletions) ride along; weight-0 rows are padding and are dropped,
    including groups whose weights cancel to exactly zero.  (The
    width-class ingest drops weights <= 0 from its pools, so on a
    turnstile batch a summed pair can land in a pool where its parts would
    not have: the identity holds for insert-only streams, as in the JAX
    package.)
    """
    s = np.ascontiguousarray(src, np.int32)
    d = np.ascontiguousarray(dst, np.int32)
    w = np.ascontiguousarray(weight, np.int32)
    live = w != 0
    if not live.all():
        s, d, w = s[live], d[live], w[live]
    if s.size == 0:
        z = np.zeros(0, np.int32)
        return z, z, z
    # pack (src, dst) into one uint64 key: sort once, group once
    key = (s.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | d.view(np.uint32).astype(np.uint64)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    ws = w[order].astype(np.int64)
    starts = np.flatnonzero(np.concatenate(([True], ks[1:] != ks[:-1])))
    sums = np.add.reduceat(ws, starts)
    uw = sums.astype(np.int32)  # int64 -> int32 truncation == wrap-add chain
    keep = uw != 0
    uk = ks[starts][keep]
    usrc = (uk >> np.uint64(32)).astype(np.uint32).view(np.int32)
    udst = uk.astype(np.uint32).view(np.int32)
    return usrc, udst, uw[keep]


class IngestWorker(threading.Thread):
    def __init__(self, tenant, queue: BoundedEdgeQueue,
                 policy: PublishPolicy, *,
                 reservoir: Reservoir | None = None,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 0,
                 on_publish=None,
                 poll_s: float = 0.05,
                 coalesce_batches: int = 1,
                 coalesce_target: int = 8192,
                 dedup: bool = False) -> None:
        super().__init__(name=f"ingest-{tenant.key.tenant_id}", daemon=True)
        self.tenant = tenant
        self.queue = queue
        self.policy = policy
        self.reservoir = reservoir
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.on_publish = on_publish
        self.poll_s = poll_s
        # Ingest coalescing: under backlog, fold up to ``coalesce_batches``
        # queued items (or ~``coalesce_target`` edges) into ONE device
        # dispatch.  The per-dispatch fixed cost is independent of batch
        # size, so many small batches — the sharded regime, where each
        # shard sees ~B/K edges per stream batch — pay it K-fold;
        # coalescing restores dispatch-count parity with the unsharded
        # path.  1 (the default) keeps item-at-a-time behaviour.
        self.coalesce_batches = max(1, coalesce_batches)
        self.coalesce_target = coalesce_target
        # Exact duplicate-edge pre-aggregation: sort/unique each group on
        # (src, dst) and sum weights before dispatch (preaggregate_edges).
        # The pending ledger then takes the HOST count of raw weight>0
        # updates (QueueItem.n_edges), since the deduped device batch no
        # longer carries one row per stream update.
        self.dedup = bool(dedup)
        # Dispatch-size byte cap: coalesce_target edges at the canonical
        # 3×int32 = 12 B/edge layout, groups accounted at each item's
        # ACTUAL column dtypes.  A deep backlog must not build an unbounded
        # coalesced batch; an item that would push the group past the cap
        # is HELD and leads the next group.
        self._coalesce_byte_cap = 12 * max(1, coalesce_target)
        self._held: QueueItem | None = None
        # Pipelined dispatch: two ping-pong host staging column sets.  On
        # the card they are pinned, so the host-to-device copy of a batch
        # is asynchronous — which means a slot may only be refilled once
        # the copy that read it has run.  Each slot's fence is the buffer's
        # dispatch_token (a CUDA event recorded after the ingest, on the
        # stream that ran the copy); waiting on the PREVIOUS use of a slot
        # (two dispatches back) lets the worker coalesce group N+1 on the
        # host while the card still runs group N.
        self._stage: list = [None, None]
        self._stage_fence: list = [None, None]
        self._stage_idx = 0
        self._pinned = tenant.buffer.device.type == "cuda"
        self.metrics = WorkerMetrics()
        self.metrics.bind_hub(tenant.key.tenant_id)
        self._trace = get_trace_log()
        # trace IDs ingested since the last publish; the publish event
        # closes them all with the epoch they became visible in (bounded:
        # a pathological publish policy must not grow this without limit)
        self._pending_traces: list[str] = []
        self.state = CREATED
        self.error: BaseException | None = None
        self.error_tb: str | None = None  # formatted traceback, for callers
        #                                   in other threads that cannot
        #                                   reach error.__traceback__
        self._stop_event = threading.Event()
        self._drain = True
        self._state_lock = threading.Lock()
        self._ingested_offset = tenant.offset - 1  # last batch folded in
        self._batches_since_checkpoint = 0
        # conservation baseline: edges already in the tenant (published +
        # pending delta) before this worker touched it
        self.base_edges = (tenant.snapshot.n_edges
                          + tenant.buffer.pending_edges)

    # -------------------------------------------------------------- lifecycle
    def request_stop(self, drain: bool = True) -> None:
        """Ask the worker to exit.  ``drain=True`` consumes the queue, takes
        a final publish (and checkpoint, if configured), then stops.
        ``drain=False`` is a crash-like hard stop: in-queue and in-delta
        work is abandoned exactly as a SIGKILL would abandon it."""
        self._drain = drain
        self._stop_event.set()
        if not drain:
            self.queue.close()

    def run(self) -> None:  # thread body
        self.state = RUNNING
        self.metrics.note_started(time.monotonic())
        try:
            while True:
                item = self._held
                if item is not None:
                    self._held = None  # byte-cap holdover leads this group
                else:
                    item = self.queue.get(timeout=self.poll_s)
                now = time.monotonic()
                if item is None:
                    if self._stop_event.is_set():
                        if not self._drain or self.queue.depth() == 0:
                            break
                        self.state = DRAINING
                        continue
                    # idle tick: wall-clock policies may still want to
                    # surface a lingering delta as a fresh epoch
                    if self._should_publish(now):
                        self._publish()
                    continue
                if self._stop_event.is_set() and not self._drain:
                    break  # hard stop: abandon the item, like a crash would
                if self._stop_event.is_set():
                    self.state = DRAINING
                items = [item]
                total = item.src.shape[0]
                group_bytes = _item_nbytes(item)
                while (len(items) < self.coalesce_batches
                       and total < self.coalesce_target):
                    nxt = self.queue.get(timeout=0)  # opportunistic, no wait
                    if nxt is None:
                        break
                    if group_bytes + _item_nbytes(nxt) \
                            > self._coalesce_byte_cap:
                        self._held = nxt  # caps the dispatch; never dropped
                        break
                    items.append(nxt)
                    total += nxt.src.shape[0]
                    group_bytes += _item_nbytes(nxt)
                if len(items) == 1 and not self.dedup:
                    self._ingest(item, now)
                else:
                    self._ingest_coalesced(items, now)
                if self._should_publish(time.monotonic()):
                    self._publish()
                if (self.checkpoint_dir and self.checkpoint_every
                        and self._batches_since_checkpoint
                        >= self.checkpoint_every):
                    self.checkpoint()
            if self._drain:
                # graceful exit: surface everything ingested, then persist.
                # Gate on the buffer's actual pending count, not just this
                # run's batch counter: a restored checkpoint can carry a
                # non-empty delta even when no new batch arrived (stream
                # already exhausted), and it must still reach an epoch.
                if (self.metrics.pending_batches()
                        or self.tenant.buffer.pending_edges):
                    self._publish()
                if self.checkpoint_dir:
                    self.checkpoint()
            self.state = STOPPED
        except BaseException as exc:
            # don't re-raise: a dying thread would only reach
            # threading.excepthook; the supervisor reads state/error instead
            # (and Runtime.stop() re-raises it to drain callers)
            self.error = exc
            self.error_tb = "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__))
            self.state = FAILED

    # ----------------------------------------------------------------- ingest
    def _note_dispatch(self, item: QueueItem) -> None:
        if not item.trace_id:
            return
        self._trace.emit(item.trace_id, "ingest", "dispatch",
                         offset=item.offset, n_edges=item.n_edges,
                         tenant=self.tenant.key.tenant_id)
        if len(self._pending_traces) < 256:
            self._pending_traces.append(item.trace_id)

    def _ingest(self, item: QueueItem, now: float) -> None:
        # a pageable copy: it completes before from_numpy returns, so the
        # item's arrays are free as soon as it does
        batch = EdgeBatch.from_numpy(item.src, item.dst, item.weight,
                                     device=self.tenant.buffer.device)
        self._note_dispatch(item)
        with self._state_lock:
            with profile_span("ingest"):
                self.tenant.buffer.ingest(batch)
            if self.reservoir is not None:
                self.reservoir.offer_batch(item.src, item.dst, item.weight)
            if item.offset >= 0:
                # externally submitted batches carry offset -1: they are not
                # part of the seekable stream, so they must not move the
                # stream cursor (checkpoint replay would double-count)
                self._ingested_offset = item.offset
                self.tenant.offset = item.offset + 1
        self.metrics.note_ingest(item.n_edges, now)
        self._batches_since_checkpoint += 1

    def _claim_stage(self, bucket: int):
        """Borrow a host staging column set of >= ``bucket`` rows
        (ping-pong): three int32 tensors (pinned for a buffer on the card)
        and their numpy views.

        A copy from pinned memory runs asynchronously, so a slot is only
        safe to refill after the dispatch that read it has run — the fence
        ``_fence_stage`` captured.  The wait here only bites when the card
        falls a full two dispatches behind the host.
        """
        slot = self._stage_idx
        self._stage_idx ^= 1
        fence = self._stage_fence[slot]
        if fence is not None:
            fence.synchronize()
            self._stage_fence[slot] = None
        bufs = self._stage[slot]
        if bufs is None or bufs[0].shape[0] < bucket:
            cols = tuple(torch.zeros(bucket, dtype=torch.int32,
                                     pin_memory=self._pinned)
                         for _ in range(3))
            bufs = (*(c.numpy() for c in cols), cols)
            self._stage[slot] = bufs
        return slot, bufs

    def _fence_stage(self, slot: int) -> None:
        # recorded by the buffer after this group's ingest, on the stream
        # that ran its copy (the device's current stream)
        self._stage_fence[slot] = self.tenant.buffer.dispatch_token()

    def _ingest_coalesced(self, items: list[QueueItem], now: float) -> None:
        """Fold several queued items into ONE buffer ingest dispatch.

        Exactness is unaffected: sketch deltas are additive and order-free,
        the reservoir still sees items in FIFO order (raw, pre-dedup), and
        the whole group lands in the delta atomically under the state lock,
        so the offset cursor can jump straight to the newest seekable batch
        (FIFO: the last item is the newest) without ever describing a state
        the counters do not hold.  Padded to a coarse ladder
        (``coalesce_target/4`` granule) so coalesced shapes stay few.

        With ``dedup`` on, the group is pre-aggregated on (src, dst) first
        (``preaggregate_edges``) and the pending ledger takes the host-side
        raw weight>0 count instead of the device count.
        """
        n_raw = sum(it.src.shape[0] for it in items)
        count = None
        if self.dedup:
            if len(items) == 1:
                rs, rd, rw = items[0].src, items[0].dst, items[0].weight
            else:
                rs = np.concatenate([np.asarray(it.src) for it in items])
                rd = np.concatenate([np.asarray(it.dst) for it in items])
                rw = np.concatenate([np.asarray(it.weight) for it in items])
            raw_live = int(np.count_nonzero(np.asarray(rw)))
            usrc, udst, uw = preaggregate_edges(rs, rd, rw)
            n = usrc.shape[0]
            count = sum(it.n_edges for it in items)
        else:
            n = n_raw
        granule = max(256, self.coalesce_target // 4)
        bucket = max(granule, -(-n // granule) * granule)
        # pre-sized int32 staging per column, filled by slicing: the slice
        # assignment does the cast AND the copy, and the zero tail is the
        # weight-0 padding
        slot, (src, dst, weight, cols) = self._claim_stage(bucket)
        if self.dedup:
            src[:n] = usrc
            dst[:n] = udst
            weight[:n] = uw
        else:
            pos = 0
            for it in items:
                end = pos + it.src.shape[0]
                src[pos:end] = it.src
                dst[pos:end] = it.dst
                weight[pos:end] = it.weight
                pos = end
        src[n:bucket] = 0
        dst[n:bucket] = 0
        weight[n:bucket] = 0
        device = self.tenant.buffer.device
        batch = EdgeBatch(*(c[:bucket].to(device, non_blocking=True)
                            for c in cols))
        for it in items:
            self._note_dispatch(it)
        with self._state_lock:
            with profile_span("ingest"):
                if count is None:
                    self.tenant.buffer.ingest(batch)
                else:
                    self.tenant.buffer.ingest(batch, count=count)
            self._fence_stage(slot)
            if self.reservoir is not None:
                for it in items:
                    self.reservoir.offer_batch(it.src, it.dst, it.weight)
            offsets = [it.offset for it in items if it.offset >= 0]
            if offsets:
                self._ingested_offset = offsets[-1]
                self.tenant.offset = offsets[-1] + 1
        for it in items:
            self.metrics.note_ingest(it.n_edges, now)
        if self.dedup:
            self.metrics.note_dedup(raw_live, n)
        self._batches_since_checkpoint += len(items)

    def _should_publish(self, now: float) -> bool:
        return self.policy.should_publish(
            batches_since_publish=self.metrics.pending_batches(),
            now=now, queue_depth=self.queue.depth())

    def _publish(self):
        t0 = time.monotonic()
        snap = self.tenant.publish()
        now = time.monotonic()
        self.metrics.note_publish(now - t0, now)
        self.policy.note_published(now)
        for tid in self._pending_traces:
            self._trace.emit(tid, "ingest", "publish", epoch=snap.epoch,
                             tenant=self.tenant.key.tenant_id)
        self._pending_traces.clear()
        if self.on_publish is not None:
            self.on_publish(snap)
        return snap

    # ------------------------------------------------------------- checkpoint
    def checkpoint(self) -> str:
        """Write a crash-safe checkpoint of the tenant's full ingest state.

        Callable from any thread.  Captures (front, delta, pending,
        reservoir, next stream offset) as ONE consistent cut under
        ``_state_lock``: the buffer's ``state()`` hands out the front (never
        written again) and private copies of the delta and the pending
        count, and the reservoir is copied out inside the lock, so writing
        the files happens outside it.
        """
        if not self.checkpoint_dir:
            raise ValueError("worker has no checkpoint_dir configured")
        with self._state_lock:
            buf = self.tenant.buffer.state()
            next_offset = self._ingested_offset + 1
            res = (self.reservoir.state_dict()
                   if self.reservoir is not None else None)
        state = {"front": buf["front"], "delta": buf["delta"],
                 "pending": buf["pending"]}
        extra = {
            "tenant_id": self.tenant.key.tenant_id,
            "epoch": buf["epoch"],
            "n_edges": buf["n_edges"],
            "next_offset": next_offset,
        }
        if res is not None:
            state["reservoir"] = {"src": res["src"], "dst": res["dst"],
                                  "w": res["w"]}
            extra["reservoir"] = {"k": res["k"], "seen": res["seen"],
                                  "rng_state": res["rng_state"]}
        path = store.save(self.checkpoint_dir, next_offset, state, extra=extra)
        self._batches_since_checkpoint = 0
        self.metrics.note_checkpoint(time.monotonic())
        return path

    # ---------------------------------------------------------------- reports
    @property
    def ingested_edges(self) -> int:
        """Backend-neutral accessor (runtime/backend.py contract): total
        non-padding edges this worker has folded into the delta."""
        return self.metrics.total_edges()

    def wait_ready(self, timeout: float = 0.0) -> bool:
        """Backend-neutral readiness barrier: a thread worker shares the
        parent's address space and kernels, so it is ready the moment it
        exists."""
        return True

    def health(self) -> dict:
        return {
            "state": self.state,
            "alive": self.is_alive(),
            "error": repr(self.error) if self.error else None,
            "epoch": self.tenant.epoch,
            "ingested_offset": self._ingested_offset,
            "queue_depth": self.queue.depth(),
        }

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot(
            queue_stats=self.queue.stats(),
            state=self.state,
            epoch=self.tenant.epoch,
            overflow_edges=getattr(self.tenant.buffer, "overflow_edges", 0))


def restore_worker_state(tenant, checkpoint_dir: str,
                         reservoir: Reservoir | None = None,
                         step: int | None = None) -> dict:
    """Load the latest (or ``step``) checkpoint back into a *fresh* tenant.

    The tenant must come from an identically-configured registry (same key,
    depth, batch size, scale): the checkpoint stores counter state, not
    layout, and ``store.restore`` checks shape agreement leaf by leaf.
    Returns the checkpoint metadata; after this call a worker/pump pair
    resumes from ``tenant.offset`` and reproduces a never-crashed run
    bit-exactly (streams are seekable, counters additive).
    """
    # identity check BEFORE touching arrays: a foreign tenant's checkpoint
    # must fail loudly on identity, not incidentally on layout shapes
    probe = store.read_meta(checkpoint_dir, step=step)["extra"]
    if probe.get("tenant_id") != tenant.key.tenant_id:
        raise ValueError(
            f"checkpoint belongs to tenant {probe.get('tenant_id')!r}, "
            f"not {tenant.key.tenant_id!r}")
    buf = tenant.buffer.state()
    template = {"front": buf["front"], "delta": buf["delta"],
                "pending": buf["pending"]}
    if reservoir is not None:
        template["reservoir"] = {"src": reservoir._src, "dst": reservoir._dst,
                                 "w": reservoir._w}
    state, meta = store.restore(checkpoint_dir, template, step=step)
    extra = meta["extra"]
    tenant.buffer.load_state({
        "front": state["front"], "delta": state["delta"],
        "pending": state["pending"], "epoch": extra["epoch"],
        "n_edges": extra["n_edges"],
    })
    tenant.offset = int(extra["next_offset"])
    if reservoir is not None:
        if "reservoir" not in state:
            raise ValueError("checkpoint has no reservoir state")
        res_extra = extra["reservoir"]
        reservoir.load_state_dict({
            "k": res_extra["k"], "seen": res_extra["seen"],
            "rng_state": res_extra["rng_state"],
            "src": state["reservoir"]["src"],
            "dst": state["reservoir"]["dst"],
            "w": state["reservoir"]["w"],
        })
    return meta
