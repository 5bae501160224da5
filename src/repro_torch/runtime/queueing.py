"""Bounded edge-batch queues with explicit backpressure (DESIGN.md §Runtime).

A copy of the JAX package's ``runtime/queueing.py`` (numpy only): the port
keeps its own so that it never imports ``repro``.  Its spill files are the
same bytes — one columnar ``item_cols`` frame of the JAX package's wire
codec (``net/wire.py``, schema v3) per batch — written and read by the
frame codec below, the one part of that codec the queue needs.

# analysis: hot-path — every queued batch flows through here; the
# no-pickle-hot-path rule keeps serialization out of this module.

The queue is the contract between a stream producer (``StreamPump`` or an
external ``Runtime.submit`` caller) and a tenant's ``IngestWorker``.  It is
*bounded* on purpose: an unbounded queue turns a slow ingest path into
unbounded memory growth and hides overload.  When full, one of three
policies applies:

  block        the producer waits (lossless; producer-paced — the default)
  drop_oldest  the oldest queued batch is evicted and *accounted* (bounded
               staleness under overload; never silent — ``dropped_edges``
               feeds the runtime's conservation report)
  spill        overflow batches go to an on-disk FIFO and are read back in
               order as the consumer catches up (lossless and non-blocking,
               at the price of disk I/O — which happens outside the queue
               lock, so producer and consumer never serialize on the disk)

Items are host-side numpy triples, not device arrays: they are cheap to
drop, cheap to spill, and the worker converts to an ``EdgeBatch`` only at
ingest time.  FIFO order is preserved by every policy (for spill, once an
overflow batch is on disk all younger puts spill too until the disk FIFO
drains — in-memory items are always older than spilled ones).
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
from collections import deque

import numpy as np

# the JAX package's wire frame header and v3 columnar item payload
# (big-endian): magic, schema version, frame type, payload length; then
# offset(i64) n_edges(i64) | n_src n_dst n_weight (u32) | three dtype tags
# (8s) | trace_len(u16) | trace_id utf-8 | src, dst, weight bytes
_MAGIC = b"KMTX"
_WIRE_VERSION = 3
_ITEM_COLS_TYPE = 12
_HEADER = struct.Struct(">4sHHI")
_ITEM_COLS = struct.Struct(">qqIII8s8s8sH")
_COL_KINDS = frozenset("iuf")  # fixed-width int/float columns only


class SpillFrameError(ValueError):
    """A spill file is not one well-formed columnar item frame."""


def _col_dtype(tag: bytes, what: str) -> np.dtype:
    try:
        dt = np.dtype(tag.rstrip(b"\x00").decode("ascii"))
    except (TypeError, ValueError, UnicodeDecodeError) as exc:
        raise SpillFrameError(
            f"item frame carries undecodable {what} dtype {tag!r}") from exc
    if dt.kind not in _COL_KINDS or not 1 <= dt.itemsize <= 8:
        raise SpillFrameError(
            f"item frame carries disallowed {what} dtype {dt.str!r}")
    return dt


def encode_item_frame(item) -> bytes:
    """One ``QueueItem`` as the JAX wire codec's v3 ``item_cols`` frame
    (columns in their native dtype)."""
    cols = []
    for what in ("src", "dst", "weight"):
        a = np.ascontiguousarray(getattr(item, what))
        if a.ndim != 1 or a.dtype.kind not in _COL_KINDS \
                or not 1 <= a.dtype.itemsize <= 8:
            raise SpillFrameError(
                f"column {what} ({a.dtype.str}, shape {a.shape}) cannot be "
                "framed: 1-D fixed-width int/float columns only")
        cols.append(a)
    src, dst, weight = cols
    trace = str(item.trace_id or "").encode("utf-8")
    if len(trace) > 0xFFFF:
        raise SpillFrameError(f"trace_id of {len(trace)} bytes exceeds 65535")
    length = (_ITEM_COLS.size + len(trace)
              + src.nbytes + dst.nbytes + weight.nbytes)
    return b"".join((
        _HEADER.pack(_MAGIC, _WIRE_VERSION, _ITEM_COLS_TYPE, length),
        _ITEM_COLS.pack(int(item.offset), int(item.n_edges),
                        src.size, dst.size, weight.size,
                        *(c.dtype.str.encode("ascii").ljust(8, b"\x00")
                          for c in cols), len(trace)),
        trace, src.data, dst.data, weight.data))


def decode_item_frame(buf: bytes) -> tuple:
    """Inverse of :func:`encode_item_frame`: ``(offset, src, dst, weight,
    n_edges, trace_id)``, the columns views over ``buf``; loud on
    any header, length or dtype disagreement."""
    if len(buf) < _HEADER.size + _ITEM_COLS.size:
        raise SpillFrameError(f"truncated item frame ({len(buf)} bytes)")
    magic, version, ftype, length = _HEADER.unpack_from(buf)
    if (magic, version, ftype) != (_MAGIC, _WIRE_VERSION, _ITEM_COLS_TYPE):
        raise SpillFrameError(
            f"not a v{_WIRE_VERSION} columnar item frame: magic {magic!r}, "
            f"version {version}, type {ftype}")
    body = memoryview(buf)[_HEADER.size:]
    if len(body) != length:
        raise SpillFrameError(f"truncated item frame: header promises "
                              f"{length} payload bytes, got {len(body)}")
    (offset, n_edges, n_src, n_dst, n_weight,
     dt_src, dt_dst, dt_weight, trace_len) = _ITEM_COLS.unpack_from(body)
    if not n_src == n_dst == n_weight:
        raise SpillFrameError(f"item frame has ragged columns: src={n_src} "
                              f"dst={n_dst} weight={n_weight}")
    if not 0 <= n_edges <= n_src:
        raise SpillFrameError(f"item frame claims {n_edges} non-padding "
                              f"edges in {n_src}-row columns")
    dts = [_col_dtype(t, w) for t, w in ((dt_src, "src"), (dt_dst, "dst"),
                                         (dt_weight, "weight"))]
    pos = _ITEM_COLS.size
    if pos + trace_len + sum(n_src * d.itemsize for d in dts) != len(body):
        raise SpillFrameError("item frame length disagrees with its columns")
    try:
        trace = bytes(body[pos:pos + trace_len]).decode("utf-8")
    except UnicodeDecodeError as exc:
        raise SpillFrameError("undecodable trace_id bytes") from exc
    pos += _HEADER.size + trace_len
    cols = []
    for dt in dts:
        cols.append(np.frombuffer(buf, dtype=dt, count=n_src, offset=pos))
        pos += n_src * dt.itemsize
    return int(offset), *cols, int(n_edges), trace


BLOCK = "block"
DROP_OLDEST = "drop_oldest"
SPILL = "spill"
BACKPRESSURE_POLICIES = (BLOCK, DROP_OLDEST, SPILL)


@dataclasses.dataclass
class QueueItem:
    """One stream batch in flight: seekable offset + host-side arrays."""

    offset: int
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    n_edges: int  # non-padding updates (weight > 0), precomputed once
    # span ID minted at enqueue (repro_torch.obs.trace); rides queues, spills,
    # and v2 wire `item` frames so the batch's enqueue -> dispatch ->
    # publish -> adopt chain is reconstructable on any backend
    trace_id: str = ""

    @staticmethod
    def from_arrays(offset: int, src: np.ndarray, dst: np.ndarray,
                    weight: np.ndarray, trace_id: str = "") -> "QueueItem":
        return QueueItem(offset, src, dst, weight,
                         n_edges=int(np.count_nonzero(weight > 0)),
                         trace_id=trace_id)


class BoundedEdgeQueue:
    """Thread-safe bounded FIFO of ``QueueItem`` with a backpressure policy."""

    def __init__(self, capacity: int, policy: str = BLOCK,
                 spill_dir: str | None = None) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if policy not in BACKPRESSURE_POLICIES:
            raise ValueError(f"unknown backpressure policy {policy!r}; "
                             f"choose from {BACKPRESSURE_POLICIES}")
        if policy == SPILL and not spill_dir:
            raise ValueError("spill policy requires spill_dir")
        self.capacity = capacity
        self.policy = policy
        self.spill_dir = spill_dir
        self.stale_spills_removed = 0
        if policy == SPILL:
            os.makedirs(spill_dir, exist_ok=True)
            # A fresh queue reusing a crashed run's spill_dir must never
            # confuse that run's leftovers with its own slots: slot indices
            # restart at 0, so a stale file could sit at a path this queue
            # is about to reserve.  The slot-ready events make reads safe
            # within one queue lifetime, but stale files are dead weight at
            # best and a hazard if the numbering scheme ever changes —
            # purge them (and any torn .tmp writes) up front, accounted.
            for name in os.listdir(spill_dir):
                if name.startswith("spill_"):
                    os.remove(os.path.join(spill_dir, name))
                    self.stale_spills_removed += 1
        self._items: deque[QueueItem] = deque()  # guarded-by: _cv
        self._cv = threading.Condition()
        self._closed = False  # guarded-by(writes): _cv
        # disk FIFO indices: slots [_spill_head, _spill_tail) are reserved;
        # _spill_ready[i] is set once slot i's file is actually on disk
        # (reservation happens under the lock, file I/O outside it)
        self._spill_head = 0  # guarded-by: _cv
        self._spill_tail = 0  # guarded-by: _cv
        self._spill_ready: dict[int, threading.Event] = {}
        self.accepted_batches = 0  # guarded-by: _cv
        self.accepted_edges = 0  # guarded-by: _cv
        self.dropped_batches = 0  # guarded-by: _cv
        self.dropped_edges = 0  # guarded-by: _cv
        self.spilled_batches = 0  # guarded-by: _cv
        self.max_depth_seen = 0  # guarded-by: _cv

    # ------------------------------------------------------------------ spill
    def _spill_path(self, idx: int) -> str:
        # .kmx: one v3 columnar item frame (the wire codec's), verbatim — the
        # spill FIFO and the transports share a single codec, so a spilled
        # batch costs one buffer concat down and one frombuffer view up
        return os.path.join(self.spill_dir, f"spill_{idx:012d}.kmx")

    def _spill_write(self, idx: int, item: QueueItem) -> None:
        """File I/O for reserved slot ``idx`` — called OUTSIDE the lock.

        tmp + rename so a producer crash mid-write leaves a recognizable
        ``.tmp`` orphan (purged by the next queue on this dir), never a
        torn file at the slot's final path.
        """
        path = self._spill_path(idx)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(encode_item_frame(item))
        os.replace(tmp, path)

    def _spill_read(self, idx: int) -> QueueItem:
        """File I/O for claimed slot ``idx`` — called OUTSIDE the lock."""
        path = self._spill_path(idx)
        # read into writable memory: torch refuses to alias read-only numpy
        # columns without a warning when a batch is made from them
        data = bytearray(os.path.getsize(path))
        with open(path, "rb") as f:
            f.readinto(data)
        # zero-copy: the decoded columns are views over `data`, which the
        # QueueItem keeps alive; a torn/garbled file raises SpillFrameError
        offset, src, dst, weight, n_edges, trace_id = decode_item_frame(data)
        item = QueueItem(offset, src, dst, weight, n_edges,
                         trace_id=trace_id)
        os.remove(path)
        return item

    @property
    def _spill_pending(self) -> int:  # requires-lock: _cv
        return self._spill_tail - self._spill_head

    # -------------------------------------------------------------- interface
    @property
    def closed(self) -> bool:
        return self._closed

    def depth(self) -> int:
        """Batches waiting (in memory + spilled) — the worker's ingest lag."""
        with self._cv:
            return len(self._items) + self._spill_pending

    def put(self, item: QueueItem, timeout: float | None = None) -> bool:
        """Enqueue under the backpressure policy.

        Returns True iff the item was accepted (queued or spilled).  ``block``
        may return False on timeout or close; the other policies always
        accept unless the queue is closed.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        spill_idx = None
        spill_done = None
        with self._cv:
            if self.policy == BLOCK:
                while (not self._closed and len(self._items) >= self.capacity):
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            return False
                    self._cv.wait(timeout=remaining if remaining is not None
                                  else 0.1)
                if self._closed:
                    return False
                self._items.append(item)
            elif self.policy == DROP_OLDEST:
                if self._closed:
                    return False
                if len(self._items) >= self.capacity:
                    victim = self._items.popleft()
                    self.dropped_batches += 1
                    self.dropped_edges += victim.n_edges
                self._items.append(item)
            else:  # SPILL
                if self._closed:
                    return False
                if len(self._items) >= self.capacity or self._spill_pending:
                    # reserve a slot only; the np.savez happens outside the
                    # lock so the consumer keeps dequeuing during disk I/O
                    spill_idx = self._spill_tail
                    self._spill_tail += 1
                    # keep a local ref: a fast consumer may claim the slot
                    # (popping the dict entry) before the write finishes
                    spill_done = threading.Event()
                    self._spill_ready[spill_idx] = spill_done
                    self.spilled_batches += 1
                else:
                    self._items.append(item)
            self.accepted_batches += 1
            self.accepted_edges += item.n_edges
            self.max_depth_seen = max(self.max_depth_seen,
                                      len(self._items) + self._spill_pending)
            self._cv.notify_all()
        if spill_idx is not None:
            self._spill_write(spill_idx, item)
            spill_done.set()
        return True

    def get(self, timeout: float | None = None) -> QueueItem | None:
        """Dequeue the oldest item; None on timeout or when closed and empty."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._items and not self._spill_pending:
                if self._closed:
                    return None
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                self._cv.wait(timeout=remaining if remaining is not None
                              else 0.1)
            if self._items:
                item = self._items.popleft()
                self._cv.notify_all()
                return item
            # claim the oldest spill slot under the lock; read it outside
            # (FIFO holds: in-memory items are always older than spilled
            # ones, and puts keep spilling while any slot is outstanding)
            idx = self._spill_head
            self._spill_head += 1
            ready = self._spill_ready.pop(idx)
            self._cv.notify_all()
        if not ready.wait(timeout=60.0):  # producer died mid-write
            raise RuntimeError(f"spill slot {idx} was reserved but never "
                               "written (producer failed mid-spill)")
        return self._spill_read(idx)

    def close(self) -> None:
        """Wake every blocked producer/consumer; further puts are refused.

        Closing does NOT discard queued work: in-memory items and pending
        spilled batches stay drainable through ``get()`` until the queue is
        empty (only then does ``get`` return None), so a drain-after-close
        conserves every accepted edge — the disk FIFO is part of the queue,
        not a side channel.  Anything left undrained remains visible in
        ``stats()`` (``depth`` / ``spill_pending``), never silently lost.
        """
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def stats(self) -> dict:
        with self._cv:
            return {
                "depth": len(self._items) + self._spill_pending,
                "accepted_batches": self.accepted_batches,
                "accepted_edges": self.accepted_edges,
                "dropped_batches": self.dropped_batches,
                "dropped_edges": self.dropped_edges,
                "spilled_batches": self.spilled_batches,
                "spill_pending": self._spill_pending,
                "stale_spills_removed": self.stale_spills_removed,
                "max_depth_seen": self.max_depth_seen,
            }
