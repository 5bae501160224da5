"""Bounded trace-span log: IDs minted at the edges, events everywhere.

A copy of the JAX package's ``obs/trace.py``, which imports neither JAX
nor numpy: the port keeps its own so that it never imports ``repro``.

A trace ID is minted once per unit of work — an edge batch at
ingest-enqueue (``QueueItem.from_arrays``) or a query at server accept —
and rides the existing plumbing: ``QueueItem.trace_id`` through queues
and spills, a new field on the wire codec's ``item`` frames (version 2),
and span-event lists inside publish/metrics beats coming back up.

Each process keeps one bounded ring (``get_trace_log()``).  Remote
workers ``drain()`` their ring into the beats they already send; the
parent ``absorb()``s, so one batch's enqueue -> dispatch -> publish ->
adopt chain (or a query's accept -> plan -> execute -> reply chain) is
reconstructable from a single JSONL dump regardless of transport.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any

from repro_torch.obs.hub import metrics_disabled

__all__ = ["new_trace_id", "TraceLog", "get_trace_log", "reset_trace_log"]

DEFAULT_CAPACITY = 4096


def new_trace_id() -> str:
    return os.urandom(8).hex()


class TraceLog:
    """Thread-safe bounded ring of span events."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self._events: deque[dict] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._emitted = 0

    def emit(self, trace_id: str, span: str, event: str,
             **attrs: Any) -> None:
        if not trace_id or metrics_disabled():
            return
        rec = {"ts": time.time(), "trace": trace_id, "span": span,
               "event": event}
        if attrs:
            rec.update(attrs)
        with self._lock:
            self._events.append(rec)
            self._emitted += 1

    def absorb(self, events) -> None:
        """Fold a batch of remote events (from a drained child ring)."""
        if not events:
            return
        with self._lock:
            for rec in events:
                if isinstance(rec, dict) and rec.get("trace"):
                    self._events.append(rec)
                    self._emitted += 1

    def drain(self) -> list[dict]:
        """Remove and return everything buffered (child -> beat path)."""
        with self._lock:
            out = list(self._events)
            self._events.clear()
            return out

    def events(self, trace_id: str | None = None) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        if trace_id is None:
            return evs
        return [e for e in evs if e["trace"] == trace_id]

    def chain(self, trace_id: str) -> list[str]:
        """The ordered event names seen for one trace."""
        return [e["event"] for e in self.events(trace_id)]

    def dump_jsonl(self, path: str) -> int:
        """Append-write current events as JSONL; returns lines written."""
        evs = self.events()
        with open(path, "a") as fh:
            for rec in evs:
                fh.write(json.dumps(rec, default=str) + "\n")
        return len(evs)

    @property
    def emitted(self) -> int:
        return self._emitted

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


_GLOBAL: TraceLog | None = None
_GLOBAL_LOCK = threading.Lock()


def get_trace_log() -> TraceLog:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = TraceLog()
        return _GLOBAL


def reset_trace_log() -> TraceLog:
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = TraceLog()
        return _GLOBAL
