"""Pluggable snapshot-publish policies for ingest workers.

A copy of the JAX package's ``runtime/policies.py`` (pure Python): the
port keeps its own so that it never imports ``repro``.

A worker folds queue batches into its tenant's delta sketch; *when* the
delta is folded into the published snapshot (a new epoch) is a policy
decision with a real trade-off: frequent publishes minimize staleness but
thrash every per-(tenant, epoch) cache downstream (notably the engine's
closure cache); rare publishes serve stale counters.  Three policies:

  every:N      publish after N ingested batches (throughput-paced; the
               cooperative serving loop's behaviour, now per worker)
  interval:S   publish at most every S wall-clock seconds (staleness-paced;
               publishes happen on idle ticks too, so a quiet stream still
               surfaces its last batches)
  drain[:W]    publish when the queue depth falls to the watermark W
               (default 0) — epochs align with bursts, so a backlogged
               worker does one big fold instead of many small ones.  A
               ``max_batches`` backstop bounds staleness under sustained
               overload where the queue never drains.

Policies are tiny stateful objects owned by ONE worker thread each; the
worker consults ``should_publish`` after every ingested batch and on idle
ticks, and calls ``note_published`` after each publish.
"""
from __future__ import annotations

import time
from typing import Callable


class PublishPolicy:
    """Base class; subclasses decide when a worker publishes an epoch."""

    def note_published(self, now: float) -> None:
        """Called by the worker right after every publish."""

    def should_publish(self, *, batches_since_publish: int, now: float,
                       queue_depth: int) -> bool:
        raise NotImplementedError


class EveryNBatches(PublishPolicy):
    def __init__(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"every:N requires N >= 1, got {n}")
        self.n = n

    def should_publish(self, *, batches_since_publish: int, now: float,
                       queue_depth: int) -> bool:
        return batches_since_publish >= self.n


class WallClockInterval(PublishPolicy):
    def __init__(self, seconds: float,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if seconds <= 0:
            raise ValueError(f"interval:S requires S > 0, got {seconds}")
        self.seconds = seconds
        self._clock = clock
        self._last: float | None = None

    def note_published(self, now: float) -> None:
        self._last = now

    def should_publish(self, *, batches_since_publish: int, now: float,
                       queue_depth: int) -> bool:
        if batches_since_publish == 0:
            return False  # nothing pending; an empty publish is pure churn
        if self._last is None:
            self._last = now  # arm on first observation
            return False
        return (now - self._last) >= self.seconds


class QueueDrainWatermark(PublishPolicy):
    def __init__(self, watermark: int = 0, max_batches: int = 64) -> None:
        if watermark < 0:
            raise ValueError(f"drain:W requires W >= 0, got {watermark}")
        if max_batches < 1:
            raise ValueError(f"max_batches must be >= 1, got {max_batches}")
        self.watermark = watermark
        self.max_batches = max_batches

    def should_publish(self, *, batches_since_publish: int, now: float,
                       queue_depth: int) -> bool:
        if batches_since_publish == 0:
            return False
        return (queue_depth <= self.watermark
                or batches_since_publish >= self.max_batches)


def make_policy(spec: "str | PublishPolicy | Callable[[], PublishPolicy]"
                ) -> PublishPolicy:
    """Parse a policy spec: ``"every:4"``, ``"interval:0.5"``, ``"drain"``,
    ``"drain:2"``; also accepts a ready instance or a zero-arg factory."""
    if isinstance(spec, PublishPolicy):
        return spec
    if callable(spec):
        policy = spec()
        if not isinstance(policy, PublishPolicy):
            raise TypeError(f"policy factory returned {type(policy).__name__}")
        return policy
    name, _, arg = spec.partition(":")
    if name == "every":
        return EveryNBatches(int(arg or 4))
    if name == "interval":
        return WallClockInterval(float(arg))
    if name == "drain":
        return QueueDrainWatermark(int(arg or 0))
    raise ValueError(f"unknown publish policy spec {spec!r} "
                     "(expected every:N | interval:S | drain[:W])")
