"""Execution backends: where an ingest worker's write path runs.

The thread half of the JAX package's ``runtime/backend.py``.  The runtime's
worker/queue contract is transport-agnostic: the supervisor, publish
policies, metrics, backpressure accounting and crash/restore logic are
written against ``ExecutionBackend`` and the worker handle it makes.

``ThreadBackend`` runs each worker as an ``IngestWorker`` thread sharing
the parent's sketch buffer: publication is a reference swap.  The JAX
package's process and socket backends (spawn children owning their
sketches, workers across TCP) ride on its wire codec and are not ported
yet (ROADMAP item 12): ``resolve_backend`` refuses them by name.
"""
from __future__ import annotations

from repro_torch.runtime.policies import make_policy
from repro_torch.runtime.queueing import BoundedEdgeQueue
from repro_torch.runtime.worker import IngestWorker

_BACKEND_NAMES = ("thread", "process", "socket")
_LATER = ("the {!r} runtime backend is not ported yet (ROADMAP item 12, "
          "with the network tier); use the thread backend")


class WorkerFailure(RuntimeError):
    """One or more ingest workers died; carries the original tracebacks.

    Raised by ``Runtime.stop()`` (and drain callers) so failures surface at
    the call site instead of only via ``health()`` polling.  ``failures``
    is a list of ``{"tenant_id", "error", "traceback"}`` dicts; ``report``
    holds the final per-tenant accounting gathered before raising, so a
    caller that catches this still sees the conservation numbers.
    """

    def __init__(self, failures: list, report: dict | None = None) -> None:
        self.failures = failures
        self.report = report
        lines = []
        for f in failures:
            lines.append(f"worker {f['tenant_id']} failed: {f['error']}")
            if f.get("traceback"):
                lines.append(f["traceback"].rstrip())
        super().__init__("\n".join(lines) or "worker failure")


class ExecutionBackend:
    """Factory for worker handles honouring the backend contract.

    A worker handle must expose the surface ``Runtime``/``TenantRuntime``
    program against: ``start / request_stop(drain) / join / is_alive``,
    ``state`` (created/running/draining/stopped/failed), ``error`` +
    ``error_tb``, ``base_edges``, ``ingested_edges``, ``wait_ready``,
    ``health()``, ``metrics_snapshot()``, ``checkpoint()`` and the parent
    ``queue`` it consumes from.
    """

    name: str = ""
    remote: bool = False  # worker's sketch state lives outside this process

    def make_worker(self, tenant, queue: BoundedEdgeQueue, policy, *,
                    reservoir=None, checkpoint_dir: str | None = None,
                    checkpoint_every: int = 0, on_publish=None,
                    poll_s: float = 0.05, coalesce_batches: int = 1,
                    coalesce_target: int = 8192, queue_capacity: int = 64,
                    dedup: bool = False):
        raise NotImplementedError

    def shutdown(self) -> None:
        """Release backend-owned transport resources.  ``Runtime.stop()`` and
        ``kill()`` call this BEFORE joining workers.  Idempotent; the thread
        backend owns none."""


class ThreadBackend(ExecutionBackend):
    """In-process worker threads over the shared snapshot buffer."""

    name = "thread"
    remote = False

    def make_worker(self, tenant, queue, policy, *, reservoir=None,
                    checkpoint_dir=None, checkpoint_every=0, on_publish=None,
                    poll_s=0.05, coalesce_batches=1, coalesce_target=8192,
                    queue_capacity=64, dedup=False):
        return IngestWorker(
            tenant, queue, make_policy(policy), reservoir=reservoir,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            on_publish=on_publish, poll_s=poll_s,
            coalesce_batches=coalesce_batches,
            coalesce_target=coalesce_target, dedup=dedup)


def resolve_backend(spec) -> ExecutionBackend:
    """``"thread"`` (or None) | a ready ``ExecutionBackend``.  ``"process"``
    and ``"socket[:HOST:PORT,...]"`` raise ``NotImplementedError`` naming
    the ROADMAP item that ports them."""
    if isinstance(spec, ExecutionBackend):
        return spec
    if spec == "thread" or spec is None:
        return ThreadBackend()
    if spec == "process" or (isinstance(spec, str) and (
            spec == "socket" or spec.startswith("socket:"))):
        raise NotImplementedError(_LATER.format(spec))
    raise ValueError(f"unknown runtime backend {spec!r}; "
                     f"choose from {_BACKEND_NAMES}")
