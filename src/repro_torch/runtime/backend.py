"""Execution backends: where an ingest worker's write path runs.

The JAX package's ``runtime/backend.py`` on the port.  The runtime's
worker/queue contract (DESIGN.md §Runtime §Backends) is
transport-agnostic.  Everything the supervisor, publish policies, metrics,
backpressure accounting and crash/restore logic need crosses exactly two
seams:

  inward   the serialized edge-batch stream: ``QueueItem``s pulled from the
           tenant's parent-side ``BoundedEdgeQueue`` (so ALL backpressure
           policies — block / drop-oldest / spill — and their drop/spill
           accounting live in one place regardless of backend);
  outward  epoch-stamped snapshot publication: the full published state
           (sketch leaves + counters + reservoir arrays/RNG + stream
           offset cursor), adopted into the parent's ``SnapshotBuffer`` so
           queries always serve from the parent's address space.

``ThreadBackend`` runs each worker as an ``IngestWorker`` thread sharing
the parent's sketch buffer: publication is a reference swap.

``ProcessBackend`` runs the same ``IngestWorker`` code in a spawn child
(never fork: the parent has a CUDA context and threads) that OWNS its
sketch: the child rebuilds the tenant from its registry-stamped
``TenantOrigin`` (deterministic, so the layout is identical) on the
parent's device, with its own CUDA context, loads the parent's buffer
state shipped at spawn as numpy leaves (warm prefix or restored
checkpoint — restore runs once, parent-side), folds transported batches
in its own interpreter (no GIL shared with K-1 sibling shards or the
query path), and ships every published epoch back over a FIFO result
pipe.  A publish leaves the child's card as numpy leaves
(``interop.tree_leaves``; the read synchronises the child's stream) and
is copied up to the parent's and folded into a fresh front by ``merge``
(``SnapshotBuffer.adopt_published``): no published front is written
again.  Checkpoints are written by the child through the same
``checkpoint/store`` path a thread worker uses, so thread- and
process-written checkpoints are interchangeable.  The kernels are built
in the parent before any child starts, so no child runs ``nvcc``.

Ordering guarantees the parent relies on: the item pipe and the result
pipe are both FIFO, publishes are emitted in epoch order from a single
writer thread, and the terminal ``stopped`` message is sent only after the
child worker joined — so when ``join()`` returns, every published epoch
(including the final drain publish) has been adopted.

``SocketBackend`` (``repro_torch.net.backend``, resolved via ``"socket"``)
runs the exact same worker loop — ``run_ingest_worker`` below — across a
TCP connection instead of a multiprocessing pipe; both transports frame
every message with the shared ``repro_torch.net.wire`` codec (the JAX
package's frames, so either package's parent drives the other's worker),
so a version skew or a torn stream fails loudly instead of as a pickle
crash.

No fallback: a worker asked to run on the card where there is none fails
its session (``failed``), and the parent raises ``WorkerFailure``.
"""
from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import queue as queue_mod
import signal
import sys
import threading
import time

import numpy as np
import torch

from repro_torch.interop import tree_leaves, tree_unflatten
from repro_torch.net import wire
from repro_torch.obs.hub import get_hub
from repro_torch.obs.trace import get_trace_log
from repro_torch.runtime.metrics import WorkerMetrics
from repro_torch.runtime.policies import make_policy
from repro_torch.runtime.queueing import BoundedEdgeQueue, QueueItem
from repro_torch.runtime.worker import (
    CREATED,
    DRAINING,
    FAILED,
    RUNNING,
    STOPPED,
    IngestWorker,
)

_BACKEND_NAMES = ("thread", "process", "socket")


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
        """Release backend-owned transport resources (listeners, dialers).

        ``Runtime.stop()``/``kill()`` call this BEFORE joining workers so a
        worker wedged in accept/connect (a peer that never dialed back, a
        host that never came up) is cut loose instead of hanging the join.
        Idempotent; the thread and process backends own no transport state.
        """


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
    """``"thread"`` | ``"process"`` | ``"socket[:HOST:PORT,...]"`` | a ready
    ``ExecutionBackend``."""
    if isinstance(spec, ExecutionBackend):
        return spec
    if spec == "thread" or spec is None:
        return ThreadBackend()
    if spec == "process":
        return ProcessBackend()
    if isinstance(spec, str) and (spec == "socket"
                                  or spec.startswith("socket:")):
        # lazy: repro_torch.net.backend imports back into this module
        from repro_torch.net.backend import SocketBackend

        return SocketBackend.from_spec(spec)
    raise ValueError(f"unknown runtime backend {spec!r}; "
                     f"choose from {_BACKEND_NAMES}")


# ----------------------------------------------------------------- process --

@dataclasses.dataclass
class _ChildSpec:  # wire-type
    """Everything a spawn child needs; plain picklable values only."""

    origin: object  # serving.registry.TenantOrigin, in the wire's shape
    policy: str
    init: dict  # parent buffer state: numpy leaves (interop.tree_leaves
    #             order and dtypes) + counters + offset
    reservoir: dict | None  # {"k": int, "state": Reservoir.state_dict()}
    checkpoint_dir: str | None
    checkpoint_every: int
    poll_s: float
    coalesce_batches: int
    coalesce_target: int
    queue_capacity: int
    warm_shapes: bool
    env: dict  # applied in the worker before it builds its tenant
    #            (thread-pool caps under core oversubscription, ...)
    # "delta" (default): publishes ship only the sketch delta accumulated
    # since the last publish (sparse-encoded; full leaves for the first
    # publish and after any resync request).  "full": every publish ships
    # the whole front — the pre-v3 behaviour, kept for A/B benching.
    publish_mode: str = "delta"
    # exact duplicate-edge pre-aggregation in the child's coalescing path
    # ; default off so specs pickled by older parents replay
    # unchanged (readers use getattr for the same reason)
    dedup: bool = False


def _warm_child_shapes(tenant) -> None:
    """Run the child's ingest bucket ladder (and a publish) once before the
    ready handshake, so the first transport-fed ingest pays no library
    load or allocator growth.  Zero-weight batches are counter no-ops; the
    warm publish bumps the epoch, which is harmless (epoch numbers are
    arbitrary, still monotone).
    """
    from repro_torch.core.types import EdgeBatch

    view = tenant.stream
    granule = getattr(view, "granule", None)
    base = getattr(view, "base", view)
    base_b = getattr(base, "batch_size", None) or 8192
    if granule:  # ShardStreamView ladder; 2x covers coalesced overshoot
        buckets = range(granule, 2 * base_b + granule, granule)
    else:
        buckets = [base_b]
    for bucket in buckets:
        z = np.zeros(bucket, np.int32)
        tenant.buffer.ingest(EdgeBatch.from_numpy(
            z, z, z, device=tenant.buffer.device))
    tenant.buffer.publish()


def build_kernels() -> None:
    """Build every kernel library here, before a worker process starts on
    the card: children that found no library would each run ``nvcc``
    inside their ready handshake (the build is cached by content)."""
    from repro_torch.kernels import build

    build.build_all()


# names a directory where every worker session that stops leaves a report of
# the kernels its process launched during it (how a parent counts the
# launches of worker processes it does not run); unset, nothing is written
LAUNCH_REPORT_ENV = "REPRO_TORCH_LAUNCH_REPORT"


def _report_launches(tenant, before: dict) -> None:
    """Write this process's kernel launches since ``before`` and the
    session buffer's ingest calls to ``<pid>-<ns>.json`` in the directory
    that ``LAUNCH_REPORT_ENV`` names, if it names one."""
    out = os.environ.get(LAUNCH_REPORT_ENV)
    if not out:
        return
    from repro_torch.kernels import launch_counts

    now = launch_counts()
    report = {"pid": os.getpid(), "buffer_ingests": tenant.buffer.ingests,
              "launches": {k: now[k] - before[k] for k in now}}
    path = os.path.join(out, f"{os.getpid()}-{time.monotonic_ns()}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(report, f)
    os.replace(path + ".tmp", path)  # a reader never sees half a report


def build_child_spec(tenant, policy, *, reservoir=None, checkpoint_dir=None,
                     checkpoint_every=0, poll_s=0.05, coalesce_batches=1,
                     coalesce_target=8192, queue_capacity=64,
                     warm_shapes=True, env=None,
                     publish_mode="delta", dedup=False) -> _ChildSpec:
    """Snapshot everything a remote worker needs into a picklable spec.

    Shared by the process backend (ships it via ``Process`` args) and the
    socket backend (ships it in the ``hello`` frame), so both transports
    rebuild a worker from the exact same state.  The spec holds no tensor:
    the buffer state leaves the device as numpy leaves, and the origin
    takes the JAX package's shape (``TenantOrigin.for_wire``), so a JAX
    worker host serves it too.  The device travels beside the spec."""
    if not isinstance(policy, str):
        raise TypeError(
            "the process backend needs a publish-policy SPEC string "
            f"(e.g. 'every:4'), not {type(policy).__name__}: the policy "
            "object lives in the child and is rebuilt there")
    origin = getattr(tenant, "origin", None)
    if origin is None:
        raise ValueError(
            "process backend requires a registry-opened tenant (its "
            "TenantOrigin rebuild spec is how the child reproduces the "
            "sketch layout); hand-built tenants can only run on the "
            "thread backend")
    buf = tenant.buffer.state()
    init = {
        "front": tree_leaves(buf["front"]),
        "delta": tree_leaves(buf["delta"]),
        "pending": int(buf["pending"]),
        "epoch": int(buf["epoch"]),
        "n_edges": int(buf["n_edges"]),
        "offset": int(tenant.offset),
    }
    res = None
    if reservoir is not None:
        res = {"k": reservoir.k, "state": reservoir.state_dict()}
    if publish_mode not in ("delta", "full"):
        raise ValueError(
            f"publish_mode must be 'delta' or 'full', got {publish_mode!r}")
    return _ChildSpec(
        origin=origin.for_wire(), policy=policy, init=init, reservoir=res,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        poll_s=poll_s, coalesce_batches=coalesce_batches,
        coalesce_target=coalesce_target, queue_capacity=queue_capacity,
        warm_shapes=warm_shapes, env=dict(env or {}),
        publish_mode=publish_mode, dedup=bool(dedup))


def run_ingest_worker(spec: _ChildSpec, recv, send, device="cuda") -> str:
    """Transport-neutral body of a remote ingest worker, on ``device``.

    ``recv(timeout_s)`` yields the next decoded message tuple (or ``None``
    on timeout); ``send(msg)`` ships one message tuple back to the parent
    and must be thread-safe (the publish callback fires from the worker
    thread).  Both the process child (``_child_main``) and the socket
    worker server (``repro_torch.net.ingest_server``) drive this loop;
    message kinds are the wire-protocol kinds
    (``repro_torch.net.wire.FRAME_TYPES``).  A ``device`` naming CUDA where
    there is no card fails the session: the worker never moves to the
    CPU on its own.

    Returns ``"stopped"`` after a graceful stop, ``"failed"`` after a
    terminal ``failed`` message.  Whatever happens, the local ingest
    thread is stopped on the way out — a dead transport can never leave an
    orphan worker folding edges nobody will ever adopt.
    """
    worker = None
    try:
        os.environ.update(spec.env)
        from repro_torch.kernels import launch_counts
        from repro_torch.streams.reservoir import Reservoir

        launches_before = launch_counts()

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ingest worker asked to run on {device} but CUDA is not "
                "available here; it does not fall back to the CPU")
        tenant = spec.origin.rebuild(device=device)
        # adopt the parent's buffer state (warm prefix / restored checkpoint)
        template = tenant.buffer.state()["front"]
        tenant.buffer.load_state({
            "front": tree_unflatten(template, spec.init["front"]),
            "delta": tree_unflatten(template, spec.init["delta"]),
            "pending": spec.init["pending"],
            "epoch": spec.init["epoch"],
            "n_edges": spec.init["n_edges"],
        })
        tenant.offset = int(spec.init["offset"])
        reservoir = None
        if spec.reservoir is not None:
            reservoir = Reservoir(int(spec.reservoir["k"]))
            reservoir.load_state_dict(spec.reservoir["state"])
        publish_delta = getattr(spec, "publish_mode", "delta") == "delta"
        if publish_delta:
            tenant.buffer.capture_publish_delta = True
        # The first publish after (re)build MUST ship full leaves: the warm
        # publish below bumps an epoch the parent never adopts, a restored
        # checkpoint's front predates this session, and a redialed parent
        # opens a fresh session — in every case the parent's front epoch
        # cannot anchor a delta.  A "resync" frame re-arms this.
        force_full = threading.Event()
        force_full.set()
        if spec.warm_shapes:
            _warm_child_shapes(tenant)

        # deliberately small (just enough backlog for coalescing to engage):
        # the PARENT queue is the system's one backpressure point, and a
        # child-side buffer as large as the parent's would double the
        # effective lag bound an operator tuned queue_capacity for
        local_queue = BoundedEdgeQueue(
            min(spec.queue_capacity, max(8, spec.coalesce_batches)))
        worker = IngestWorker(
            tenant, local_queue, make_policy(spec.policy),
            reservoir=reservoir, checkpoint_dir=spec.checkpoint_dir,
            checkpoint_every=spec.checkpoint_every, poll_s=spec.poll_s,
            coalesce_batches=spec.coalesce_batches,
            coalesce_target=spec.coalesce_target,
            dedup=getattr(spec, "dedup", False))

        def ship(snap):  # runs in the worker thread, post-publish
            payload = {
                "epoch": snap.epoch,
                "n_edges": snap.n_edges,
                "next_offset": worker._ingested_offset + 1,
                "reservoir": (reservoir.state_dict()
                              if reservoir is not None else None),
                "metrics": worker.metrics_snapshot(),
                # telemetry rides the beat it already has: cumulative hub
                # state (parent adopts = replace-then-sum) + drained spans
                "obs": {"hub": get_hub().state(),
                        "trace": get_trace_log().drain()},
            }
            delta = (tenant.buffer.last_publish_delta
                     if publish_delta else None)
            if delta is not None and not force_full.is_set():
                # ship only what this epoch folded in; the parent merges it
                # into its front through the same merge (bit-exact) —
                # counters/reservoir/cursor still ride every publish
                payload["mode"] = "delta"
                payload["base_epoch"] = snap.epoch - 1
                payload["leaves"] = wire.encode_leaves(tree_leaves(delta))
            else:
                force_full.clear()
                payload["mode"] = "full"
                payload["leaves"] = tree_leaves(snap.sketch)
            send(("publish", payload))

        worker.on_publish = ship
        worker.start()
        send(("ready", {"pid": os.getpid(), "offset": tenant.offset,
                        "epoch": tenant.epoch}))

        last_beat = time.monotonic()
        while True:
            if worker.state == FAILED:
                send(("failed", repr(worker.error),
                      worker.error_tb or "", worker.metrics_snapshot()))
                return "failed"
            msg = recv(0.1)
            now = time.monotonic()
            if now - last_beat >= 0.25:
                send(("metrics", worker.metrics_snapshot(),
                      {"hub": get_hub().state(),
                       "trace": get_trace_log().drain()}))
                last_beat = now
            if msg is None:
                continue
            kind = msg[0]
            if kind == "item":
                # v2 frames append trace_id; *rest keeps v1-shaped tuples
                # (e.g. replayed captures) parseable rather than a crash
                _, offset, src, dst, weight, n_edges, *rest = msg
                item = QueueItem(offset, src, dst, weight, n_edges,
                                 trace_id=rest[0] if rest else "")
                while not local_queue.put(item, timeout=0.2):
                    if worker.state == FAILED:
                        break  # surfaced at the top of the loop
            elif kind == "checkpoint":
                try:
                    send(("checkpointed", {"path": worker.checkpoint()}))
                except BaseException as exc:  # keep serving; caller decides
                    send(("checkpointed", {"error": repr(exc)}))
            elif kind == "stop":
                worker.request_stop(drain=bool(msg[1]))
                worker.join()
                if worker.state == FAILED:
                    send(("failed", repr(worker.error),
                          worker.error_tb or "",
                          worker.metrics_snapshot()))
                    return "failed"
                _report_launches(tenant, launches_before)
                send(("stopped", worker.metrics_snapshot(),
                      {"hub": get_hub().state(),
                       "trace": get_trace_log().drain()}))
                return "stopped"
            elif kind == "ping":
                send(("pong",))
            elif kind == "resync":
                # the parent could not anchor our last delta (ack gap,
                # restart, redial): the NEXT publish ships full leaves —
                # they carry cumulative state, so nothing is lost
                force_full.set()
            else:
                raise ValueError(f"unknown transport message {kind!r}")
    except BaseException as exc:
        import traceback

        try:
            send(("failed", repr(exc), traceback.format_exc(),
                  worker.metrics_snapshot() if worker is not None else None))
        except BaseException:
            pass  # the transport itself is dead; nobody left to tell
        return "failed"
    finally:
        if worker is not None and worker.state in (RUNNING, DRAINING):
            # hard-stop semantics, same as a SIGKILLed process child: the
            # parent re-offers unacknowledged work on restore
            worker.request_stop(drain=False)
            worker.join(timeout=30.0)


def _child_main(spec: _ChildSpec, in_q, out_q, device: str) -> None:
    """Entry point of a process-backend worker child (spawn-safe: top-level
    function, rebuilds everything from the picklable spec on ``device``,
    the parent's).  Thin transport shim: frames every message with the
    shared wire codec so the process pipe and the socket transport speak
    byte-identical payloads."""
    # the parent orchestrates graceful drains; a terminal Ctrl-C must not
    # kill children mid-drain before the parent can flush checkpoints
    signal.signal(signal.SIGINT, signal.SIG_IGN)

    def recv(timeout_s: float):
        try:
            raw = in_q.get(timeout=timeout_s)
        except queue_mod.Empty:
            return None
        return wire.decode_message(raw)

    def send(msg) -> None:
        out_q.put(wire.encode_message(msg))

    if run_ingest_worker(spec, recv, send, device) != "stopped":
        sys.exit(1)


def _absorb_worker_obs(h, obs: dict | None, epoch: int | None = None) -> None:
    """Fold a remote worker's shipped telemetry into the parent: adopt its
    cumulative hub state (replace-then-sum keyed by tenant, so later beats
    supersede earlier ones) and absorb its drained span events.  A span the
    child marked ``publish`` becomes visible parent-side now — close the
    chain with an ``adopt`` event carrying the adopted epoch."""
    if not obs:
        return
    tid = h.tenant.key.tenant_id
    if obs.get("hub"):
        get_hub().adopt(f"worker:{tid}", obs["hub"])
    events = obs.get("trace") or []
    log = get_trace_log()
    log.absorb(events)
    if epoch is not None:
        for ev in events:
            if ev.get("event") == "publish" and ev.get("epoch") == epoch:
                log.emit(ev["trace"], "ingest", "adopt", epoch=epoch,
                         tenant=tid)


def dispatch_parent_message(h, msg) -> None:
    """Parent-side dispatch of one worker→parent message, shared by every
    remote transport (``ProcessWorker`` and ``repro_torch.net``'s
    ``SocketWorker``).  ``h`` is the worker handle; this is where remote
    publishes become parent state via ``SnapshotBuffer.adopt_published``,
    so epoch ordering stays single-sourced no matter the transport.  The
    shipped leaves are copied onto the tenant's device into the structure
    of ``h._template`` (the tenant's front when the handle was made)."""
    kind = msg[0]
    if kind == "ready":
        h._ready.set()
    elif kind == "metrics":
        h._last_metrics = msg[1]
        if len(msg) > 2:
            _absorb_worker_obs(h, msg[2])
    elif kind == "publish":
        from repro_torch.serving.snapshot import StaleDelta

        payload = msg[1]
        device = h.tenant.buffer.device
        if payload.get("mode") == "delta":
            delta = tree_unflatten(h._template,
                                   wire.decode_leaves(payload["leaves"]),
                                   device=device)
            try:
                snap = h.tenant.buffer.adopt_published(
                    None, payload["epoch"], payload["n_edges"],
                    delta=delta, base_epoch=payload["base_epoch"])
            except StaleDelta:
                # skip this publish entirely — cursor, metrics and
                # reservoir stay at the last adopted epoch so drop/replay
                # accounting can't run ahead of adopted state; the worker's
                # next publish ships cumulative full leaves and catches the
                # parent up in one step
                h.send_control(("resync",))
                return
        else:
            sketch = tree_unflatten(h._template, payload["leaves"],
                                    device=device)
            snap = h.tenant.buffer.adopt_published(
                sketch, payload["epoch"], payload["n_edges"])
        h._ingested_offset = payload["next_offset"] - 1
        h.tenant.offset = payload["next_offset"]
        h._last_metrics = payload["metrics"]
        if h.reservoir is not None and payload["reservoir"] is not None:
            h.reservoir.load_state_dict(payload["reservoir"])
        _absorb_worker_obs(h, payload.get("obs"), epoch=payload["epoch"])
        note = getattr(h, "_note_publish_adopted", None)
        if note is not None:  # socket redial bookkeeping (net/backend.py)
            note(int(payload["n_edges"]))
        if h.on_publish is not None:
            h.on_publish(snap)
    elif kind == "checkpointed":
        h._ckpt_result = msg[1]
        h._ckpt_event.set()
    elif kind == "stopped":
        h._last_metrics = msg[1]
        if len(msg) > 2:
            _absorb_worker_obs(h, msg[2])
        h.state = STOPPED
        h._ready.set()
        h._ckpt_event.set()
        h._done.set()
    elif kind == "failed":
        _, err, tb, metrics = msg
        h.error = RuntimeError(err)
        h.error_tb = tb
        if metrics:
            h._last_metrics = metrics
        h.state = FAILED
        h._ready.set()
        h._ckpt_event.set()
        h._done.set()
    elif kind == "pong":
        pass  # liveness ack; receipt alone resets the peer's idle clock
    else:
        raise ValueError(f"unexpected worker→parent message {kind!r}")


class ProcessWorker:
    """Parent-side handle for one ingest worker living in a spawn child.

    Quacks like ``IngestWorker`` for everything the supervisor touches.
    Three parent threads cooperate: the *forwarder* moves ``QueueItem``s
    from the parent's bounded queue into the child's item pipe (held until
    the child's ready handshake so readiness is observable), the *receiver*
    adopts published epochs into the parent ``SnapshotBuffer`` and mirrors
    child metrics/health, and the caller's thread drives lifecycle.
    """

    def __init__(self, tenant, queue: BoundedEdgeQueue, policy, *,
                 reservoir=None, checkpoint_dir=None, checkpoint_every=0,
                 on_publish=None, poll_s=0.05, coalesce_batches=1,
                 coalesce_target=8192, queue_capacity=64,
                 warm_shapes=True, child_env=None, ctx=None,
                 publish_mode="delta", dedup=False) -> None:
        self.tenant = tenant
        self.queue = queue
        self.on_publish = on_publish
        # kept live: each publish handoff loads the child's shipped
        # reservoir state back into this object, so parent-side observers
        # see the same online sample a thread worker would expose
        self.reservoir = reservoir
        self.state = CREATED
        self.error: BaseException | None = None
        self.error_tb: str | None = None
        self.base_edges = (tenant.snapshot.n_edges
                          + tenant.buffer.pending_edges)
        self.poll_s = poll_s
        self._template = tenant.snapshot.sketch
        spec = build_child_spec(
            tenant, policy, reservoir=reservoir,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            poll_s=poll_s, coalesce_batches=coalesce_batches,
            coalesce_target=coalesce_target, queue_capacity=queue_capacity,
            warm_shapes=warm_shapes, env=child_env,
            publish_mode=publish_mode, dedup=dedup)
        device = str(tenant.buffer.device)
        if tenant.buffer.device.type == "cuda":
            build_kernels()
        ctx = ctx or multiprocessing.get_context("spawn")
        # small transit pipe: backpressure cascades child -> pipe ->
        # parent queue -> pump, so the parent queue's policy stays the
        # single source of drop/spill accounting
        self._in_q = ctx.Queue(maxsize=8)
        # the pipe's feeder thread must not hold this process at exit when
        # the child died with frames unread (a SIGKILLed child); frames to
        # a dead child are abandoned work, which restore replays anyway
        self._in_q.cancel_join_thread()
        self._out_q = ctx.Queue()
        self.process = ctx.Process(
            target=_child_main,
            args=(spec, self._in_q, self._out_q, device),
            daemon=True, name=f"ingest-proc-{tenant.key.tenant_id}")
        self._ingested_offset = tenant.offset - 1
        self._last_metrics: dict | None = None
        self._fallback_metrics = WorkerMetrics()
        self._ready = threading.Event()
        self._spawned = threading.Event()
        self._done = threading.Event()
        self._stop_event = threading.Event()
        self._drain = True
        self._hard_stop = False
        self._started = False
        self._ckpt_lock = threading.Lock()
        self._ckpt_event = threading.Event()
        self._ckpt_result: dict | None = None
        self._forwarder: threading.Thread | None = None
        self._receiver: threading.Thread | None = None

    # -------------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Non-blocking: spawning happens in a starter thread.

        ``Process.start()`` blocks until the child boots far enough to
        drain the (sketch-sized, pipe-buffer-exceeding) spawn spec, so a
        serial loop over K workers would serialize K child boots; the
        starter thread lets ``Runtime.start()`` launch all children
        concurrently.
        """
        self._started = True
        self.state = RUNNING
        threading.Thread(target=self._spawn_and_attach, daemon=True,
                         name=f"{self.process.name}-spawn").start()

    def _spawn_and_attach(self) -> None:
        try:
            self.process.start()
        except BaseException as exc:
            import traceback

            self.error = exc
            self.error_tb = traceback.format_exc()
            self.state = FAILED
            self._ready.set()
            self._ckpt_event.set()
            self._done.set()
            return
        self._spawned.set()
        if self._hard_stop:  # killed while still booting
            self.process.terminate()
            self.state = STOPPED
            self._done.set()
            return
        self._forwarder = threading.Thread(
            target=self._forward_loop, daemon=True,
            name=f"{self.process.name}-fwd")
        self._receiver = threading.Thread(
            target=self._receive_loop, daemon=True,
            name=f"{self.process.name}-rcv")
        self._receiver.start()
        self._forwarder.start()

    def wait_ready(self, timeout: float = 300.0) -> bool:
        """Block until the child built its tenant (and warmed shapes)."""
        ok = self._ready.wait(timeout)
        if self.state == FAILED:
            raise RuntimeError(
                f"worker process for {self.tenant.key.tenant_id} failed "
                f"during startup: {self.error}\n{self.error_tb or ''}")
        return ok

    def request_stop(self, drain: bool = True) -> None:
        self._drain = drain
        self._stop_event.set()
        if drain:
            if self.state == RUNNING:
                self.state = DRAINING
        else:
            # crash-like hard stop, same contract as IngestWorker: in-queue
            # and in-flight work is abandoned exactly as SIGKILL would
            self._hard_stop = True
            self.queue.close()
            if self._spawned.is_set() and self.process.is_alive():
                self.process.terminate()
            elif not self._spawned.is_set():
                # still booting: the starter thread owns the handoff; mark
                # done so join() doesn't wait on a child we'll never use
                self._done.set()

    def join(self, timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout

        def remaining(default=None):
            if deadline is None:
                return default
            return max(deadline - time.monotonic(), 0.01)

        self._done.wait(timeout=remaining())
        if self._spawned.is_set():
            self.process.join(timeout=remaining(60.0))

    def is_alive(self) -> bool:
        if not self._started:
            return False
        if not self._spawned.is_set():
            return not self._done.is_set()  # still booting (or spawn failed)
        return self.process.is_alive() or not self._done.is_set()

    # -------------------------------------------------------------- transport
    def _forward_loop(self) -> None:
        while not self._ready.wait(timeout=0.1):
            if self._done.is_set() or self._hard_stop:
                return
        while True:
            if self._done.is_set() or self._hard_stop:
                return
            item = self.queue.get(timeout=self.poll_s)
            if item is None:
                if (self._stop_event.is_set() and self._drain
                        and self.queue.depth() == 0):
                    break
                continue
            # columnar fast path: raw buffer views, no pickle (v3 frames)
            msg = wire.encode_item_frame(item)
            placed = False
            while not placed:
                try:
                    self._in_q.put(msg, timeout=0.2)
                    placed = True
                except queue_mod.Full:
                    if self._done.is_set() or self._hard_stop:
                        return
        # parent queue drained: hand the child its graceful-stop sentinel
        # (retry while the transit pipe is full — the child is still
        # working through the backlog; give up only on terminal states,
        # which the receiver surfaces)
        while not (self._done.is_set() or self._hard_stop):
            try:
                self._in_q.put(wire.encode_message(("stop", True)),
                               timeout=0.5)
                return
            except queue_mod.Full:
                continue

    def _receive_loop(self) -> None:
        while True:
            try:
                msg = self._out_q.get(timeout=0.2)
            except queue_mod.Empty:
                if not self.process.is_alive():
                    # the pipe may still hold messages the child flushed
                    # before dying — adopt them before declaring death
                    while True:
                        try:
                            tail = self._out_q.get(timeout=0.2)
                        except (queue_mod.Empty, EOFError, OSError):
                            break
                        if not self._handle_guarded(tail):
                            return
                        if self._done.is_set():
                            return
                    self._finalize_death()
                    return
                continue
            except (EOFError, OSError):
                self._finalize_death()
                return
            if not self._handle_guarded(msg):
                return
            if self._done.is_set():
                return

    def _handle_guarded(self, raw) -> bool:
        """Decode and dispatch one framed child message; on a parent-side
        failure (an on_publish callback raising, a torn/mismatched frame
        surfacing as ``WireError``) mark the handle failed, take the child
        down with us (it knows nothing and would keep ingesting until its
        result pipe wedged), and finalize — the receiver must NEVER die
        without setting ``_done``, or ``join()`` would hang for its full
        timeout with the failure swallowed.
        Returns False when the receiver should exit."""
        try:
            dispatch_parent_message(self, wire.decode_message(raw))
            return True
        except BaseException as exc:
            import traceback

            self.error = exc
            self.error_tb = traceback.format_exc()
            self.state = FAILED
            if self.process.is_alive():
                self.process.terminate()
            self._ready.set()
            self._ckpt_event.set()
            self._done.set()
            return False

    def _finalize_death(self) -> None:
        """The child exited without a terminal message."""
        if self._done.is_set():
            return
        if self._hard_stop:
            self.state = STOPPED
        else:
            code = self.process.exitcode
            self.error = RuntimeError(
                f"worker process for {self.tenant.key.tenant_id} exited "
                f"unexpectedly (exitcode={code})")
            self.error_tb = None
            self.state = FAILED
        self._ready.set()
        self._ckpt_event.set()
        self._done.set()

    def send_control(self, msg) -> None:
        """Ship a parent→child control frame out-of-band of the item stream
        (used by the adopt path to request a full-leaves resync)."""
        self._in_q.put(wire.encode_message(msg), timeout=60.0)

    # ------------------------------------------------------------- checkpoint
    def checkpoint(self, timeout: float = 300.0) -> str:
        """Ask the child for a synchronous checkpoint; returns its path."""
        with self._ckpt_lock:
            if self._done.is_set() or not self._spawned.is_set() \
                    or not self.process.is_alive():
                raise RuntimeError(
                    f"worker process for {self.tenant.key.tenant_id} is not "
                    "running; cannot checkpoint")
            self._ckpt_event.clear()
            self._ckpt_result = None
            self._in_q.put(wire.encode_message(("checkpoint",)), timeout=60.0)
            if not self._ckpt_event.wait(timeout):
                raise TimeoutError("child did not acknowledge checkpoint")
            res = self._ckpt_result
        if res is None:  # terminal state raced the request
            raise RuntimeError(
                f"worker process for {self.tenant.key.tenant_id} stopped "
                f"before checkpointing (state={self.state})")
        if "error" in res:
            raise RuntimeError(f"child checkpoint failed: {res['error']}")
        return res["path"]

    # ---------------------------------------------------------------- reports
    @property
    def ingested_edges(self) -> int:
        return int((self._last_metrics or {}).get("ingested_edges", 0))

    def health(self) -> dict:
        return {
            "state": self.state,
            "alive": self.is_alive(),
            "error": repr(self.error) if self.error else None,
            "epoch": self.tenant.epoch,
            "ingested_offset": self._ingested_offset,
            "queue_depth": self.queue.depth(),
            "pid": self.process.pid if self._spawned.is_set() else None,
        }

    def metrics_snapshot(self) -> dict:
        qstats = self.queue.stats()
        if self._last_metrics is None:
            m = self._fallback_metrics.snapshot(
                queue_stats=qstats, state=self.state,
                epoch=self.tenant.epoch)
            child_depth = 0
        else:
            m = dict(self._last_metrics)
            child_depth = int(m.get("queue_depth", 0))
        # queue accounting is parent-authoritative (drops/spills happen in
        # the parent queue only); depth adds batches already in the child
        m["state"] = self.state
        m["epoch"] = self.tenant.epoch
        m["queue_depth"] = qstats["depth"] + child_depth
        m["ingest_lag_batches"] = m["queue_depth"]
        m["dropped_batches"] = qstats["dropped_batches"]
        m["dropped_edges"] = qstats["dropped_edges"]
        m["spilled_batches"] = qstats["spilled_batches"]
        m["max_queue_depth"] = qstats["max_depth_seen"]
        m["pid"] = self.process.pid if self._spawned.is_set() else None
        return m


class ProcessBackend(ExecutionBackend):
    """Spawn-safe multiprocessing children owning their sketches."""

    name = "process"
    remote = True

    def __init__(self, *, warm_shapes: bool = True,
                 child_env: dict | None = None,
                 mp_context: str = "spawn",
                 publish_mode: str = "delta") -> None:
        # spawn, never fork: the parent holds a CUDA context and worker
        # threads; a forked child can use neither
        self._ctx = multiprocessing.get_context(mp_context)
        self.warm_shapes = warm_shapes
        # applied in each child before it builds its tenant (e.g. caps on
        # its host thread pools under core oversubscription)
        self.child_env = dict(child_env or {})
        # "delta" ships per-epoch sketch deltas (sparse-encoded); "full"
        # ships whole fronts — kept selectable for the A/B bench column
        self.publish_mode = publish_mode

    def make_worker(self, tenant, queue, policy, *, reservoir=None,
                    checkpoint_dir=None, checkpoint_every=0, on_publish=None,
                    poll_s=0.05, coalesce_batches=1, coalesce_target=8192,
                    queue_capacity=64, dedup=False):
        return ProcessWorker(
            tenant, queue, policy, reservoir=reservoir,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            on_publish=on_publish, poll_s=poll_s,
            coalesce_batches=coalesce_batches,
            coalesce_target=coalesce_target, queue_capacity=queue_capacity,
            warm_shapes=self.warm_shapes, child_env=self.child_env,
            ctx=self._ctx, publish_mode=self.publish_mode, dedup=dedup)
