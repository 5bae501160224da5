"""Parent-side socket execution backend (DESIGN.md §Net): the JAX package's
``net/backend.py`` on the port.

``SocketBackend`` is the third ``ExecutionBackend``: the same
``run_ingest_worker`` loop the process backend runs in a spawn child, but
across a TCP connection, framed by the shared ``repro_torch.net.wire``
codec (the JAX package's frames: a port parent drives a JAX worker host,
and a JAX parent a port one).
Everything the runtime contract demands stays parent-side and
transport-invariant: the ``BoundedEdgeQueue`` (ALL backpressure / drop /
spill accounting), ``SnapshotBuffer.adopt_published`` (epoch ordering),
checkpoint orchestration, and conservation reports.

Two placements per worker:

  self-hosted  (default, no addresses) the parent binds a loopback
               listener on an ephemeral port and spawns a child process
               that dials back and serves one worker session on the
               parent's device — one command, real TCP end-to-end (the
               kernels are built here first, so no child runs nvcc);
  remote       (``SocketBackend(addresses=[...])`` or the
               ``"socket:HOST:PORT,..."`` spec) the parent dials
               ``stream_ingest --listen`` worker hosts, round-robin over
               the address list.

Lifecycle is hang-free by construction: accept/dial loops poll a cancel
event (set by ``request_stop`` and ``SocketBackend.shutdown()``, which
``Runtime.stop()`` invokes before joining), every read/write carries a
frame deadline, and a dead TCP peer surfaces as a FAILED worker whose
error carries the last-known accounting — so ``Runtime.stop()`` raises
``WorkerFailure`` with the final report attached, mirroring the process
backend's SIGKILL semantics.
"""
from __future__ import annotations

import multiprocessing
import socket
import threading
import time
from collections import deque

from repro_torch.net import wire
from repro_torch.net.ingest_server import _selfhost_worker_main
from repro_torch.runtime.backend import (
    ExecutionBackend,
    build_child_spec,
    build_kernels,
    dispatch_parent_message,
)
from repro_torch.runtime.metrics import WorkerMetrics
from repro_torch.runtime.worker import CREATED, DRAINING, FAILED, RUNNING, STOPPED

# Redial replay bound: in-flight items retained past this many (publishes
# too rare to ever cover them) forfeit the reconnect safety net rather
# than grow without bound.
_RETAIN_CAP = 8192


class SocketWorker:
    """Parent-side handle for one ingest worker across a TCP connection.

    Quacks like ``IngestWorker``/``ProcessWorker`` for everything the
    supervisor touches.  Three parent threads cooperate, exactly as in the
    process backend: a *starter* establishes the connection (accept or
    dial) and sends the ``hello`` spec, the *forwarder* moves ``QueueItem``
    frames from the parent's bounded queue onto the socket, and the
    *receiver* adopts published epochs into the parent ``SnapshotBuffer``.
    """

    def __init__(self, tenant, queue, policy, *, address=None,
                 reservoir=None, checkpoint_dir=None, checkpoint_every=0,
                 on_publish=None, poll_s=0.05, coalesce_batches=1,
                 coalesce_target=8192, queue_capacity=64, warm_shapes=True,
                 child_env=None, ctx=None, connect_timeout_s=300.0,
                 frame_deadline_s=120.0, auth_token=None,
                 publish_mode="delta", dedup=False) -> None:
        self.tenant = tenant
        self.queue = queue
        self.on_publish = on_publish
        self.reservoir = reservoir  # kept live from shipped publish state
        self.state = CREATED
        self.error: BaseException | None = None
        self.error_tb: str | None = None
        self.base_edges = (tenant.snapshot.n_edges
                          + tenant.buffer.pending_edges)
        self.poll_s = poll_s
        self.frame_deadline_s = frame_deadline_s
        self.connect_timeout_s = connect_timeout_s
        self._template = tenant.snapshot.sketch
        # kept for the redial path: a reconnect rebuilds a FRESH spec from
        # the tenant's then-current (adopted) state, not this stale one
        self._policy = policy
        self._spec_kwargs = dict(
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            poll_s=poll_s, coalesce_batches=coalesce_batches,
            coalesce_target=coalesce_target, queue_capacity=queue_capacity,
            warm_shapes=warm_shapes, env=dict(child_env or {}),
            publish_mode=publish_mode, dedup=dedup)
        self._spec = build_child_spec(tenant, policy, reservoir=reservoir,
                                      **self._spec_kwargs)
        self.auth_token = wire.resolve_auth_token(auth_token)
        self.address = address  # None ⇒ self-hosted loopback child
        self._sock: socket.socket | None = None
        self._send_lock = threading.Lock()  # forwarder vs checkpoint vs stop
        self._listener: socket.socket | None = None
        self.process = None
        if address is None:
            self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._listener.bind(("127.0.0.1", 0))
            self._listener.listen(1)
            host, port = self._listener.getsockname()[:2]
            if tenant.buffer.device.type == "cuda":
                build_kernels()
            ctx = ctx or multiprocessing.get_context("spawn")
            self.process = ctx.Process(
                target=_selfhost_worker_main,
                args=(host, port, dict(child_env or {}),
                      str(tenant.buffer.device)),
                daemon=True, name=f"ingest-sock-{tenant.key.tenant_id}")
        self._ingested_offset = tenant.offset - 1
        self._last_metrics: dict | None = None
        self._fallback_metrics = WorkerMetrics()
        self._ready = threading.Event()
        self._connected = threading.Event()
        self._done = threading.Event()
        self._stop_event = threading.Event()
        self._abort_connect = threading.Event()
        self._fail_lock = threading.Lock()
        self._drain = True
        self._hard_stop = False
        self._started = False
        self._ckpt_lock = threading.Lock()
        self._ckpt_event = threading.Event()
        self._ckpt_result: dict | None = None
        # ---- single-retry redial state (standing hosts only) -------------
        # Retained items are in-flight work: forwarded to the worker but
        # not yet covered by an ADOPTED publish — exactly what a fresh
        # session must replay for the edge-conservation gates to hold.
        # Lock split (lock-discipline rule): retain-buffer state belongs to
        # _retain_lock, redial arbitration state to _fail_lock — the old
        # code wrote `_redial_used` under _retain_lock on overflow, racing
        # the _fail_lock-guarded read in _peer_lost.  Overflow now sets
        # `_retain_forfeited` (retain-owned); the redial path reads it
        # under _retain_lock where it decides eligibility/replay.
        self._retain_lock = threading.Lock()
        self._retained: deque = deque()  # guarded-by: _retain_lock
        self._retain_active = address is not None  # guarded-by: _retain_lock
        # replay set overflowed _RETAIN_CAP: conservation can no longer be
        # proven across a reconnect, so a redial must fail loudly instead
        self._retain_forfeited = False  # guarded-by: _retain_lock
        self._covered_edges = self.base_edges  # guarded-by: _retain_lock
        self._redial_used = False  # guarded-by: _fail_lock
        self._redialing = False  # guarded-by: _fail_lock
        self._redial_event = threading.Event()  # cleared while redialing
        self._redial_event.set()
        self._rx_quiesced = threading.Event()  # old-session receiver idle

    # -------------------------------------------------------------- lifecycle
    def start(self) -> None:
        """Non-blocking: connection establishment happens in a starter
        thread so ``Runtime.start()`` brings K workers up concurrently."""
        self._started = True
        self.state = RUNNING
        threading.Thread(target=self._connect_and_attach, daemon=True,
                         name=f"sock-{self.tenant.key.tenant_id}-dial").start()

    def _accept_selfhost(self) -> socket.socket:
        self.process.start()
        self._listener.settimeout(0.5)
        deadline = time.monotonic() + self.connect_timeout_s
        while time.monotonic() < deadline:
            if self._abort_connect.is_set():
                raise ConnectionAbortedError(
                    "worker accept cancelled by stop/shutdown")
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                if not self.process.is_alive():
                    raise ConnectionError(
                        "self-hosted socket worker died before dialing back "
                        f"(exitcode={self.process.exitcode})") from None
                continue
            except OSError as exc:
                raise ConnectionAbortedError(
                    f"worker listener closed before the worker connected "
                    f"({exc!r})") from exc
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return conn
        raise TimeoutError(
            f"self-hosted worker did not dial back within "
            f"{self.connect_timeout_s}s")

    def _connect_and_attach(self) -> None:
        try:
            if self.address is None:
                sock = self._accept_selfhost()
            else:
                sock = wire.connect_with_retry(
                    self.address, deadline_s=self.connect_timeout_s,
                    stop=self._abort_connect)
            self.close_listener()  # one peer per worker; stop accepting
            with self._send_lock:
                if self.address is not None and self.auth_token:
                    # remote worker host: present the shared token before
                    # the hello (hosts without one ignore the frame)
                    wire.send_message(sock, ("auth", self.auth_token),
                                      deadline_s=self.frame_deadline_s)
                wire.send_message(sock, ("hello", self._spec),
                                  deadline_s=self.frame_deadline_s)
            self._sock = sock
        except BaseException as exc:
            import traceback

            if self._hard_stop or (self._stop_event.is_set()
                                   and self._abort_connect.is_set()):
                self.state = STOPPED  # stop cancelled the dial; not a crash
            else:
                self.error = exc
                self.error_tb = traceback.format_exc()
                self.state = FAILED
            self.close_transport()
            self._ready.set()
            self._ckpt_event.set()
            self._done.set()
            return
        self._connected.set()
        if self._hard_stop:  # killed while dialing; tear the link down
            self.close_transport()
            self._finalize_dead_peer(None)
            return
        threading.Thread(target=self._receive_loop, daemon=True,
                         name=f"sock-{self.tenant.key.tenant_id}-rcv").start()
        threading.Thread(target=self._forward_loop, daemon=True,
                         name=f"sock-{self.tenant.key.tenant_id}-fwd").start()

    def wait_ready(self, timeout: float = 300.0) -> bool:
        ok = self._ready.wait(timeout)
        if self.state == FAILED:
            raise RuntimeError(
                f"socket worker for {self.tenant.key.tenant_id} failed "
                f"during startup: {self.error}\n{self.error_tb or ''}")
        return ok

    def request_stop(self, drain: bool = True) -> None:
        self._drain = drain
        self._stop_event.set()
        if drain:
            if self.state == RUNNING:
                self.state = DRAINING
        else:
            # crash-like hard stop, a SIGKILL's semantics: abandon
            # in-queue and in-flight work; restore replays from checkpoint
            self._hard_stop = True
            self._abort_connect.set()
            self.queue.close()
            self.close_transport()
            if self.process is not None and self.process.is_alive():
                self.process.terminate()
            if not self._connected.is_set():
                self._done.set()  # starter owns the rest of the teardown

    def join(self, timeout: float | None = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout

        def remaining(default=None):
            if deadline is None:
                return default
            return max(deadline - time.monotonic(), 0.01)

        self._done.wait(timeout=remaining())
        if self.process is not None and self.process.is_alive():
            self.process.join(timeout=remaining(60.0))
        self.close_transport()

    def is_alive(self) -> bool:
        return self._started and not self._done.is_set()

    # -------------------------------------------------------- transport utils
    def close_listener(self) -> None:
        """Close the self-host accept listener (idempotent).  Called once a
        peer is attached, by hard stops, and by ``SocketBackend.shutdown()``
        so ``Runtime.stop()`` never joins against a worker stuck in
        accept."""
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass

    def close_transport(self) -> None:
        self.close_listener()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def abort_connect(self) -> None:
        """Cancel a pending dial/accept (used by backend shutdown)."""
        self._abort_connect.set()

    def _accounting_tail(self) -> str:
        m = self._last_metrics or {}
        return ("last-known accounting: "
                f"ingested_edges={m.get('ingested_edges', 0)}, "
                f"ingested_batches={m.get('ingested_batches', 0)}, "
                f"published_epochs={m.get('published_epochs', 0)}, "
                f"epoch={self.tenant.epoch}, "
                f"ingested_offset={self._ingested_offset}")

    def _finalize_dead_peer(self, exc: BaseException | None) -> None:
        """The TCP peer is gone without a terminal message (or we tore it
        down).  Mirrors ``ProcessWorker._finalize_death``: hard stops read
        as STOPPED, anything else is a FAILED worker whose error carries
        the last-known accounting so ``WorkerFailure.report`` plus this
        message tell the whole story."""
        with self._fail_lock:
            if self._done.is_set():
                return
            if self._hard_stop:
                self.state = STOPPED
            else:
                detail = f" ({exc!r})" if exc is not None else ""
                self.error = ConnectionError(
                    f"socket worker for {self.tenant.key.tenant_id} lost its "
                    f"TCP peer{detail}; {self._accounting_tail()}")
                self.error_tb = None
                self.state = FAILED
            self.close_transport()
            if self.process is not None and self.process.is_alive():
                self.process.terminate()
            self._ready.set()
            self._ckpt_event.set()
            self._done.set()

    def _send(self, msg) -> None:
        with self._send_lock:
            wire.send_message(self._sock, msg,
                              deadline_s=self.frame_deadline_s)

    def _send_on(self, sock, msg) -> None:
        """Send bound to ONE connection: a thread still holding the old
        socket after a redial must fail here instead of interleaving its
        frames with the new session's stream."""
        with self._send_lock:
            if sock is not self._sock:
                raise ConnectionResetError("connection superseded by redial")
            wire.send_message(sock, msg, deadline_s=self.frame_deadline_s)

    def _send_frame_on(self, sock, frame) -> None:
        with self._send_lock:
            if sock is not self._sock:
                raise ConnectionResetError("connection superseded by redial")
            wire.send_frame(sock, frame, deadline_s=self.frame_deadline_s)

    def send_control(self, msg) -> None:
        """Parent→worker control frame outside the forwarder's item stream
        (the adopt path's resync request after a ``StaleDelta``)."""
        self._send(msg)

    def _note_publish_adopted(self, n_edges: int) -> None:
        """Adopt-side redial bookkeeping: retained in-flight items wholly
        covered by the adopted cumulative edge count can never need
        replay — pop them.  Exact because the transport is FIFO and the
        worker coalesces whole items, so adopted counts always land on
        item boundaries (zero-edge items pop early, a counter no-op)."""
        with self._retain_lock:
            while (self._retained and self._covered_edges
                   + self._retained[0].n_edges <= n_edges):
                self._covered_edges += self._retained.popleft().n_edges

    # ----------------------------------------------------------------- redial
    def _peer_lost(self, sock, exc) -> bool:
        """Peer-death policy, called by forward/receive on a dead ``sock``.

        Standing hosts (``address`` set) get ONE bounded reconnect-and-
        resync before the loud ``WorkerFailure``; self-hosted children keep
        the existing fail-fast semantics (their process died — there is
        nothing to re-dial).  Returns True when a redial replaced the
        connection (caller continues against the new session), False when
        the handle was finalized (caller must exit)."""
        with self._fail_lock:
            if self._done.is_set():
                return False
            if sock is not self._sock:
                return True  # a concurrent redial already replaced the link
            with self._retain_lock:  # static edge _fail_lock -> _retain_lock
                forfeited = self._retain_forfeited
            if self._redialing:
                action = "wait"
            elif (self.address is not None and not self._redial_used
                  and not forfeited and not self._hard_stop):
                self._redial_used = True
                self._redialing = True
                self._redial_event.clear()
                action = "redial"
            else:
                action = "fail"
        if action == "fail":
            self._finalize_dead_peer(exc)
            return False
        if action == "wait":
            self._redial_event.wait(self.connect_timeout_s + 60.0)
            with self._fail_lock:
                return not self._done.is_set() and sock is not self._sock
        ok = False
        try:
            ok = self._try_redial()
        finally:
            with self._fail_lock:
                self._redialing = False
            self._redial_event.set()
        if not ok:
            self._finalize_dead_peer(exc)
            return False
        # the old receiver quiesced permanently; give the new session one
        threading.Thread(target=self._receive_loop, daemon=True,
                         name=f"sock-{self.tenant.key.tenant_id}-rcv2").start()
        return True

    def _try_redial(self) -> bool:
        """One reconnect: fresh hello spec from the tenant's adopted state,
        then replay of every retained in-flight item, then socket swap.

        Ordering is what makes this safe: (1) the old session's receiver
        must be quiescent before the replay set is frozen — a publish
        adopted after freezing would double-fold the items it covers;
        (2) replay + swap run under both the retain and send locks, so a
        straggling forwarder send can neither interleave with the resync
        stream nor slip an unreplayed item past it."""
        if not self._rx_quiesced.wait(timeout=30.0):
            return False
        try:
            self._sock.close()  # also kills a half-alive old session
        except OSError:
            pass
        sock = None
        try:
            sock = wire.connect_with_retry(
                self.address, deadline_s=min(30.0, self.connect_timeout_s),
                stop=self._abort_connect)
            spec = build_child_spec(self.tenant, self._policy,
                                    reservoir=self.reservoir,
                                    **self._spec_kwargs)
            with self._send_lock:
                if self.auth_token:
                    wire.send_message(sock, ("auth", self.auth_token),
                                      deadline_s=self.frame_deadline_s)
                wire.send_message(sock, ("hello", spec),
                                  deadline_s=self.frame_deadline_s)
                with self._retain_lock:
                    if self._retain_forfeited:
                        # the forwarder overflowed the replay buffer AFTER
                        # eligibility was checked: the freeze-time state no
                        # longer covers every in-flight edge, so resyncing
                        # would silently lose work.  Fail the redial — the
                        # caller raises a loud WorkerFailure instead.
                        raise ConnectionError(
                            "retained replay set forfeited mid-redial")
                    for it in self._retained:
                        wire.send_frame(sock, wire.encode_item_frame(it),
                                        deadline_s=self.frame_deadline_s)
                    self._retained.clear()
                    self._retain_active = False  # single retry: no 2nd replay
                    self._sock = sock
            return True
        except BaseException:
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
            return False

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
            frame = wire.encode_item_frame(item)
            with self._retain_lock:
                if self._retain_active:
                    self._retained.append(item)
                    if len(self._retained) > _RETAIN_CAP:
                        # too much un-adopted in-flight work to ever replay;
                        # forfeit (NOT `_redial_used = True`: that field is
                        # _fail_lock state — writing it here raced the
                        # redial arbitration in _peer_lost)
                        self._retained.clear()
                        self._retain_active = False
                        self._retain_forfeited = True
                sock = self._sock
            try:
                self._send_frame_on(sock, frame)
            except (ConnectionError, TimeoutError, OSError) as exc:
                if not self._peer_lost(sock, exc):
                    return
                # the redial's resync replayed every retained item —
                # including this one — so do NOT resend it here
        # parent queue drained: graceful-stop sentinel; the terminal
        # `stopped` reply (which the receiver turns into _done) is sent
        # only after the remote worker joined, so every published epoch
        # has already crossed back FIFO before join() returns
        while not (self._done.is_set() or self._hard_stop):
            with self._retain_lock:
                sock = self._sock
            try:
                self._send_on(sock, ("stop", True))
                return
            except (ConnectionError, TimeoutError, OSError) as exc:
                if not self._peer_lost(sock, exc):
                    return

    def _receive_loop(self) -> None:
        sock = self._sock
        while True:
            with self._fail_lock:
                if (self._done.is_set() or self._redialing
                        or sock is not self._sock):
                    # a redial is superseding this connection: stop
                    # dispatching NOW, so no old-session publish can be
                    # adopted after the replay set is frozen
                    self._rx_quiesced.set()
                    return
            try:
                msg = wire.recv_message(
                    sock, poll_s=0.2,
                    frame_deadline_s=self.frame_deadline_s)
            except (ConnectionError, TimeoutError, OSError,
                    wire.WireError) as exc:
                # TCP delivers everything the peer flushed before dying —
                # this loop has already dispatched it; the link is dead
                self._rx_quiesced.set()
                self._peer_lost(sock, exc)
                return
            if msg is None:
                continue
            if not self._handle_guarded(sock, msg):
                return

    def _handle_guarded(self, sock, msg) -> bool:
        """Parent-side dispatch failure (e.g. on_publish raising) mirrors
        ProcessWorker: fail the handle, tear the link down, ALWAYS set
        ``_done`` so join() can never hang on a swallowed error.  Transport
        errors raised FROM a dispatch (a resync request hitting a dying
        link) are peer loss, not a parent-side bug — they take the redial
        path like any other dead-peer signal."""
        try:
            dispatch_parent_message(self, msg)
            return True
        except (ConnectionError, TimeoutError, OSError) as exc:
            self._rx_quiesced.set()
            self._peer_lost(sock, exc)
            return False
        except BaseException as exc:
            import traceback

            with self._fail_lock:
                if not self._done.is_set():
                    self.error = exc
                    self.error_tb = traceback.format_exc()
                    self.state = FAILED
                    self.close_transport()
                    if self.process is not None and self.process.is_alive():
                        self.process.terminate()
                    self._ready.set()
                    self._ckpt_event.set()
                    self._done.set()
            return False

    # ------------------------------------------------------------- checkpoint
    def checkpoint(self, timeout: float = 300.0) -> str:
        """Ask the remote worker for a synchronous checkpoint; returns its
        path (which is only meaningful on a shared filesystem — for the
        loopback self-host placement it always is)."""
        with self._ckpt_lock:
            if self._done.is_set() or not self._connected.is_set():
                raise RuntimeError(
                    f"socket worker for {self.tenant.key.tenant_id} is not "
                    "connected; cannot checkpoint")
            self._ckpt_event.clear()
            self._ckpt_result = None
            try:
                self._send(("checkpoint",))
            except (ConnectionError, TimeoutError, OSError) as exc:
                self._finalize_dead_peer(exc)
                raise RuntimeError(
                    f"socket worker for {self.tenant.key.tenant_id} lost "
                    "its peer; cannot checkpoint") from exc
            if not self._ckpt_event.wait(timeout):
                raise TimeoutError(
                    "remote worker did not acknowledge checkpoint")
            res = self._ckpt_result
        if res is None:  # terminal state raced the request
            raise RuntimeError(
                f"socket worker for {self.tenant.key.tenant_id} stopped "
                f"before checkpointing (state={self.state})")
        if "error" in res:
            raise RuntimeError(f"remote checkpoint failed: {res['error']}")
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
            "peer": (self.address if self.address is not None
                     else ("self-host",
                           self.process.pid if self.process else None)),
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
        # queue accounting is parent-authoritative, same as every backend
        m["state"] = self.state
        m["epoch"] = self.tenant.epoch
        m["queue_depth"] = qstats["depth"] + child_depth
        m["ingest_lag_batches"] = m["queue_depth"]
        m["dropped_batches"] = qstats["dropped_batches"]
        m["dropped_edges"] = qstats["dropped_edges"]
        m["spilled_batches"] = qstats["spilled_batches"]
        m["max_queue_depth"] = qstats["max_depth_seen"]
        m["peer"] = (f"{self.address[0]}:{self.address[1]}"
                     if self.address is not None else "self-host")
        return m


class SocketBackend(ExecutionBackend):
    """Workers across TCP: self-hosted loopback children by default, or
    ``stream_ingest --listen`` hosts via ``addresses``."""

    name = "socket"
    remote = True

    def __init__(self, *, addresses=None, warm_shapes: bool = True,
                 child_env: dict | None = None, mp_context: str = "spawn",
                 connect_timeout_s: float = 300.0,
                 frame_deadline_s: float = 120.0,
                 auth_token: str | None = None,
                 publish_mode: str = "delta") -> None:
        self.auth_token = wire.resolve_auth_token(auth_token)
        self.addresses = list(addresses) if addresses else None
        self._next_addr = 0
        self.warm_shapes = warm_shapes
        self.child_env = dict(child_env or {})
        self._ctx = multiprocessing.get_context(mp_context)
        self.connect_timeout_s = connect_timeout_s
        self.frame_deadline_s = frame_deadline_s
        # "delta" ships per-epoch sketch deltas (sparse-encoded); "full"
        # ships whole fronts — kept selectable for the A/B bench column
        self.publish_mode = publish_mode
        self._workers: list[SocketWorker] = []

    @classmethod
    def from_spec(cls, spec: str) -> "SocketBackend":
        """``"socket"`` (self-host) or ``"socket:HOST:PORT[,HOST:PORT...]"``."""
        if spec == "socket":
            return cls()
        body = spec[len("socket:"):]
        addresses = [wire.parse_hostport(part)
                     for part in body.split(",") if part]
        if not addresses:
            raise ValueError(f"no worker addresses in backend spec {spec!r}")
        return cls(addresses=addresses)

    def make_worker(self, tenant, queue, policy, *, reservoir=None,
                    checkpoint_dir=None, checkpoint_every=0, on_publish=None,
                    poll_s=0.05, coalesce_batches=1, coalesce_target=8192,
                    queue_capacity=64, dedup=False):
        address = None
        if self.addresses is not None:
            address = self.addresses[self._next_addr % len(self.addresses)]
            self._next_addr += 1
        worker = SocketWorker(
            tenant, queue, policy, address=address, reservoir=reservoir,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            on_publish=on_publish, poll_s=poll_s,
            coalesce_batches=coalesce_batches,
            coalesce_target=coalesce_target, queue_capacity=queue_capacity,
            warm_shapes=self.warm_shapes, child_env=self.child_env,
            ctx=self._ctx, connect_timeout_s=self.connect_timeout_s,
            frame_deadline_s=self.frame_deadline_s,
            auth_token=self.auth_token, publish_mode=self.publish_mode,
            dedup=dedup)
        self._workers.append(worker)
        return worker

    def shutdown(self) -> None:
        """Close listeners and cancel pending dials so no worker can sit in
        accept/connect while ``Runtime.stop()`` waits on joins.  Established
        connections are left alone — draining workers still need them."""
        for w in self._workers:
            w.abort_connect()
            if w._connected.is_set():
                w.close_listener()
            # not yet connected: the starter thread observes the cancel and
            # finalizes the handle itself (listener close included)
