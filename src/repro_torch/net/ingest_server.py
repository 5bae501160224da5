"""Worker-host side of the socket ingest transport (DESIGN.md §Net): the
JAX package's ``net/ingest_server.py`` on the port.

A worker session is the parent's ``run_ingest_worker`` loop driven over a
TCP connection instead of a multiprocessing pipe: the parent dials in (or
a self-hosted child dials back), sends a ``hello`` frame carrying the
picklable ``_ChildSpec``, and from then on the stream carries exactly the
process-backend message kinds (``item`` — shipped as v3 columnar
``item_cols`` frames, decoded without pickle — and ``resync`` in;
``ready`` / ``publish`` / ``metrics`` / ``checkpointed`` / ``stopped`` /
``failed`` out).  A parent that re-dials after losing its connection
opens a NEW session with a fresh hello built from its adopted state, so
the first publish of that session is a full-leaves resync by
construction — the server needs no cross-session memory.

``WorkerServer`` is the standing flavour (``stream_ingest --listen
HOST:PORT``): it accepts any number of parent connections, one worker
session per connection, each in its own thread — so one worker host can
hold several shards of one parent, or shards of several parents.
``_selfhost_worker_main`` is the loopback flavour the default
``SocketBackend`` uses so a single command still exercises the full TCP
path end-to-end.  The hello frame carries no device: a standing host
ingests on its own ``device`` (the card by default), a self-hosted child
on the parent's.  Either speaks to a JAX parent as to a port one.

Deadline discipline (no hangs by construction): the accept loop polls so
``stop()`` lands within a poll tick, a connection that never says hello is
dropped after ``hello_timeout_s``, and every in-session read/write carries
the wire layer's frame deadline.
"""
from __future__ import annotations

import signal
import socket
import threading
import time

from repro_torch.net import wire


def serve_worker_session(conn: socket.socket, *,
                         hello_timeout_s: float = 300.0,
                         frame_deadline_s: float = 120.0,
                         auth_token: str = "", device="cuda") -> str:
    """Run one ingest-worker session over an established connection.

    Blocks until the parent stops the worker (returns ``"stopped"``), the
    worker fails (``"failed"``), or the transport dies.  The tenant is
    built inside ``run_ingest_worker`` on ``device`` from the spec the
    ``hello`` frame ships.  With ``auth_token`` set, the peer
    must present it in an ``auth`` frame before the hello is honoured
    (without one, stray ``auth`` frames are ignored — clients may always
    send their token).
    """
    from repro_torch.runtime.backend import run_ingest_worker

    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    send_lock = threading.Lock()  # publish callback vs loop share the socket

    def recv(timeout_s: float):
        return wire.recv_message(conn, poll_s=timeout_s,
                                 frame_deadline_s=frame_deadline_s)

    def send(msg) -> None:
        with send_lock:
            wire.send_message(conn, msg, deadline_s=frame_deadline_s)

    deadline = time.monotonic() + hello_timeout_s
    authed = not auth_token
    hello = None
    scraped = False
    while hello is None:
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"no hello frame within {hello_timeout_s}s; dropping peer")
        try:
            msg = recv(0.5)
        except ConnectionError:
            if scraped:
                return "scraped"  # scrape-only peer hung up cleanly
            raise
        if msg is None:
            continue
        if msg[0] == "auth":
            if auth_token and not wire.auth_matches(
                    auth_token, msg[1] if len(msg) > 1 else None):
                raise wire.WireError("auth failed; dropping peer")
            authed = True
            continue
        if msg[0] == "metrics_req":
            # scrape surface: same auth gate as a worker session — the hub
            # exposes tenant ids and throughput, not public data
            if not authed:
                raise wire.WireError(
                    "auth token required before a metrics scrape; "
                    "dropping peer")
            send(("metrics", scrape_payload()))
            scraped = True
            continue
        hello = msg
    if not authed:
        raise wire.WireError(
            "auth token required before a worker session; dropping peer")
    if hello[0] != "hello":
        raise wire.WireError(
            f"expected a hello frame to open a worker session, got {hello[0]!r}")
    return run_ingest_worker(hello[1], recv, send, device)


def scrape_payload() -> dict:
    """One ``metrics`` scrape reply (see ``repro_torch.obs.dump`` — the
    wire frame and the ``--metrics-json`` file carry this exact shape)."""
    from repro_torch.obs.dump import scrape_payload as _payload

    return _payload()


def _selfhost_worker_main(host: str, port: int, env: dict,
                          device: str) -> None:
    """Child entry for the self-hosted (loopback) socket worker: dial the
    parent's per-worker listener and serve one session on ``device`` (the
    parent's).  Spawn-safe."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # parent orchestrates drains
    import os

    os.environ.update(env)  # before the tenant is built (spec.env re-applies)
    sock = wire.connect_with_retry((host, port), deadline_s=60.0)
    try:
        serve_worker_session(sock, device=device)
    finally:
        try:
            sock.close()
        except OSError:
            pass


class WorkerServer:
    """Standing worker host: accept parent connections, one session each,
    every session's tenant on ``device`` (the card unless the caller names
    the CPU; a session that finds no card fails, it does not move)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 hello_timeout_s: float = 300.0,
                 frame_deadline_s: float = 120.0,
                 auth_token: str | None = None, device="cuda") -> None:
        self.device = str(device)
        self.auth_token = wire.resolve_auth_token(auth_token)
        wire.check_bind_allowed(host, self.auth_token, "WorkerServer")
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.address: tuple[str, int] = self._listener.getsockname()[:2]
        self.hello_timeout_s = hello_timeout_s
        self.frame_deadline_s = frame_deadline_s
        self._stop = threading.Event()
        self._sessions: list[threading.Thread] = []
        self.sessions_served = 0
        self.session_results: list[str] = []
        self._lock = threading.Lock()

    def _run_session(self, conn: socket.socket, peer) -> None:
        try:
            status = serve_worker_session(
                conn, hello_timeout_s=self.hello_timeout_s,
                frame_deadline_s=self.frame_deadline_s,
                auth_token=self.auth_token, device=self.device)
        except (ConnectionError, TimeoutError, OSError, wire.WireError) as exc:
            # a dead/misbehaving parent ends its own session only; the
            # parent side is where it surfaces as WorkerFailure
            status = f"aborted: {exc!r}"
        finally:
            try:
                conn.close()
            except OSError:
                pass
        with self._lock:
            self.sessions_served += 1
            self.session_results.append(status)

    def serve_forever(self, *, max_sessions: int | None = None,
                      idle_timeout_s: float | None = None) -> None:
        """Accept until ``stop()``; optionally exit after ``max_sessions``
        sessions COMPLETE or after ``idle_timeout_s`` with no live session
        (both for scripted/CI runs so a lost parent can't wedge the host)."""
        self._listener.settimeout(0.25)
        idle_since = time.monotonic()
        while not self._stop.is_set():
            self._sessions = [t for t in self._sessions if t.is_alive()]
            if max_sessions is not None and not self._sessions \
                    and self.sessions_served >= max_sessions:
                break
            if self._sessions:
                idle_since = time.monotonic()
            elif idle_timeout_s is not None \
                    and time.monotonic() - idle_since > idle_timeout_s:
                break
            try:
                conn, peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed under us by stop()
            t = threading.Thread(target=self._run_session, args=(conn, peer),
                                 daemon=True,
                                 name=f"worker-session-{peer[0]}:{peer[1]}")
            self._sessions.append(t)
            t.start()
        self.close()

    def stop(self) -> None:
        self._stop.set()
        self.close()

    def close(self) -> None:
        try:
            self._listener.close()
        except OSError:
            pass
