"""Front-end query server with admission control (DESIGN.md §Net): the JAX
package's ``net/query_server.py`` on the port.

Clients open plain TCP connections speaking the ``repro_torch.net.wire``
framing (the JAX package's: a JAX client queries a port server, and the
reverse) and send ``query`` frames carrying pickled
``serving.engine.Request`` lists.  A single executor thread coalesces everything that arrived across
ALL connections into one ``QueryEngine.execute`` call (the pad-to-bucket
planner was built for exactly this: heterogeneous batches, few shapes), so
concurrency raises batch occupancy instead of contending on the engine.
The executor never touches a socket: replies are handed to per-connection
bounded writer queues, each drained by its own thread — a client that
stops reading its socket stalls (and eventually loses) only its OWN
connection, never the shared executor or other tenants' replies.

Admission control happens BEFORE a request can queue:

  too-large      a frame carrying more requests than could EVER be
                 admitted (``> max_inflight``, or ``> tenant_burst`` when
                 rate limiting is on) is rejected as ``too_large`` with
                 the applicable limit — not with a retry hint that could
                 never come true;
  token bucket   per-tenant rate limit (``tenant_qps``/``tenant_burst``):
                 a tenant above its rate is rejected with
                 ``rate_limited`` + a retry-after hint sized to when its
                 bucket refills — one hot tenant cannot starve the rest;
  in-flight cap  a global bounded budget (``max_inflight`` REQUESTS queued
                 or executing): past it, requests are fast-rejected with
                 ``overloaded`` + a retry-after hint from the measured
                 per-request service EWMA — overload degrades into an
                 accounted shed rate with bounded latency for admitted
                 work, never into an unbounded queue.

Every shed is counted in ``stats()`` (``shed_overload`` /
``shed_rate_limited`` / ``shed_too_large``); ``offered == admitted +
shed`` always — a request is either answered, errored, or visibly
rejected, never silently dropped.

Security: the wire decodes through the restricted unpickler, non-loopback
binds require a shared auth token (``wire.check_bind_allowed``), and with
a token configured every connection must open with an ``auth`` frame
before anything else is honoured.

Answers are epoch-stamped (the snapshot epoch they were computed against)
so a client can detect staleness against the ingest frontier it expects.

On the card the executor thread launches the engine's kernels on the
device's default stream, the stream the runtime's receive threads adopt
publishes on, so a front is complete before any query issued after its
swap reads it.
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import socket
import threading
import time
from collections import deque
from typing import Callable

from repro_torch.net import wire
from repro_torch.net.ingest_server import scrape_payload
from repro_torch.obs.hub import get_hub
from repro_torch.obs.trace import get_trace_log, new_trace_id


class TokenBucket:
    """Classic token bucket; ``take`` returns 0.0 on success or the time
    until enough tokens accrue (the retry-after hint)."""

    def __init__(self, rate: float, burst: float) -> None:
        if not (rate > 0 and burst > 0):
            raise ValueError(f"a token bucket needs rate > 0 and burst > 0, "
                             f"got rate={rate}, burst={burst}")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = time.monotonic()

    def take(self, n: float = 1.0) -> float:
        now = time.monotonic()
        self.tokens = min(self.burst, self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= n:
            self.tokens -= n
            return 0.0
        return (n - self.tokens) / self.rate


@dataclasses.dataclass
class _Call:
    """One admitted query frame waiting for the executor."""

    send: Callable[[tuple], None]
    req_id: int
    requests: list
    trace_id: str = ""       # span minted at accept (obs.trace)
    accepted_at: float = 0.0  # perf_counter at admission


class _ConnWriter:
    """Bounded per-connection reply writer.

    ``send`` enqueues and returns immediately; a dedicated thread does the
    actual socket writes under the frame deadline.  If the queue overflows
    (client stopped reading) or a write stalls past its deadline, the
    connection is torn down and every later ``send`` raises
    ``ConnectionError`` — the slow client pays, nobody else waits.
    """

    def __init__(self, conn: socket.socket, *, deadline_s: float,
                 max_pending: int, name: str) -> None:
        self._conn = conn
        self._deadline_s = deadline_s
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=max_pending)
        self._dead = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    def send(self, msg: tuple) -> None:
        if self._dead.is_set():
            raise ConnectionError("reply writer closed")
        try:
            self._q.put_nowait(msg)
        except queue_mod.Full:
            self.kill()
            raise ConnectionError(
                "client stopped reading: reply queue overflowed, "
                "connection dropped") from None

    def kill(self) -> None:
        """Tear the connection down; also unblocks the connection's reader."""
        self._dead.set()
        try:
            self._conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._conn.close()
        except OSError:
            pass

    def close(self) -> None:
        """Stop the writer (pending replies to a gone client are dropped)."""
        self._dead.set()

    def _loop(self) -> None:
        while True:
            try:
                msg = self._q.get(timeout=0.2)
            except queue_mod.Empty:
                if self._dead.is_set():
                    return
                continue
            try:
                wire.send_message(self._conn, msg,
                                  deadline_s=self._deadline_s)
            except (ConnectionError, TimeoutError, OSError):
                self.kill()
                return


class Rejected(RuntimeError):
    """Client-side view of an admission rejection."""

    def __init__(self, reason: str, retry_after_ms: float) -> None:
        self.reason = reason
        self.retry_after_ms = retry_after_ms
        super().__init__(f"rejected ({reason}); retry after "
                         f"{retry_after_ms:.1f} ms")


class QueryServer:
    """Coalescing TCP front-end over one ``QueryEngine``.

    ``engine`` only needs an ``execute(snapshot, requests) -> list[Result]``
    — the plain ``QueryEngine`` and ``ShardedQueryEngine`` both qualify.
    ``snapshot_fn`` is polled per batch, so a concurrently-ingesting tenant
    serves fresh epochs mid-run (same contract as ``OpenLoopLoadGen``).
    """

    def __init__(self, engine, snapshot_fn, *, host: str = "127.0.0.1",
                 port: int = 0, max_inflight: int = 4096,
                 batch_max: int = 1024, tenant_qps: float = 0.0,
                 tenant_burst: float | None = None,
                 info: dict | None = None,
                 frame_deadline_s: float = 60.0,
                 auth_token: str | None = None,
                 reply_queue_max: int = 256) -> None:
        self.engine = engine
        self.snapshot_fn = snapshot_fn
        self.max_inflight = int(max_inflight)
        self.batch_max = int(batch_max)
        self.tenant_qps = float(tenant_qps)  # 0 ⇒ rate limiting off
        self.tenant_burst = float(tenant_burst if tenant_burst is not None
                                  else max(1.0, tenant_qps))
        self.info = dict(info or {})
        self.frame_deadline_s = frame_deadline_s
        self.auth_token = wire.resolve_auth_token(auth_token)
        self.reply_queue_max = int(reply_queue_max)
        wire.check_bind_allowed(host, self.auth_token, "QueryServer")
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(256)
        self.address: tuple[str, int] = self._listener.getsockname()[:2]
        self._cv = threading.Condition()
        self._pending: deque[_Call] = deque()  # guarded-by: _cv
        self._inflight = 0  # admitted, not yet answered; guarded-by: _cv
        self._buckets: dict[str, TokenBucket] = {}  # guarded-by: _cv
        self._service_ewma_ms = 1.0  # service-time est.; guarded-by: _cv
        self._stats = {  # guarded-by: _cv
            "offered_requests": 0,
            "admitted_requests": 0,
            "served_requests": 0,
            "errored_requests": 0,
            "shed_overload": 0,
            "shed_rate_limited": 0,
            "shed_too_large": 0,
            "auth_failures": 0,
            "batches": 0,
            "max_batch": 0,
            "connections": 0,
        }
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._trace = get_trace_log()
        # typed instruments: per-request accept->reply latency and batch
        # occupancy live in mergeable histograms; the admission ledger is
        # mirrored into hub counters by a scrape-time collector so the
        # admission hot path pays nothing extra
        hub = get_hub()
        self._hub_latency = hub.histogram(
            "repro_query_latency_seconds",
            "per-request accept->reply latency")
        self._hub_batch = hub.histogram(
            "repro_query_batch_requests",
            "requests coalesced per executor batch", ladder="size")

    def _collect_hub(self) -> None:
        """Scrape-time mirror of the admission ledger into hub counters —
        exact parity with ``stats()`` at every scrape."""
        s = self.stats()
        hub = get_hub()
        for key in ("offered_requests", "admitted_requests",
                    "served_requests", "errored_requests", "shed_overload",
                    "shed_rate_limited", "shed_too_large", "auth_failures",
                    "batches", "connections"):
            hub.counter(f"repro_query_{key}_total",
                        f"query server ledger: {key}").set(s[key])
        hub.gauge("repro_query_inflight",
                  "admitted requests not yet answered").set(s["inflight"])
        hub.gauge("repro_query_service_ewma_ms",
                  "per-request service time estimate"
                  ).set(s["service_ewma_ms"])

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "QueryServer":
        get_hub().add_collector(self._collect_hub)
        acceptor = threading.Thread(target=self._accept_loop, daemon=True,
                                    name="query-accept")
        executor = threading.Thread(target=self._execute_loop, daemon=True,
                                    name="query-exec")
        self._threads = [acceptor, executor]
        acceptor.start()
        executor.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._collect_hub()  # freeze final ledger values, then detach
        get_hub().remove_collector(self._collect_hub)
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._cv:
            self._cv.notify_all()
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass
        deadline = time.monotonic() + timeout
        for t in self._threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.01))

    def stats(self) -> dict:
        # everything — counters, inflight AND the ewma — reads under the
        # lock the executor writes them under, so a stats() snapshot is
        # internally consistent, never torn against the counters
        with self._cv:
            s = dict(self._stats)
            s["inflight"] = self._inflight
            s["service_ewma_ms"] = round(self._service_ewma_ms, 4)
        return s

    # ----------------------------------------------------------- connections
    def _accept_loop(self) -> None:
        self._listener.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            with self._cv:
                self._stats["connections"] += 1
            t = threading.Thread(target=self._client_loop, args=(conn,),
                                 daemon=True,
                                 name=f"query-client-{peer[0]}:{peer[1]}")
            self._threads.append(t)
            t.start()

    def _client_loop(self, conn: socket.socket) -> None:
        try:
            peer = conn.getpeername()
        except OSError:
            peer = ("?", 0)
        writer = _ConnWriter(conn, deadline_s=self.frame_deadline_s,
                             max_pending=self.reply_queue_max,
                             name=f"query-write-{peer[0]}:{peer[1]}")
        send = writer.send
        authed = not self.auth_token
        try:
            while not self._stop.is_set():
                msg = wire.recv_message(conn, poll_s=0.2,
                                        frame_deadline_s=self.frame_deadline_s)
                if msg is None:
                    continue
                kind = msg[0]
                if kind == "auth":
                    # tolerated (and ignored) when no token is configured,
                    # so clients may always present their token
                    if self.auth_token and not wire.auth_matches(
                            self.auth_token, msg[1] if len(msg) > 1 else None):
                        break  # counted below; never name which part failed
                    authed = True
                    continue
                if not authed:
                    break
                if kind == "query":
                    self._admit(send, msg[1])
                elif kind == "metrics_req":
                    # scrape surface; sits behind the same auth gate as
                    # query frames (the `authed` check above)
                    send(("metrics", scrape_payload()))
                elif kind == "info_req":
                    snap = self.snapshot_fn()
                    send(("info", {**self.info, "epoch": snap.epoch,
                                   "n_edges": snap.n_edges,
                                   "stats": self.stats()}))
                elif kind == "ping":
                    send(("pong",))
                else:
                    send(("error", {"error": f"unexpected frame {kind!r}"}))
            else:
                authed = True  # server stop, not an auth problem
            if not authed:
                with self._cv:
                    self._stats["auth_failures"] += 1
                try:
                    send(("error", {"error": "auth required"}))
                except (ConnectionError, TimeoutError, OSError):
                    pass
        except (ConnectionError, TimeoutError, OSError, wire.WireError):
            pass  # client went away (or spoke junk); its session only
        finally:
            writer.close()
            try:
                conn.close()
            except OSError:
                pass

    # -------------------------------------------------------------- admission
    def _retry_after_ms(self, n_queued: int) -> float:  # requires-lock: _cv
        # time until the current backlog is worked off, from the measured
        # per-request service EWMA — an honest Retry-After, not a constant
        return max(1.0, n_queued * self._service_ewma_ms)

    def _admit(self, send, payload: dict) -> None:
        req_id = payload.get("id", 0)
        tenant = str(payload.get("tenant", "default"))
        requests = list(payload.get("requests", ()))
        n = len(requests)
        # a frame bigger than the smallest applicable admission ceiling can
        # NEVER succeed: a finite retry-after would be a lie (the token
        # bucket caps at burst; inflight can only reach max_inflight), so
        # it gets a distinct verdict naming the limit instead
        limit = self.max_inflight
        if self.tenant_qps > 0:
            limit = min(limit, int(self.tenant_burst))
        call = None
        with self._cv:
            self._stats["offered_requests"] += n
            if n > limit:
                self._stats["shed_too_large"] += n
                send_now = ("reject", {"id": req_id, "reason": "too_large",
                                       "retry_after_ms": 0.0,
                                       "max_requests": limit})
            elif self.tenant_qps > 0:
                bucket = self._buckets.get(tenant)
                if bucket is None:
                    bucket = TokenBucket(self.tenant_qps, self.tenant_burst)
                    self._buckets[tenant] = bucket
                wait_s = bucket.take(n)
                if wait_s > 0:
                    self._stats["shed_rate_limited"] += n
                    verdict = ("reject", {"id": req_id,
                                          "reason": "rate_limited",
                                          "retry_after_ms": wait_s * 1e3})
                    send_now = verdict
                else:
                    send_now = None
            else:
                send_now = None
            if send_now is None:
                if self._inflight + n > self.max_inflight:
                    self._stats["shed_overload"] += n
                    send_now = ("reject", {
                        "id": req_id, "reason": "overloaded",
                        "retry_after_ms":
                            self._retry_after_ms(self._inflight + n)})
                else:
                    self._inflight += n
                    self._stats["admitted_requests"] += n
                    call = _Call(send, req_id, requests,
                                 trace_id=new_trace_id(),
                                 accepted_at=time.perf_counter())
                    self._pending.append(call)
                    self._cv.notify()
        if send_now is not None:
            send(send_now)
        elif call is not None:
            self._trace.emit(call.trace_id, "query", "accept",
                             tenant=tenant, n_requests=n)

    # --------------------------------------------------------------- executor
    def _take_batch(self) -> list[_Call]:  # requires-lock: _cv
        """Under ``_cv``: pop whole calls up to ``batch_max`` requests (a
        call is never split; the first call always fits by itself)."""
        calls: list[_Call] = []
        total = 0
        while self._pending:
            nxt = len(self._pending[0].requests)
            if calls and total + nxt > self.batch_max:
                break
            call = self._pending.popleft()
            calls.append(call)
            total += nxt
        return calls

    def _execute_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop.is_set():
                    self._cv.wait(timeout=0.2)
                if self._stop.is_set() and not self._pending:
                    return
                calls = self._take_batch()
            flat = [r for c in calls for r in c.requests]
            for call in calls:
                self._trace.emit(call.trace_id, "query", "plan",
                                 batch=len(flat))
            self._hub_batch.observe(len(flat))
            t0 = time.perf_counter()
            try:
                results = self.engine.execute(self.snapshot_fn(), flat)
                err = None
            except Exception as exc:  # noqa: BLE001 — answer sick, stay up
                results, err = None, repr(exc)
            t1 = time.perf_counter()
            dt_ms = (t1 - t0) * 1e3
            for call in calls:
                self._trace.emit(call.trace_id, "query", "execute",
                                 ms=round(dt_ms, 3), ok=err is None)
            cursor = 0
            for call in calls:
                k = len(call.requests)
                if err is None:
                    part = results[cursor:cursor + k]
                    cursor += k
                    reply = ("result", {
                        "id": call.req_id,
                        "epoch": part[0].epoch if part else None,
                        "values": [r.value for r in part],
                    })
                else:
                    reply = ("error", {"id": call.req_id, "error": err})
                try:
                    # hands off to the connection's writer queue — never a
                    # socket write, so a stalled client cannot block this
                    # loop (it loses its own connection instead)
                    call.send(reply)
                except (ConnectionError, TimeoutError, OSError):
                    pass  # client vanished mid-flight; accounting still runs
                lat_s = time.perf_counter() - call.accepted_at
                self._hub_latency.observe_n(lat_s, k)
                self._trace.emit(call.trace_id, "query", "reply",
                                 ms=round(lat_s * 1e3, 3))
            with self._cv:
                self._inflight -= len(flat)
                if err is None:
                    self._stats["served_requests"] += len(flat)
                    if flat:
                        per_req = dt_ms / len(flat)
                        self._service_ewma_ms += 0.3 * (
                            per_req - self._service_ewma_ms)
                else:
                    self._stats["errored_requests"] += len(flat)
                self._stats["batches"] += 1
                self._stats["max_batch"] = max(self._stats["max_batch"],
                                               len(flat))


# ---------------------------------------------------------------- client --


class QueryClient:
    """Minimal blocking client: one outstanding query per connection (the
    load generator opens one client per connection for concurrency)."""

    def __init__(self, address: tuple[str, int], *, tenant: str = "default",
                 connect_timeout_s: float = 30.0,
                 frame_deadline_s: float = 60.0,
                 auth_token: str | None = None) -> None:
        self.address = tuple(address)
        self.tenant = tenant
        self.frame_deadline_s = frame_deadline_s
        self._sock = wire.connect_with_retry(self.address,
                                             deadline_s=connect_timeout_s)
        self._next_id = 0
        token = wire.resolve_auth_token(auth_token)
        if token:  # must be the first frame; servers without a token ignore it
            wire.send_message(self._sock, ("auth", token),
                              deadline_s=frame_deadline_s)

    def _rpc(self, msg: tuple, *, timeout_s: float | None = None) -> tuple:
        wire.send_message(self._sock, msg, deadline_s=self.frame_deadline_s)
        deadline = time.monotonic() + (timeout_s or self.frame_deadline_s)
        while True:
            reply = wire.recv_message(self._sock, poll_s=0.2,
                                      frame_deadline_s=self.frame_deadline_s)
            if reply is not None:
                return reply
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"no reply to {msg[0]!r} within {timeout_s}s")

    def info(self) -> dict:
        reply = self._rpc(("info_req",))
        if reply[0] != "info":
            raise wire.WireError(f"expected info, got {reply[0]!r}")
        return reply[1]

    def metrics(self) -> dict:
        """Scrape the server's telemetry hub: ``{"prometheus": text,
        "state": merged_state, "ts": ...}``."""
        reply = self._rpc(("metrics_req",))
        if reply[0] != "metrics":
            raise wire.WireError(f"expected metrics, got {reply[0]!r}")
        return reply[1]

    def call(self, requests: list, *, timeout_s: float | None = None) -> dict:
        """Low-level: returns the reply payload dict with a ``"kind"`` key
        (``result`` | ``reject`` | ``error``); never raises on rejection."""
        self._next_id += 1
        reply = self._rpc(("query", {"id": self._next_id,
                                     "tenant": self.tenant,
                                     "requests": list(requests)}),
                          timeout_s=timeout_s)
        kind, payload = reply[0], dict(reply[1])
        if kind not in ("result", "reject", "error"):
            raise wire.WireError(f"unexpected reply frame {kind!r}")
        if payload.get("id") not in (None, self._next_id):
            raise wire.WireError(
                f"reply id {payload.get('id')} does not match request "
                f"{self._next_id} (protocol requires one outstanding query)")
        payload["kind"] = kind
        return payload

    def query(self, requests: list, *, timeout_s: float | None = None):
        """Returns ``(values, epoch)``; raises :class:`Rejected` on an
        admission rejection and ``RuntimeError`` on a server-side error."""
        payload = self.call(requests, timeout_s=timeout_s)
        if payload["kind"] == "reject":
            raise Rejected(payload["reason"], payload["retry_after_ms"])
        if payload["kind"] == "error":
            raise RuntimeError(f"server error: {payload['error']}")
        return payload["values"], payload["epoch"]

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
