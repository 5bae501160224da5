"""Versioned length-prefixed wire protocol: the JAX package's
``net/wire.py`` on the port, byte for byte on the wire.

One codec, two transports.  Every message that crosses a worker boundary —
whether over the process backend's multiprocessing pipe or a TCP socket —
is framed as::

    MAGIC(4) | WIRE_VERSION(u16) | FRAME_TYPE(u16) | LENGTH(u32) | PAYLOAD

with the payload a pickled message tuple ``(kind, ...)`` for CONTROL
frames, and — since v3 — a raw columnar layout for the two hot-path
payloads: ``item_cols`` frames carry an edge batch as a fixed struct
header plus the src/dst/weight column buffers verbatim (encoded by buffer
concatenation, decoded with ``np.frombuffer`` views — no pickle anywhere
on the item path), and delta publishes ride a compact per-leaf
sparse/dense encoding (:func:`encode_leaves`).  The header exists so a
version skew or a torn stream fails as a loud :class:`WireError` naming the
mismatch instead of a pickle-level crash deep inside a worker.  The frame
registry, header and columnar layout are the reference's schema v3 (its
``wire_schema.lock``), so a port peer and a JAX peer speak to each other.

Wire types.  Three dataclasses travel pickled: the worker spec
(``_ChildSpec``, in ``hello`` frames), the tenant rebuild spec
(``TenantOrigin``, inside it) and the query (``Request``, in ``query``
frames).  On the wire they carry the JAX package's module and class names
(``repro.runtime.backend._ChildSpec`` …), which is what a JAX peer's
unpickler admits; the port's unpickler admits those same names and maps
them to the port's twins.  Frames of those two kinds are pickled by
:class:`_ReferencePickler`, which writes the reference names; every other
kind goes through the C pickler and carries no project class at all.
Payloads hold numpy arrays and plain containers, never a tensor.

Deadline discipline (no hangs by construction): the socket receive path
separates *idle* from *mid-frame* waiting.  ``recv_message`` polls up to
``poll_s`` for the first byte and returns ``None`` if the peer is merely
quiet, but once a frame has started the remainder must arrive within
``frame_deadline_s`` or the read raises — a peer that wedges halfway
through a frame can never hang its reader.

Payload trust: frames are decoded with a RESTRICTED unpickler.  Only the
three wire types, numpy array/scalar reconstruction, and a short
builtins/collections allowlist may appear as pickle globals; anything else
(``os.system``, ``builtins.eval``, any ``torch`` or ``repro_torch``
global, ...) raises :class:`WireError` instead of executing — a crafted
frame from a hostile peer cannot become remote code execution.  On top of
that, listeners refuse to bind non-loopback addresses unless a shared auth
token is configured (:func:`check_bind_allowed`); with a token set, every
connection must open with an ``auth`` frame carrying it before any other
traffic is honoured.
"""
from __future__ import annotations

import hmac
import importlib
import io
import os
import pickle
import socket
import struct
import time

import numpy as np

from repro_torch.obs.hub import get_hub

MAGIC = b"KMTX"
# Version history (DESIGN.md §Observability: bump on ANY schema change a
# v(N-1) peer could misread — new frame types, new positional fields):
#   1  the first schema
#   2  `item` frames append trace_id; metrics_req scrape frame; publish/
#      metrics/stopped payloads may carry an "obs" telemetry member
#   3  columnar `item_cols` frames (raw src/dst/weight buffers, no pickle
#      on the item path); `resync` control frame; publish payloads become
#      dicts carrying a "mode" (full | delta) and, for deltas, sparse-
#      encoded leaves + a base_epoch.  v2 frames still DECODE during the
#      bump window (old `item`/`publish` shapes parse via *rest / dict
#      defaults) but this build always SENDS v3.
WIRE_VERSION = 3
# Decode-side compat window: a v2 peer's frames carry no field this build
# misreads (v3 only ADDS types and payload members), so both versions are
# accepted on receive.  Anything else is loud skew.
COMPAT_VERSIONS = frozenset({2, WIRE_VERSION})

_HEADER = struct.Struct(">4sHHI")
HEADER_SIZE = _HEADER.size

# A 256 KB sketch budget times a handful of leaves plus pickling overhead is
# well under a megabyte; 1 GiB is a generous ceiling that still catches a
# corrupt length field before it turns into an absurd allocation.
MAX_PAYLOAD = 1 << 30

# Frame types are part of the protocol: an unknown kind fails at encode time
# on the sender, and a type/kind disagreement fails at decode time on the
# receiver (it means the stream is torn or the peer speaks another schema).
FRAME_TYPES: dict[str, int] = {
    # worker ingest transport (same kinds the process backend uses)
    "hello": 1,
    "ready": 2,
    "item": 3,
    "publish": 4,
    "metrics": 5,
    "checkpoint": 6,
    "checkpointed": 7,
    "stop": 8,
    "stopped": 9,
    "failed": 10,
    # telemetry scrape: reply is a "metrics" frame carrying the hub's
    # Prometheus text + merged state (served by BOTH the ingest worker
    # host and the query front-end; requires auth when a token is set)
    "metrics_req": 11,
    # v3 hot path: columnar edge batch (raw buffers, decodes to the same
    # ("item", ...) tuple) and the parent->worker full-resync request
    # (next publish must ship full leaves, not a delta)
    "item_cols": 12,
    "resync": 13,
    # query front-end
    "info_req": 20,
    "info": 21,
    "query": 22,
    "result": 23,
    "reject": 24,
    "error": 25,
    # liveness
    "ping": 30,
    "pong": 31,
    # connection auth (first frame when a shared token is configured)
    "auth": 40,
}
_KIND_BY_TYPE = {v: k for k, v in FRAME_TYPES.items()}


class WireError(ValueError):
    """A frame violated the protocol (bad magic/version/type/length)."""


# ---------------------------------------------------------------------------
# restricted payload decoding
#
# pickle.loads on bytes from a TCP peer is remote code execution by design
# (any global reachable by name can be called during load).  Wire payloads
# only ever carry our own dataclasses plus numpy leaves and plain
# containers, so the unpickler allowlists exactly that surface and treats
# every other global as a torn/hostile stream.

_SAFE_BUILTINS = frozenset({
    "complex", "bytearray", "set", "frozenset", "range", "slice"})
_SAFE_COLLECTIONS = frozenset({"deque", "OrderedDict"})
# numpy's own pickle machinery (1.x uses numpy.core.*, 2.x numpy._core.*)
_NUMPY_RECONSTRUCT_MODULES = frozenset({
    "numpy.core.multiarray", "numpy._core.multiarray",
    "numpy.core.numeric", "numpy._core.numeric"})
_NUMPY_RECONSTRUCT_NAMES = frozenset({
    "_reconstruct", "scalar", "_frombuffer"})
_NUMPY_TOPLEVEL_NAMES = frozenset({
    "ndarray", "dtype", "bool_", "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "float16", "float32",
    "float64", "complex64", "complex128", "intc", "uintc", "intp",
    "uintp", "longlong", "ulonglong", "half", "single", "double",
    "longdouble", "csingle", "cdouble", "clongdouble", "str_", "bytes_"})

# The ONLY project classes a wire payload may materialise: the JAX
# package's three wire types, by the reference's module and class names
# (what a JAX peer writes and admits), each mapped to the port module that
# holds its twin (same fields, same order).
_SAFE_REPRO_CLASSES: dict[str, frozenset] = {
    "repro.runtime.backend": frozenset({"_ChildSpec"}),   # hello frames
    "repro.serving.registry": frozenset({"TenantOrigin"}),  # _ChildSpec.origin
    "repro.serving.engine": frozenset({"Request"}),       # query frames
}
_PORT_MODULES = {
    "repro.runtime.backend": "repro_torch.runtime.backend",
    "repro.serving.registry": "repro_torch.serving.registry",
    "repro.serving.engine": "repro_torch.serving.engine",
}
_REFERENCE_MODULES = {port: ref for ref, port in _PORT_MODULES.items()}
# frame kinds whose payload carries a wire type (pickled with the
# reference's names); every other kind carries none
_WIRE_TYPE_KINDS = frozenset({"hello", "query"})


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if name in _SAFE_REPRO_CLASSES.get(module, ()):
            # the port's twin; imported here, since those modules import
            # this one
            return getattr(importlib.import_module(_PORT_MODULES[module]),
                           name)
        allowed = (
            (module == "builtins" and name in _SAFE_BUILTINS)
            or (module == "collections" and name in _SAFE_COLLECTIONS)
            or (module in _NUMPY_RECONSTRUCT_MODULES
                and name in _NUMPY_RECONSTRUCT_NAMES)
            or (module == "numpy" and name in _NUMPY_TOPLEVEL_NAMES)
            or (module == "numpy.dtypes" and name.endswith("DType"))
        )
        if not allowed:
            raise pickle.UnpicklingError(
                f"global {module}.{name} is not allowed in a wire payload")
        return super().find_class(module, name)


class _ReferencePickler(pickle._Pickler):
    """The pure-Python pickler, writing each port wire type under the JAX
    package's module and class name (a JAX peer admits only those).  The
    C pickler cannot: it checks that a global is importable under the name
    it writes.  Slower than the C pickler, so only the kinds in
    ``_WIRE_TYPE_KINDS`` use it."""

    def save_global(self, obj, name=None):
        module = _REFERENCE_MODULES.get(getattr(obj, "__module__", None))
        qualname = getattr(obj, "__qualname__", None)
        if module is None or qualname not in _SAFE_REPRO_CLASSES[module]:
            return super().save_global(obj, name)
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _dumps(msg: tuple) -> bytes:
    if msg[0] not in _WIRE_TYPE_KINDS:
        return pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
    buf = io.BytesIO()
    _ReferencePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(msg)
    return buf.getvalue()


def restricted_loads(data: bytes):
    """``pickle.loads`` limited to the wire's allowlisted globals."""
    return _RestrictedUnpickler(io.BytesIO(data)).load()


# ---------------------------------------------------------------------------
# bind policy + connection auth

AUTH_TOKEN_ENV = "KMATRIX_NET_TOKEN"


def resolve_auth_token(explicit: str | None = None) -> str:
    """Explicit token, else ``$KMATRIX_NET_TOKEN``, else ``""`` (off)."""
    if explicit:
        return str(explicit)
    return os.environ.get(AUTH_TOKEN_ENV, "")


def is_loopback_host(host: str) -> bool:
    return host == "localhost" or host == "::1" or host.startswith("127.")


def check_bind_allowed(host: str, auth_token: str, what: str) -> None:
    """Refuse a non-loopback listener with no auth configured.

    The wire carries pickled payloads; even with the restricted unpickler
    an open port is an ingest/query surface for anyone who can reach it.
    Loopback binds are the default and always allowed; binding a routable
    address is an explicit opt-in that requires a shared token
    (``--auth-token`` / ``$KMATRIX_NET_TOKEN``) every peer must present in
    an ``auth`` frame before any other traffic.
    """
    if auth_token or is_loopback_host(host):
        return
    raise ValueError(
        f"{what} refuses to bind non-loopback address {host!r} without an "
        f"auth token: pass auth_token=/--auth-token or set "
        f"${AUTH_TOKEN_ENV}, or bind 127.0.0.1")


def auth_matches(expected: str, presented: object) -> bool:
    return isinstance(presented, str) and hmac.compare_digest(
        expected, presented)


# ---------------------------------------------------------------------------
# wire byte accounting (DESIGN.md §Observability)
#
# Counted at the codec, per frame kind, so pipe bytes and socket bytes land
# in the same instruments.  ``on_wire=False`` callers (the spill-file FIFO,
# replayed captures) skip accounting — those bytes never cross a transport.

def _note_bytes(sent: bool, kind: str, nbytes: int) -> None:
    hub = get_hub()
    if sent:
        hub.counter("wire_bytes_sent",
                    "bytes encoded for a transport, by frame kind",
                    kind=kind).inc(nbytes)
    else:
        hub.counter("wire_bytes_recv",
                    "bytes decoded off a transport, by frame kind",
                    kind=kind).inc(nbytes)
        if kind == "publish":
            # the receiver of publish frames is always the adopting parent,
            # so this counter reads as "snapshot publication bytes adopted"
            hub.counter("publish_bytes",
                        "snapshot publication payload bytes adopted").inc(
                            nbytes)


def encode_message(msg: tuple, *, on_wire: bool = True) -> bytes:
    """Frame a ``(kind, ...)`` message tuple as header + pickled payload."""
    if not isinstance(msg, tuple) or not msg or not isinstance(msg[0], str):
        raise WireError(f"wire messages are ('kind', ...) tuples, got {type(msg).__name__}")
    ftype = FRAME_TYPES.get(msg[0])
    if ftype is None:
        raise WireError(f"unknown wire message kind {msg[0]!r}; known kinds: {sorted(FRAME_TYPES)}")
    payload = _dumps(msg)
    if len(payload) > MAX_PAYLOAD:
        raise WireError(f"payload of {len(payload)} bytes exceeds MAX_PAYLOAD={MAX_PAYLOAD}")
    if on_wire:
        _note_bytes(True, msg[0], HEADER_SIZE + len(payload))
    return _HEADER.pack(MAGIC, WIRE_VERSION, ftype, len(payload)) + payload


def decode_header(header: bytes) -> tuple[str, int]:
    """Validate a frame header; returns ``(kind, payload_length)``."""
    if len(header) != HEADER_SIZE:
        raise WireError(f"short frame header: got {len(header)} bytes, need {HEADER_SIZE}")
    magic, version, ftype, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} (expected {MAGIC!r}): not a kmatrix wire stream")
    if version not in COMPAT_VERSIONS:
        raise WireError(
            f"wire schema version mismatch: peer speaks v{version}, this "
            f"build speaks v{WIRE_VERSION} "
            f"(accepts {sorted(COMPAT_VERSIONS)})")
    kind = _KIND_BY_TYPE.get(ftype)
    if kind is None:
        raise WireError(f"unknown frame type {ftype}")
    if length > MAX_PAYLOAD:
        raise WireError(f"frame length {length} exceeds MAX_PAYLOAD={MAX_PAYLOAD}")
    return kind, length


def decode_message(buf: bytes, *, on_wire: bool = True) -> tuple:
    """Inverse of :func:`encode_message`; loud on any header/body mismatch.

    ``item_cols`` frames decode through the columnar path into the exact
    ``("item", offset, src, dst, weight, n_edges, trace_id)`` tuple the
    pickled v2 ``item`` frame carried, so every downstream consumer is
    layout-agnostic.
    """
    kind, length = decode_header(bytes(buf[:HEADER_SIZE]))
    # one copy, as slicing bytes makes, but into writable memory: the
    # columns of an item frame are views over it, and torch warns about
    # (and may not alias) read-only numpy columns when it makes a batch
    body = bytearray(memoryview(buf)[HEADER_SIZE:])
    if len(body) != length:
        raise WireError(
            f"truncated frame: header promises {length} payload bytes, got {len(body)}")
    if on_wire:
        _note_bytes(False, kind, len(buf))
    if kind == "item_cols":
        return _decode_item_cols(body)
    try:
        msg = restricted_loads(body)
    except Exception as exc:  # noqa: BLE001 — surface as protocol error
        raise WireError(f"undecodable {kind!r} payload: {exc!r}") from exc
    if not isinstance(msg, tuple) or not msg or msg[0] != kind:
        got = msg[0] if isinstance(msg, tuple) and msg else type(msg).__name__
        raise WireError(f"frame type says {kind!r} but payload says {got!r}")
    return msg


# ---------------------------------------------------------------------------
# v3 columnar edge frames: the item hot path without pickle
#
# Payload layout (big-endian), validated field by field on decode:
#
#   offset(i64) n_edges(i64) | n_src(u32) n_dst(u32) n_weight(u32)
#   | dtype_src(8s) dtype_dst(8s) dtype_weight(8s) | trace_len(u16)
#   | trace_id utf-8 | src bytes | dst bytes | weight bytes
#
# Encode is buffer concatenation (one copy of each column into the output
# frame); decode is three ``np.frombuffer`` views over the received body —
# read-only, zero-copy.  Every length/dtype disagreement is a WireError.

_ITEM_COLS = struct.Struct(">qqIII8s8s8sH")

# dtypes a column may legally carry: fixed-width integer/float scalars.
# Anything else (object, structured, zero-itemsize) is a hostile or torn
# frame — np.frombuffer on attacker-chosen dtypes is not a surface we keep.
_COL_KINDS = frozenset("iuf")


def _col_dtype(tag: bytes, what: str) -> np.dtype:
    try:
        dt = np.dtype(tag.rstrip(b"\x00").decode("ascii"))
    except (TypeError, ValueError, UnicodeDecodeError) as exc:
        raise WireError(
            f"columnar item frame carries undecodable {what} dtype "
            f"{tag!r}: {exc!r}") from exc
    if dt.kind not in _COL_KINDS or not 1 <= dt.itemsize <= 8:
        raise WireError(
            f"columnar item frame carries disallowed {what} dtype {dt.str!r}"
            " (fixed-width int/float scalars only)")
    return dt


def encode_item_frame(item, *, on_wire: bool = True) -> bytes:  # hot-path
    """Frame one ``QueueItem``-shaped batch as a v3 columnar frame.

    ``item`` is duck-typed (``offset / src / dst / weight / n_edges /
    trace_id``) so both the runtime's queue items and ad-hoc tuples frame
    identically.  Columns are shipped in their native dtype.
    """
    cols = []
    for what in ("src", "dst", "weight"):
        a = np.ascontiguousarray(getattr(item, what))
        if a.ndim != 1:
            raise WireError(
                f"columnar item frame needs 1-D columns; {what} has shape "
                f"{a.shape}")
        if a.dtype.kind not in _COL_KINDS or not 1 <= a.dtype.itemsize <= 8:
            raise WireError(
                f"column {what} has unframeable dtype {a.dtype.str!r}")
        cols.append(a)
    src, dst, weight = cols
    trace = str(getattr(item, "trace_id", "") or "").encode("utf-8")
    if len(trace) > 0xFFFF:
        raise WireError(f"trace_id of {len(trace)} bytes exceeds 65535")
    length = (_ITEM_COLS.size + len(trace)
              + src.nbytes + dst.nbytes + weight.nbytes)
    if length > MAX_PAYLOAD:
        raise WireError(
            f"columnar payload of {length} bytes exceeds "
            f"MAX_PAYLOAD={MAX_PAYLOAD}")
    frame = b"".join((
        _HEADER.pack(MAGIC, WIRE_VERSION, FRAME_TYPES["item_cols"], length),
        _ITEM_COLS.pack(int(item.offset), int(item.n_edges),
                        src.size, dst.size, weight.size,
                        src.dtype.str.encode("ascii").ljust(8, b"\x00"),
                        dst.dtype.str.encode("ascii").ljust(8, b"\x00"),
                        weight.dtype.str.encode("ascii").ljust(8, b"\x00"),
                        len(trace)),
        trace, src.data, dst.data, weight.data))
    if on_wire:
        _note_bytes(True, "item", len(frame))
    return frame


def _decode_item_cols(body: bytes) -> tuple:  # hot-path
    """Columnar payload -> the canonical ``("item", ...)`` message tuple."""
    if len(body) < _ITEM_COLS.size:
        raise WireError(
            f"truncated columnar item header: got {len(body)} bytes, need "
            f"{_ITEM_COLS.size}")
    (offset, n_edges, n_src, n_dst, n_weight,
     dt_src, dt_dst, dt_weight, trace_len) = _ITEM_COLS.unpack_from(body)
    if not (n_src == n_dst == n_weight):
        raise WireError(
            f"columnar item frame has ragged columns: src={n_src} "
            f"dst={n_dst} weight={n_weight}")
    if not 0 <= n_edges <= n_src:
        raise WireError(
            f"columnar item frame claims {n_edges} non-padding edges in "
            f"{n_src}-row columns")
    dts = _col_dtype(dt_src, "src")
    dtd = _col_dtype(dt_dst, "dst")
    dtw = _col_dtype(dt_weight, "weight")
    expect = (_ITEM_COLS.size + trace_len + n_src * dts.itemsize
              + n_dst * dtd.itemsize + n_weight * dtw.itemsize)
    if expect != len(body):
        raise WireError(
            f"columnar item frame length mismatch: header describes "
            f"{expect} payload bytes, got {len(body)}")
    pos = _ITEM_COLS.size
    try:
        trace = body[pos:pos + trace_len].decode("utf-8")
    except UnicodeDecodeError as exc:
        raise WireError(f"undecodable trace_id bytes: {exc!r}") from exc
    pos += trace_len
    src = np.frombuffer(body, dtype=dts, count=n_src, offset=pos)
    pos += n_src * dts.itemsize
    dst = np.frombuffer(body, dtype=dtd, count=n_dst, offset=pos)
    pos += n_dst * dtd.itemsize
    weight = np.frombuffer(body, dtype=dtw, count=n_weight, offset=pos)
    return ("item", int(offset), src, dst, weight, int(n_edges), trace)


# ---------------------------------------------------------------------------
# delta-publish leaf codec
#
# A publish delta is an ``empty_like`` twin of the front sketch — same DENSE
# shape — so shipping it verbatim would cost exactly a full publish.  The
# savings come from per-leaf ADAPTIVE encoding: a leaf whose nonzero cells
# are sparse ships as (flat indices, values); one that is mostly nonzero
# (or tiny) ships dense.  Reconstruction is exact (indices + verbatim
# values), so the parent-side merge stays bit-identical to the
# child's own publish.  Entries are plain numpy-only tuples, so they pass
# the restricted unpickler inside the publish control frame unchanged.

def encode_leaves(leaves: list) -> list:
    """Per-leaf adaptive sparse/dense encoding of a delta pytree's leaves."""
    out = []
    for leaf in leaves:
        a = np.asarray(leaf)
        if a.ndim == 0 or a.size == 0 or a.size >= (1 << 32):
            out.append(("dense", a))
            continue
        flat = a.ravel()
        idx = np.flatnonzero(flat)
        # 4 index bytes + one value per nonzero vs the dense leaf
        if idx.size * (4 + a.dtype.itemsize) < a.nbytes:
            out.append(("sparse", a.shape, a.dtype.str,
                        idx.astype(np.uint32), np.ascontiguousarray(flat[idx])))
        else:
            out.append(("dense", a))
    return out


def decode_leaves(entries: list) -> list:
    """Inverse of :func:`encode_leaves`; loud on malformed entries."""
    leaves = []
    for e in entries:
        tag = e[0] if isinstance(e, tuple) and e else None
        if tag == "dense":
            leaves.append(np.asarray(e[1]))
        elif tag == "sparse":
            _, shape, dtstr, idx, vals = e
            size = int(np.prod(shape, dtype=np.int64)) if shape else 1
            if idx.size != vals.size or (idx.size and int(idx.max()) >= size):
                raise WireError(
                    f"sparse leaf entry indices do not fit shape {shape}")
            flat = np.zeros(size, dtype=np.dtype(dtstr))
            flat[idx] = vals
            leaves.append(flat.reshape(shape))
        else:
            raise WireError(f"unknown leaf encoding {tag!r}")
    return leaves


# ---------------------------------------------------------------------------
# socket transport


def send_message(sock: socket.socket, msg: tuple, *,
                 deadline_s: float = 120.0) -> None:
    """Frame and send ``msg``; raises ``TimeoutError`` past ``deadline_s``."""
    sock.settimeout(deadline_s)
    try:
        sock.sendall(encode_message(msg))
    except socket.timeout as exc:
        raise TimeoutError(
            f"send of {msg[0]!r} frame did not complete within {deadline_s}s") from exc


def send_frame(sock: socket.socket, frame: bytes, *,  # hot-path
               deadline_s: float = 120.0) -> None:
    """Send an already-encoded frame (e.g. :func:`encode_item_frame`)."""
    sock.settimeout(deadline_s)
    try:
        sock.sendall(frame)
    except socket.timeout as exc:
        raise TimeoutError(
            f"send of a {len(frame)}-byte frame did not complete within "
            f"{deadline_s}s") from exc


def _recv_exact(sock: socket.socket, n: int, deadline: float,
                what: str) -> bytes:
    chunks: list[bytes] = []
    got = 0
    while got < n:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(
                f"frame deadline expired mid-{what}: got {got}/{n} bytes")
        sock.settimeout(min(remaining, 1.0))
        try:
            chunk = sock.recv(n - got)
        except socket.timeout:
            continue
        if not chunk:
            raise ConnectionError(
                f"connection closed mid-{what} (short read: {got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_message(sock: socket.socket, *, poll_s: float = 0.2,
                 frame_deadline_s: float = 120.0) -> tuple | None:
    """Receive one frame.

    Returns ``None`` if no frame *starts* within ``poll_s`` (idle peer — the
    caller's poll loop decides what idleness means).  Once the first byte
    arrives the whole frame must land within ``frame_deadline_s``.  A closed
    peer raises ``ConnectionError``; protocol violations raise
    :class:`WireError`.
    """
    sock.settimeout(poll_s)
    try:
        first = sock.recv(1)
    except socket.timeout:
        return None
    if not first:
        raise ConnectionError("connection closed by peer")
    deadline = time.monotonic() + frame_deadline_s
    header = first + _recv_exact(sock, HEADER_SIZE - 1, deadline, "header")
    kind, length = decode_header(header)
    body = _recv_exact(sock, length, deadline, f"{kind!r} payload")
    return decode_message(header + body)


def connect_with_retry(address: tuple[str, int], *, deadline_s: float,
                       stop: "object | None" = None) -> socket.socket:
    """Dial ``address``, retrying refusals until ``deadline_s`` elapses.

    ``stop`` is an optional ``threading.Event``-like object; setting it
    aborts the dial loop (used so ``Runtime.stop()`` can cancel a connect
    that would otherwise spin out its full deadline).
    """
    deadline = time.monotonic() + deadline_s
    last: Exception | None = None
    while time.monotonic() < deadline:
        if stop is not None and stop.is_set():
            raise ConnectionAbortedError(f"dial of {address} cancelled by stop")
        try:
            sock = socket.create_connection(address, timeout=min(2.0, deadline_s))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock
        except OSError as exc:
            last = exc
            time.sleep(0.05)
    raise ConnectionError(
        f"could not connect to {address} within {deadline_s}s: {last!r}")


def parse_hostport(spec: str) -> tuple[str, int]:
    """``"host:port"`` → ``(host, port)`` with a loud error on junk."""
    host, sep, port = spec.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"expected HOST:PORT, got {spec!r}")
    return host, int(port)
