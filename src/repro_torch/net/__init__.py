"""repro_torch.net — the network transport tier (DESIGN.md §Net), the JAX
package's ``repro.net`` on the port; its frames are the JAX package's.

Lets the two serialized runtime seams (``QueueItem``s in, epoch-stamped
snapshot publications out — see ``runtime/backend.py``) cross host
boundaries, and puts a front-end query server with admission control in
front of the batched ``QueryEngine``:

  wire           versioned length-prefixed frames (magic + schema version +
                 frame type + payload); ONE codec shared by the socket
                 transport and the process backend's pipes
  ingest_server  worker-host side: accept a parent connection, rebuild the
                 tenant from the shipped spec, run the standard
                 ``IngestWorker`` loop (``stream_ingest --listen``)
  backend        parent side: ``SocketBackend``/``SocketWorker`` — a third
                 ``ExecutionBackend`` whose workers live across a TCP
                 connection (self-hosted loopback child by default)
  query_server   front-end TCP query server: coalesces concurrent client
                 requests into the pad-to-bucket batch planner, with a
                 bounded in-flight budget (fast-reject + Retry-After hint)
                 and per-tenant token-bucket rate limiting

Heavy submodules are loaded lazily: ``repro_torch.runtime`` imports ``net.wire``
for the shared codec, and an eager import of ``net.backend`` here would
close an import cycle back into ``repro_torch.runtime``.
"""
from repro_torch.net.wire import (  # noqa: F401  (re-export: the codec is light)
    MAGIC,
    WIRE_VERSION,
    WireError,
    decode_message,
    encode_message,
    recv_message,
    send_message,
)

_LAZY = {
    "SocketBackend": "repro_torch.net.backend",
    "SocketWorker": "repro_torch.net.backend",
    "WorkerServer": "repro_torch.net.ingest_server",
    "serve_worker_session": "repro_torch.net.ingest_server",
    "QueryServer": "repro_torch.net.query_server",
    "QueryClient": "repro_torch.net.query_server",
    "Rejected": "repro_torch.net.query_server",
}

__all__ = [
    "MAGIC",
    "WIRE_VERSION",
    "WireError",
    "decode_message",
    "encode_message",
    "recv_message",
    "send_message",
    *sorted(_LAZY),
]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.net' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
