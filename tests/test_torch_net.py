"""The port's network tier against the JAX package's: the wire codec frame
for frame (the 22 kinds, the columnar items, the leaf codec, the restricted
decoder, the schema fingerprint), the socket backend (a self-hosted
loopback child and a ``socket:HOST:PORT`` worker host), mixed peers (a
port parent and a JAX worker host, the reverse, a JAX client and a port
query server), and the query front-end (answers, admission, rate limits,
``NetLoadGen``).  Everything runs on the CPU at small sizes over loopback
sockets; every wait is bounded."""
import ast
import os
import pickle
import struct
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import wire_schema
from repro.net import wire as jwire
from repro.net.backend import SocketBackend as JSocketBackend
from repro.net.ingest_server import WorkerServer as JWorkerServer
from repro.net.query_server import QueryClient as JQueryClient
from repro.runtime import Runtime as JRuntime
from repro.runtime.backend import build_child_spec as jbuild_child_spec
from repro.runtime.queueing import QueueItem as JItem
from repro.serving import SketchRegistry as JRegistry
from repro.serving import engine as jeng
from repro.serving import loadgen as jloadgen
from repro_torch import interop
from repro_torch.net import wire
from repro_torch.net.backend import SocketBackend
from repro_torch.net.ingest_server import WorkerServer
from repro_torch.net.query_server import (QueryClient, QueryServer, Rejected,
                                          TokenBucket)
from repro_torch.obs import get_hub
from repro_torch.runtime import BoundedEdgeQueue, QueueItem, Runtime, WorkerFailure
from repro_torch.runtime.backend import _ChildSpec, build_child_spec
from repro_torch.serving import (QueryEngine, SketchRegistry, gates,
                                 mix_for_sketch, synth_requests)
from repro_torch.serving import engine as eng
from repro_torch.serving import loadgen
from repro_torch.serving.registry import TenantOrigin

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(depth=3, batch_size=1024, scale=0.02)
WAIT_S = 60.0


def _wait(cond, timeout_s=WAIT_S, poll_s=0.01):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() >= deadline:
            raise TimeoutError("condition not met in time")
        time.sleep(poll_s)


def _tenant(kind="gmatrix", seed=2, backend="flat", warm=2):
    t = SketchRegistry(**SMALL, sketch_backend=backend,
                       device="cpu").open("cit-HepPh", kind, 64, seed=seed)
    t.step(warm)
    t.publish()
    return t


def _jtenant(kind="gmatrix", seed=2, backend="flat", warm=2):
    t = JRegistry(**SMALL, sketch_backend=backend).open(
        "cit-HepPh", kind, 64, seed=seed)
    t.step(warm)
    t.publish()
    return t


# ------------------------------------------------------------ the frames
def _messages(side):
    """The same message of every frame kind, built with ``side``'s own
    classes (``jeng``/``eng`` requests, each package's worker spec)."""
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 1 << 20, 16).astype(np.int32)
    leaves = [np.zeros((3, 8, 8), np.int32), np.arange(5, dtype=np.int32)]
    leaves[0][1, 2, 3] = 7
    mod = jeng if side == "jax" else eng
    requests = [mod.edge_freq(3, 4), mod.reach(1, 9, max_hops=3),
                mod.node_out(2), mod.path_weight([1, 2, 3]),
                mod.subgraph_weight([(1, 2), (3, 4)]),
                mod.heavy_nodes(64, 5.0), mod.node_in(6)]
    if side == "jax":
        spec = jbuild_child_spec(_jtenant(), "every:2")
    else:
        spec = build_child_spec(_tenant(), "every:2")
    metrics = {"ingested_edges": 10, "queue_depth": 0, "state": "running"}
    obs = {"hub": {"counters": [], "gauges": [], "hists": []}, "trace": []}
    return {
        "hello": ("hello", spec),
        "ready": ("ready", {"pid": 123, "offset": 2, "epoch": 1}),
        "item": ("item", 4, arr, arr + 1, np.ones(16, np.int32), 16, "tr"),
        "publish": ("publish", {"epoch": 3, "n_edges": 40, "next_offset": 5,
                                "reservoir": None, "metrics": metrics,
                                "obs": obs, "mode": "delta",
                                "base_epoch": 2,
                                "leaves": jwire.encode_leaves(leaves)}),
        "metrics": ("metrics", metrics, obs),
        "checkpoint": ("checkpoint",),
        "checkpointed": ("checkpointed", {"path": "/ckpt/step_4"}),
        "stop": ("stop", True),
        "stopped": ("stopped", metrics, obs),
        "failed": ("failed", "RuntimeError('x')", "Traceback", metrics),
        "metrics_req": ("metrics_req",),
        "resync": ("resync",),
        "info_req": ("info_req",),
        "info": ("info", {"n_nodes": 100, "epoch": 3, "kind": "gmatrix"}),
        "query": ("query", {"id": 7, "tenant": "t", "requests": requests}),
        "result": ("result", {"id": 7, "epoch": 3,
                              "values": [3, True, 5, 9, 11, (arr, arr), 2]}),
        "reject": ("reject", {"id": 7, "reason": "overloaded",
                              "retry_after_ms": 4.5}),
        "error": ("error", {"id": 7, "error": "boom"}),
        "ping": ("ping",),
        "pong": ("pong",),
        "auth": ("auth", "sekrit"),
    }


def _item(offset=3, n=12, weight_dtype=np.int32, trace="t"):
    rng = np.random.default_rng(offset)
    w = rng.integers(0, 3, n).astype(weight_dtype)
    return QueueItem.from_arrays(offset, rng.integers(0, 99, n).astype(np.int32),
                                 rng.integers(0, 99, n).astype(np.int32), w,
                                 trace_id=trace)


def test_frame_registry_and_header_equal_jax():
    assert wire.FRAME_TYPES == jwire.FRAME_TYPES and len(wire.FRAME_TYPES) == 22
    assert (wire.MAGIC, wire.WIRE_VERSION, wire.COMPAT_VERSIONS,
            wire.HEADER_SIZE, wire.MAX_PAYLOAD) == (
        jwire.MAGIC, jwire.WIRE_VERSION, jwire.COMPAT_VERSIONS,
        jwire.HEADER_SIZE, jwire.MAX_PAYLOAD)
    assert wire._SAFE_REPRO_CLASSES == jwire._SAFE_REPRO_CLASSES


@pytest.mark.parametrize("kind", sorted(jwire.FRAME_TYPES))
def test_every_frame_kind_is_the_jax_frame(kind):
    """Equal header bytes for every kind, equal payload bytes where the
    payload carries no wire type, and each side decodes the other's."""
    if kind == "item_cols":
        for it in (_item(), _item(weight_dtype=np.int64),
                   _item(n=0, trace="")):
            frame = wire.encode_item_frame(it, on_wire=False)
            assert frame == jwire.encode_item_frame(it, on_wire=False)
        return
    port_msg, ref_msg = _messages("port")[kind], _messages("jax")[kind]
    port = wire.encode_message(port_msg, on_wire=False)
    ref = jwire.encode_message(ref_msg, on_wire=False)
    hsize = wire.HEADER_SIZE
    if kind in ("hello", "query"):
        assert port[:8] == ref[:8]  # magic, version, type; lengths may differ
        back = jwire.decode_message(port, on_wire=False)
        mine = wire.decode_message(ref, on_wire=False)
        assert back[0] == mine[0] == kind
        if kind == "query":
            assert port == ref  # the reference names, byte for byte
            assert back[1]["requests"] == ref_msg[1]["requests"]
            assert mine[1]["requests"] == port_msg[1]["requests"]
            assert all(type(r) is eng.Request for r in mine[1]["requests"])
        else:
            _same_spec(back[1], port_msg[1])
            _same_spec(mine[1], ref_msg[1])
            assert type(mine[1]) is _ChildSpec
            assert type(mine[1].origin) is TenantOrigin
        return
    assert port[:hsize] == ref[:hsize]
    assert port[hsize:] == ref[hsize:]
    out = wire.decode_message(ref, on_wire=False)
    assert out[0] == kind and len(out) == len(ref_msg)


def _same_spec(a, b):
    """Two worker specs equal field for field (numpy leaves by value)."""
    fa, fb = vars(a), vars(b)
    assert list(fa) == list(fb)
    for key in fa:
        if key == "init":
            for part in ("front", "delta"):
                assert len(fa[key][part]) == len(fb[key][part])
                for x, y in zip(fa[key][part], fb[key][part]):
                    assert x.dtype == y.dtype
                    np.testing.assert_array_equal(x, y)
            rest = {k: v for k, v in fa[key].items()
                    if k not in ("front", "delta")}
            assert rest == {k: v for k, v in fb[key].items()
                            if k not in ("front", "delta")}
        elif key == "origin":
            assert vars(fa[key]) == vars(fb[key])
        else:
            assert fa[key] == fb[key], key


def test_hello_carries_the_jax_origin_and_no_device():
    spec = build_child_spec(_tenant("kmatrix", backend="width_class"),
                            "every:2")
    ref = jbuild_child_spec(_jtenant("kmatrix", backend="pallas"), "every:2")
    assert "device" not in spec.origin.registry
    assert spec.origin.registry == ref.origin.registry
    assert spec.origin.registry["sketch_backend"] == "pallas"
    for x, y in zip(spec.init["front"], ref.init["front"]):
        assert x.dtype == y.dtype and x.shape == y.shape
    # rebuilt on a device the worker names, in the port's layout name
    t = spec.origin.rebuild(device="cpu")
    assert t.device.type == "cpu"
    assert type(t.snapshot.sketch).__name__ == "KMatrixAccel"


def test_item_cols_decode_as_jax_over_dtypes_and_empty_batches():
    for it in (_item(), _item(weight_dtype=np.int64),
               _item(weight_dtype=np.float32), _item(n=0, trace="")):
        frame = jwire.encode_item_frame(JItem.from_arrays(
            it.offset, it.src, it.dst, it.weight, trace_id=it.trace_id),
            on_wire=False)
        got = wire.decode_message(frame, on_wire=False)
        ref = jwire.decode_message(frame, on_wire=False)
        assert got[0] == "item" and got[1] == ref[1] and got[5:] == ref[5:]
        for a, b in zip(got[2:5], ref[2:5]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_spill_file_is_the_jax_item_frame(tmp_path):
    """A spill file the port's queue writes (wide weights included) equals
    the JAX codec's ``encode_item_frame`` of the same item, and reads back
    through the port's queue."""
    q = BoundedEdgeQueue(1, "spill", spill_dir=str(tmp_path))
    items = [_item(i, weight_dtype=dt) for i, dt in
             enumerate((np.int32, np.int64, np.int32))]
    for it in items:
        assert q.put(it)
    files = sorted(tmp_path.glob("spill_*.kmx"))
    assert len(files) == 2
    for f, it in zip(files, items[1:]):
        assert f.read_bytes() == jwire.encode_item_frame(
            JItem.from_arrays(it.offset, it.src, it.dst, it.weight,
                              trace_id=it.trace_id), on_wire=False)
    out = [q.get(timeout=1) for _ in range(3)]
    assert [o.offset for o in out] == [0, 1, 2]
    assert out[1].weight.dtype == np.int64
    np.testing.assert_array_equal(out[1].weight, items[1].weight)


@pytest.mark.parametrize("density", [0.0, 0.01, 0.9])
def test_leaf_codec_equals_jax_sparse_and_dense(density):
    rng = np.random.default_rng(11)
    leaves = [(rng.random((5, 36, 36)) < density).astype(np.int32) * 3,
              np.array(4, np.int32), np.zeros(0, np.int32),
              (rng.random(100) < density).astype(np.int64)]
    mine, ref = wire.encode_leaves(leaves), jwire.encode_leaves(leaves)
    assert [e[0] for e in mine] == [e[0] for e in ref]
    assert pickle.dumps(mine) == pickle.dumps(ref)
    for a, b, c in zip(wire.decode_leaves(ref), jwire.decode_leaves(mine),
                       leaves):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


def _frame(kind, body: bytes, version=None) -> bytes:
    return struct.pack(">4sHHI", wire.MAGIC, version or wire.WIRE_VERSION,
                       wire.FRAME_TYPES[kind], len(body)) + body


@pytest.mark.parametrize("case", ["magic", "version", "torn", "type",
                                  "global", "torch", "port_class"])
def test_decoder_refuses_what_jax_refuses(case):
    good = wire.encode_message(("ping",), on_wire=False)
    if case == "magic":
        frame = b"XXXX" + good[4:]
    elif case == "version":
        frame = _frame("ping", good[wire.HEADER_SIZE:], version=1)
    elif case == "torn":
        frame = good[:-1]
    elif case == "type":
        frame = _frame("pong", good[wire.HEADER_SIZE:])
    elif case == "global":
        frame = _frame("ping", pickle.dumps(("ping", _Evil())))
    elif case == "torch":
        frame = _frame("ping", pickle.dumps(("ping", torch.zeros(2))))
    else:  # a port class pickled under its own name, not the reference's
        frame = _frame("query", pickle.dumps(
            ("query", {"requests": [eng.edge_freq(1, 2)]})))
    for codec in (wire, jwire):
        with pytest.raises(codec.WireError):
            codec.decode_message(frame, on_wire=False)


def test_port_wire_fingerprint_is_the_locked_schema():
    tree = ast.parse((REPO / "src/repro_torch/net/wire.py").read_text())
    schema = wire_schema.extract_schema(tree)
    version, digest = wire_schema.parse_lock(
        (REPO / "src/repro/net/wire_schema.lock").read_text())
    assert schema["version"] == version == 3
    assert wire_schema.fingerprint(schema) == digest
    assert digest.startswith("51d36cf2")


def test_wire_bytes_are_counted_by_kind():
    from repro_torch.obs import reset_hub

    reset_hub()
    wire.decode_message(wire.encode_message(("publish", {"epoch": 1})))
    wire.encode_item_frame(_item())
    counters = {(n, tuple(sorted(l.items()))): v
                for n, l, v in get_hub().state()["counters"]}
    assert counters[("wire_bytes_sent", (("kind", "publish"),))] > 0
    assert counters[("wire_bytes_sent", (("kind", "item"),))] > 0
    assert counters[("publish_bytes", ())] == counters[
        ("wire_bytes_recv", (("kind", "publish"),))]


# ------------------------------------------------------- socket backend
def _drain(tenant, backend, **kw):
    rt = Runtime(queue_capacity=8, publish_policy="every:3", poll_s=0.01,
                 backend=backend, **kw)
    handle = rt.attach(tenant)
    rt.start(pumps=False)
    assert rt.wait_ready()
    rt.start_pumps()
    assert rt.join_pumps(WAIT_S)
    report = rt.stop(drain=True, timeout=WAIT_S)[tenant.key.tenant_id]
    return report, handle


def _serve_once(server):
    thread = threading.Thread(target=server.serve_forever, kwargs=dict(
        max_sessions=1, idle_timeout_s=WAIT_S), daemon=True)
    thread.start()
    return thread


@pytest.fixture(scope="module")
def thread_front():
    t = _tenant()
    report, _ = _drain(t, "thread")
    assert report["unaccounted_edges"] == 0
    return t.snapshot.sketch


def _check_final(tenant, report, thread_front):
    assert report["unaccounted_edges"] == 0 and report["state"] == "stopped"
    assert tenant.snapshot.n_edges == tenant.stream.spec.n_edges
    assert gates.layout_counters_equal(tenant.snapshot.sketch, thread_front)


def test_self_hosted_socket_worker_equals_thread(thread_front):
    t = _tenant()
    report, handle = _drain(t, "socket")
    _check_final(t, report, thread_front)
    assert handle.worker.health()["peer"][0] == "self-host"


def test_addressed_socket_worker_equals_thread(thread_front):
    server = WorkerServer("127.0.0.1", 0, device="cpu")
    thread = _serve_once(server)
    t = _tenant()
    report, _ = _drain(t, f"socket:{server.address[0]}:{server.address[1]}")
    thread.join(WAIT_S)
    assert not thread.is_alive() and server.session_results == ["stopped"]
    _check_final(t, report, thread_front)


def test_port_parent_drives_a_jax_worker_host(thread_front):
    server = JWorkerServer("127.0.0.1", 0)
    thread = _serve_once(server)
    t = _tenant()
    report, _ = _drain(t, SocketBackend(addresses=[server.address]))
    thread.join(WAIT_S)
    assert server.session_results == ["stopped"]
    _check_final(t, report, thread_front)


def test_jax_parent_drives_a_port_worker_host(thread_front):
    server = WorkerServer("127.0.0.1", 0, device="cpu")
    thread = _serve_once(server)
    t = _jtenant()
    rt = JRuntime(queue_capacity=8, publish_policy="every:3", poll_s=0.01,
                  backend=JSocketBackend(addresses=[server.address]))
    rt.attach(t)
    rt.start(pumps=False)
    assert rt.wait_ready()
    rt.start_pumps()
    assert rt.join_pumps(WAIT_S)
    report = rt.stop(drain=True, timeout=WAIT_S)[t.key.tenant_id]
    thread.join(WAIT_S)
    assert server.session_results == ["stopped"]
    assert report["unaccounted_edges"] == 0
    assert t.snapshot.n_edges == t.stream.spec.n_edges
    assert gates.layout_counters_equal(interop.import_state(
        *interop.export_state(t.snapshot.sketch), device="cpu"), thread_front)


def test_worker_host_refuses_a_parent_without_the_token(monkeypatch):
    monkeypatch.delenv(wire.AUTH_TOKEN_ENV, raising=False)
    server = WorkerServer("127.0.0.1", 0, device="cpu", auth_token="sekrit",
                          hello_timeout_s=10.0)
    thread = threading.Thread(target=lambda: server.serve_forever(
        max_sessions=1, idle_timeout_s=WAIT_S), daemon=True)
    thread.start()
    t = _tenant()
    rt = Runtime(queue_capacity=8, poll_s=0.01,
                 backend=SocketBackend(addresses=[server.address],
                                       connect_timeout_s=10.0))
    handle = rt.attach(t)
    rt.start(pumps=False)
    _wait(lambda: not handle.worker.is_alive())
    with pytest.raises(WorkerFailure, match="TCP peer"):
        rt.stop(drain=True, timeout=WAIT_S)
    thread.join(WAIT_S)
    assert "auth" in server.session_results[0]
    with pytest.raises(ValueError, match="non-loopback"):
        WorkerServer("0.0.0.0", 0, device="cpu", auth_token="")


def test_scrape_only_peer_gets_the_scrape_payload():
    from repro.obs.dump import scrape_payload as jscrape

    server = WorkerServer("127.0.0.1", 0, device="cpu")
    thread = _serve_once(server)
    conn = wire.connect_with_retry(server.address, deadline_s=10)
    try:
        wire.send_message(conn, ("metrics_req",))
        reply = None
        deadline = time.monotonic() + WAIT_S
        while reply is None and time.monotonic() < deadline:
            reply = wire.recv_message(conn, poll_s=0.2)
    finally:
        conn.close()
    thread.join(WAIT_S)
    assert reply[0] == "metrics"
    assert set(reply[1]) == set(jscrape()) == {"prometheus", "state", "ts"}
    assert set(reply[1]["state"]) == set(jscrape()["state"])
    assert server.session_results == ["scraped"]


def test_a_worker_without_a_card_fails_the_run(monkeypatch):
    """No fallback: a worker host told to ingest on the card, where there is
    none, fails its session; the parent raises ``WorkerFailure``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    server = WorkerServer("127.0.0.1", 0)  # device="cuda", the default
    thread = _serve_once(server)
    t = _tenant()
    rt = Runtime(queue_capacity=8, poll_s=0.01,
                 backend=SocketBackend(addresses=[server.address]))
    handle = rt.attach(t)
    rt.start(pumps=False)
    _wait(lambda: not handle.worker.is_alive())
    with pytest.raises(WorkerFailure, match="CUDA is not available") as exc:
        rt.stop(drain=True, timeout=WAIT_S)
    assert exc.value.report[t.key.tenant_id]["state"] == "failed"
    thread.join(WAIT_S)
    assert server.session_results == ["failed"]
    assert t.snapshot.epoch == 1  # nothing was ingested anywhere


# ------------------------------------------------------------ front-end
@pytest.fixture(scope="module")
def served():
    t = _tenant(warm=6)
    reqs = synth_requests(120, mix_for_sketch("gmatrix"),
                          n_nodes=t.stream.spec.n_nodes, seed=4,
                          heavy_universe=256, heavy_threshold=5.0)
    server = QueryServer(QueryEngine(), lambda: t.snapshot,
                         info={"n_nodes": t.stream.spec.n_nodes,
                               "kind": "gmatrix"}).start()
    yield t, reqs, server
    server.stop()


def _same_values(got, want):
    return gates.mismatched_indices(got, want) == []


@pytest.mark.parametrize("client", ["port", "jax"])
def test_query_server_answers_equal_direct_answers(served, client):
    t, reqs, server = served
    cls = QueryClient if client == "port" else JQueryClient
    c = cls(server.address, tenant=client)
    try:
        assert c.info()["epoch"] == t.snapshot.epoch
        if client == "jax":  # the JAX client sends the JAX Request class
            jreqs = [jeng.Request(**vars(r)) for r in reqs]
            values, epoch = c.query(jreqs)
        else:
            values, epoch = c.query(reqs)
    finally:
        c.close()
    assert epoch == t.snapshot.epoch
    assert _same_values(values, eng.direct_answers(t.snapshot, reqs))


class _SlowEngine:
    def __init__(self, delay_s):
        self.delay_s = delay_s

    def execute(self, snapshot, requests):
        time.sleep(self.delay_s)
        return [eng.Result(r.family, snapshot.epoch, 0) for r in requests]


class _Snap:
    epoch, n_edges = 1, 0


def test_admission_sheds_past_max_inflight_with_retry_after():
    server = QueryServer(_SlowEngine(0.05), lambda: _Snap, max_inflight=2,
                         batch_max=2).start()
    outcomes, lock = [], threading.Lock()

    def hammer():
        c = QueryClient(server.address)
        for _ in range(4):
            p = c.call([eng.edge_freq(1, 2), eng.edge_freq(2, 3)])
            with lock:
                outcomes.append(p)
        c.close()

    try:
        threads = [threading.Thread(target=hammer) for _ in range(5)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT_S)
        _wait(lambda: server.stats()["inflight"] == 0)
        stats = server.stats()
        with pytest.raises(Rejected) as exc:
            QueryClient(server.address).query([eng.node_out(1)] * 3)
        assert exc.value.reason == "too_large"
    finally:
        server.stop()
    rejects = [p for p in outcomes if p["kind"] == "reject"]
    assert rejects and all(p["reason"] == "overloaded"
                           and p["retry_after_ms"] > 0 for p in rejects)
    assert stats["offered_requests"] == 2 * len(outcomes) == (
        stats["admitted_requests"] + stats["shed_overload"])
    assert stats["served_requests"] == stats["admitted_requests"]


def test_token_bucket_limits_a_tenant_as_jax():
    from repro.net.query_server import TokenBucket as JTokenBucket

    with pytest.raises(ValueError):
        TokenBucket(0.0, 1.0)
    server = QueryServer(_SlowEngine(0.0), lambda: _Snap, tenant_qps=1.0,
                         tenant_burst=2.0).start()
    try:
        noisy = QueryClient(server.address, tenant="noisy")
        noisy.query([eng.node_out(1), eng.node_out(2)])
        with pytest.raises(Rejected) as exc:
            noisy.query([eng.node_out(3)])
        assert exc.value.reason == "rate_limited" and exc.value.retry_after_ms > 0
        quiet = QueryClient(server.address, tenant="quiet")
        assert quiet.query([eng.node_out(1)])[0] == [0]
        noisy.close()
        quiet.close()
        assert server.stats()["shed_rate_limited"] == 1
    finally:
        server.stop()
    a, b = TokenBucket(10.0, 3.0), JTokenBucket(10.0, 3.0)
    assert [a.take(2) == 0.0 for _ in range(3)] == \
        [b.take(2) == 0.0 for _ in range(3)]


DETERMINISTIC = ("n_requests", "accepted", "shed", "errors", "aborted",
                 "transport_error", "connections", "offered_qps",
                 "last_epoch")


def test_netloadgen_report_equals_jax_and_answers_are_served(served):
    t, reqs, server = served
    mine = loadgen.NetLoadGen(target_qps=2000, connections=2,
                              batch_max=16).run(server.address, reqs)
    jreqs = [jeng.Request(**vars(r)) for r in reqs]
    ref = jloadgen.NetLoadGen(target_qps=2000, connections=2,
                              batch_max=16).run(server.address, jreqs)
    assert set(vars(mine)) == set(vars(ref))
    for key in DETERMINISTIC:
        assert getattr(mine, key) == getattr(ref, key), key
    assert mine.accepted == 120 and mine.last_epoch == t.snapshot.epoch
    assert set(mine.latency_hist) == set(ref.latency_hist)
    assert mine.latency_hist["count"] == 120
