"""The port's spans (``repro_torch.obs.profile``): off, a shared no-op that
records nothing; under any ``torch.profiler`` session, ``repro.<site>``
ranges nested as the calls nest, each kept in the span log; under
REPRO_PROFILE=1, the hub histogram and ``profile_call``'s synchronisation
besides.  Then the sites the ingest, the snapshot buffer and the engine
open, by the names the benchmark's readers take."""
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import EdgeBatch, vertex_stats_from_sample
from repro_torch.obs import profile as prof
from repro_torch.obs.hub import get_hub, reset_hub
from repro_torch.serving import QueryEngine, SnapshotBuffer
from repro_torch.serving import engine as eng
from repro_torch.serving.registry import build_sketch


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    monkeypatch.delenv("REPRO_PROFILE", raising=False)
    prof._reset_for_tests()
    reset_hub()
    yield
    monkeypatch.delenv("REPRO_PROFILE", raising=False)
    prof._reset_for_tests()


def _profile_samples() -> list[str]:
    return sorted(labels["site"] for name, labels, _ in
                  get_hub().state()["hists"]
                  if name == "repro_profile_seconds")


def _ranges(p) -> list[tuple[str, float, float]]:
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in p.events() if e.device_type == DeviceType.CPU
                   and e.name.startswith(prof.PREFIX)), key=lambda x: x[1])


def test_off_span_is_one_shared_no_op_that_records_nothing(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: opened.append(a))
    first = prof.profile_span("dispatch.check")
    with prof.profile_span("engine.execute", (3, 512)) as entered:
        pass
    assert first is prof.OFF and prof.profile_span("x") is prof.OFF
    assert not entered
    with pytest.raises(KeyError):  # the off span lets an exception through
        with prof.profile_span("query.reach"):
            raise KeyError("lookup")
    assert opened == [] and get_hub().state()["hists"] == []
    assert prof.recorded_spans() == []


def test_spans_under_the_profiler_nest_as_the_calls(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]) as p:
        with prof.profile_span("outer", 7):
            with prof.profile_span("inner"):
                torch.ones(4).add_(1)
            with prof.profile_span("inner"):
                pass
    ranges = _ranges(p)
    assert [n for n, _, _ in ranges] == ["repro.outer", "repro.inner",
                                         "repro.inner"]
    (_, s0, e0), *inner = ranges
    assert all(s0 <= s <= e <= e0 for _, s, e in inner)
    log = prof.recorded_spans()
    assert [n for n, _, _ in log] == ["inner", "inner", "outer"]
    assert all(log[2][1] <= s <= e <= log[2][2] for _, s, e in log[:2])
    assert get_hub().state()["hists"] == []  # the hub is REPRO_PROFILE's


def test_repro_profile_feeds_the_hub_histogram_without_a_profiler(
        monkeypatch):
    monkeypatch.setenv("REPRO_PROFILE", "1")
    prof._reset_for_tests()
    with prof.profile_span("ingest"):
        pass
    assert prof.profile_call("x", lambda a: a + 1, 1) == 2
    assert _profile_samples() == ["ingest", "x"]
    assert [n for n, _, _ in prof.recorded_spans()] == ["ingest", "x"]


class _Event:
    made: list = []

    def __init__(self):
        _Event.made.append(self)
        self.calls = []

    def record(self):
        self.calls.append("record")

    def synchronize(self):
        self.calls.append("synchronize")


@pytest.mark.parametrize("mode", ["off", "profiler", "repro_profile"])
def test_profile_call_synchronises_only_under_repro_profile(monkeypatch,
                                                            mode):
    _Event.made = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(prof, "_on_card", lambda out: True)
    if mode == "repro_profile":
        monkeypatch.setenv("REPRO_PROFILE", "1")
        prof._reset_for_tests()
    if mode == "profiler":
        with profile(activities=[ProfilerActivity.CPU]) as p:
            assert prof.profile_call("query.closure", torch.ones, 2,
                                     span_args="kernel").sum() == 2
        assert [n for n, _, _ in _ranges(p)] == ["repro.query.closure"]
    else:
        assert prof.profile_call("query.closure", torch.ones, 2,
                                 span_args="kernel").sum() == 2
    want = [["record", "synchronize"]] if mode == "repro_profile" else []
    assert [e.calls for e in _Event.made] == want


def _tenant(kind: str):
    rng = np.random.default_rng(5)
    src = rng.integers(0, 200, 3000).astype(np.int32)
    dst = rng.integers(0, 200, 3000).astype(np.int32)
    sk, mod = build_sketch(kind, 1 << 15, vertex_stats_from_sample(src, dst),
                           3, seed=3, device="cpu")
    return SnapshotBuffer(sk, mod, tenant_id="spans", kind=kind), src, dst


@pytest.mark.parametrize("kind", ["kmatrix", "gmatrix"])
def test_the_ingest_and_engine_sites_by_the_readers_names(kind):
    buffer, src, dst = _tenant(kind)
    reqs = [eng.edge_freq(1, 2), eng.reach(1, 2), eng.node_out(3),
            eng.path_weight([1, 2, 3]), eng.subgraph_weight([(1, 2)]),
            eng.heavy_nodes(300, 5.0)]
    engine = QueryEngine()
    with profile(activities=[ProfilerActivity.CPU]):
        buffer.ingest(EdgeBatch.from_numpy(src, dst, device="cpu"))
        snap = buffer.publish()
        results = engine.execute(snap, reqs)
    assert [r.value for r in results[:1]] == eng.direct_answers(snap,
                                                                reqs[:1])
    log = prof.recorded_spans()
    sites = {n for n, _, _ in log}
    assert sites == {
        "dispatch.from_numpy", "snapshot.ingest", "sketch.ingest",
        "dispatch.matrix_ingest_edges", "dispatch.check", "snapshot.publish",
        "sketch.merge", "sketch.empty_like", "engine.execute", "engine.pad",
        "engine.readback", "query.edge_freq", "query.node_freq",
        "query.closure", "query.reach", "query.heavy_nodes",
        *("engine.group." + r.family for r in reqs)}

    def inside(child, parent):
        (_, s0, e0), = [x for x in log if x[0] == parent]
        return all(s0 <= s <= e <= e0 for n, s, e in log if n == child)

    assert inside("dispatch.check", "dispatch.matrix_ingest_edges")
    assert inside("dispatch.matrix_ingest_edges", "sketch.ingest")
    assert inside("sketch.merge", "snapshot.publish")
    for n, _, _ in log:
        if n.startswith(("engine.", "query.")) and n != "engine.execute":
            assert inside(n, "engine.execute"), n
