"""The port's query_serve driver (cooperative mode) on the CPU against the
JAX package's on the same flags: the same JSON summary keys, equal
deterministic fields, a bit-equal final sketch; and the flags of modes not
ported yet are refused."""
import contextlib
import io
import json

import numpy as np
import pytest

import repro.launch.query_serve as j_driver
from repro_torch import interop
from repro_torch.launch import query_serve as t_driver
from repro_torch.serving import QueryEngine, gates, synth_requests
from repro_torch.serving import engine as eng

FLAGS = ["--scale", "0.03", "--budget-kb", "64", "--depth", "3",
         "--n-requests", "300", "--qps", "2000"]
# the port's kmatrix layout by default is JAX's Pallas (width-class) layout
KINDS = {"kmatrix": ["--sketch-backend", "pallas"], "gmatrix": [],
         "countmin": []}
DETERMINISTIC = ("driver", "dataset", "sketch", "budget_kb", "offered_qps",
                 "n_requests", "total_edges", "ingest_mode")


def _run_reference(kind, monkeypatch):
    """The JAX driver's summary line and its final tenant."""
    seen = {}
    serve = j_driver.cooperative_serve

    def capture(args, tenant, engine, requests):
        seen["tenant"] = tenant
        return serve(args, tenant, engine, requests)

    monkeypatch.setattr(j_driver, "cooperative_serve", capture)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        j_driver._run(j_driver.parse_args(
            [*FLAGS, "--sketch", kind, *KINDS[kind]]))
    return json.loads(out.getvalue().strip().splitlines()[-1]), seen["tenant"]


@pytest.fixture(scope="module", params=list(KINDS))
def runs(request):
    kind = request.param
    mp = pytest.MonkeyPatch()
    try:
        ref, ref_tenant = _run_reference(kind, mp)
    finally:
        mp.undo()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        port = t_driver._run(t_driver.parse_args(
            [*FLAGS, "--sketch", kind, "--device", "cpu"]))
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    return ref, ref_tenant, line, port


def test_summary_has_the_jax_keys_and_equal_deterministic_fields(runs):
    ref, _, line, port = runs
    assert line == port["summary"]
    assert set(line) == set(ref)
    assert set(line["latency_hist"]) == set(ref["latency_hist"])
    for key in DETERMINISTIC:
        assert line[key] == ref[key], key
    assert line["total_edges"] == port["tenant"].stream.spec.n_edges
    assert line["final_epoch"] >= 2 and line["n_requests"] == 300
    assert line["p99_ms"] >= line["p50_ms"] > 0 and line["achieved_qps"] > 0
    assert line["engine_closure_misses"] >= (line["sketch"] != "countmin")


def test_final_sketch_is_bit_equal_to_jax(runs):
    _, ref_tenant, _, port = runs
    tenant = port["tenant"]
    assert tenant.exhausted and ref_tenant.exhausted
    assert tenant.buffer.pending_edges == ref_tenant.buffer.pending_edges == 0
    pl, ps = interop.export_state(tenant.snapshot.sketch)
    rl, rs = interop.export_state(ref_tenant.snapshot.sketch)
    assert ps == rs and sorted(pl) == sorted(rl)
    for k in rl:
        np.testing.assert_array_equal(pl[k], rl[k], err_msg=k)


def test_final_answers_equal_direct_and_replay(runs):
    _, _, line, port = runs
    tenant, snap = port["tenant"], port["tenant"].snapshot
    reqs = port["requests"][:120]
    got = [r.value for r in QueryEngine().execute(snap, reqs)]
    direct = eng.direct_answers(snap, reqs)
    assert gates.mismatched_indices(got, direct) == []
    replay = gates.replay_sketch(tenant.mod, tenant.mod.empty_like(snap.sketch),
                                 tenant.stream, tenant.stream.num_batches)
    assert gates.replay_exactness(snap, replay, reqs, answers=direct)["ok"]
    # the driver's requests are the JAX driver's (numpy only)
    n = tenant.stream.spec.n_nodes
    again = synth_requests(300, t_driver.build_mix(t_driver.parse_args(
        ["--sketch", line["sketch"]])), n_nodes=n, seed=7,
        heavy_universe=min(n, 1 << 14), heavy_threshold=100.0)
    assert again == port["requests"]


LATER = [
    (["--background-ingest"], "11"), (["--runtime-backend", "process"], "11"),
    (["--publish-mode", "full"], "11"), (["--queue-capacity", "8"], "11"),
    (["--backpressure", "spill"], "11"), (["--publish-policy", "every:2"], "11"),
    (["--spill-dir", "x"], "11"), (["--checkpoint-dir", "x"], "11"),
    (["--checkpoint-every", "4"], "11"), (["--restore"], "11"),
    (["--ingest-dedup"], "11"), (["--span-log", "x"], "11"),
    (["--serve", "127.0.0.1:7311"], "12"), (["--connections", "2"], "12"),
    (["--max-inflight", "8"], "12"), (["--tenant-qps", "5"], "12"),
    (["--auth-token", "t"], "12"), (["--shards", "2"], "10b"),
    (["--shard-seed", "3"], "10b"), (["--metrics-json", "m.json"], "13b"),
    (["--metrics-interval-s", "2"], "13b"),
]


@pytest.mark.parametrize("flags,item", LATER, ids=[f[0][0] for f in LATER])
def test_later_slices_flags_are_refused(flags, item, capsys):
    with pytest.raises(SystemExit) as exc:
        t_driver.parse_args(["--device", "cpu", *flags])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{flags[0]} is not ported yet (ROADMAP item {item})" in err


def test_no_donate_is_refused_and_defaults_equal_jax(capsys):
    with pytest.raises(SystemExit):
        t_driver.parse_args(["--no-donate"])
    assert "nothing to switch off" in capsys.readouterr().err
    port, ref = vars(t_driver.parse_args([])), vars(j_driver.parse_args([]))
    assert port.pop("device") == "cuda"
    assert port.pop("sketch_backend") == ref.pop("sketch_backend") == ""
    assert port == ref
