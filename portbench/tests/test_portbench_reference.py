"""The plain reference against the program's CPU path, at a small size:
the plan, the counters and every query family."""
import numpy as np
import pytest
import torch

from portbench import program
from portbench.reference.check import (
    answer_mismatches,
    counter_mismatches,
    plan_mismatches,
)
from portbench.reference.counters import Answers, Layout, batch_counters
from portbench.reference.plan import make_plan
from portbench.traffic.requests import MIX_DEFAULT, synth_requests
from portbench.traffic.stream import stream_from_config

from portbench_small import small_config

SEEDS = (3, 2**31 + 5)


def _built(kind: str, seed: int):
    config = small_config(kind)
    stream = stream_from_config(config, batch_size=8192, seed=seed)
    program.import_port()
    sk, mod = program.planned_sketch(config, stream, seed,
                                     torch.device("cpu"))
    for src, dst, w in stream.edge_batches():
        mod.ingest(sk, program.edge_batch(src, dst, w, "cpu"))
    plan = make_plan(config, (stream.batch_numpy(i)
                              for i in range(stream.num_batches)), seed)
    layout = Layout(plan)
    expected = sum(batch_counters(layout, *b) for b in stream.edge_batches())
    return config, sk, plan, layout, expected


@pytest.mark.parametrize("kind", ["kmatrix", "gmatrix"])
@pytest.mark.parametrize("seed", SEEDS)
def test_plan_and_counters_equal_the_program(kind, seed):
    _, sk, plan, layout, expected = _built(kind, seed)
    assert sum(plan_mismatches(plan, program.plan_of(sk)).values()) == 0
    assert counter_mismatches(layout, expected, program.counters_of(sk)) == 0
    if kind == "kmatrix":
        assert len(plan.class_widths) > 1  # the classes are exercised


@pytest.mark.parametrize("kind", ["kmatrix", "gmatrix"])
def test_every_family_equals_the_program_engine(kind):
    from repro_torch.serving import QueryEngine
    from repro_torch.serving.snapshot import Snapshot

    config, sk, plan, layout, expected = _built(kind, SEEDS[1])
    reqs = synth_requests(600, MIX_DEFAULT, n_nodes=3454, seed=11,
                          heavy_universe=1024, heavy_threshold=20.0)
    snap = Snapshot("t", 4, sk, kind, 0)
    results = QueryEngine().execute(snap, [program.to_request(r)
                                           for r in reqs])
    values = [program.answer_value(r.value) for r in results]
    assert {r[0] for r in reqs} == set(MIX_DEFAULT)
    checked, bad, notes = answer_mismatches(
        layout, lambda e: expected if e == 4 else None,
        [(4, reqs, values)])
    assert (checked, bad) == (600, 0), notes
    # both reachability answers occur, and heavy nodes are not empty
    ans = Answers(layout, expected)
    reach = ans.reach([r[1] for r in reqs if r[0] == "reach"],
                      [r[2] for r in reqs if r[0] == "reach"])
    assert reach.any()
    assert len(ans.heavy_nodes(1024, 20.0)[0]) > 0


def test_a_wrong_answer_or_epoch_is_counted():
    _, sk, plan, layout, expected = _built("gmatrix", SEEDS[0])
    reqs = [("edge_freq", 1, 2), ("node_out", 5), ("reach", 1, 2)]
    ans = Answers(layout, expected)
    right = [int(ans.edge_freq([1], [2])[0]), int(ans.node_out([5])[0]),
             bool(ans.reach([1], [2])[0])]
    at = {1: expected}.get
    assert answer_mismatches(layout, at, [(1, reqs, right)])[1] == 0
    wrong = [right[0] + 1, right[1], right[2]]
    assert answer_mismatches(layout, at, [(1, reqs, wrong)])[1] == 1
    assert answer_mismatches(layout, at, [(2, reqs, right)])[1] == 3


def test_counters_hold_every_edge_once():
    _, _, plan, layout, expected = _built("kmatrix", SEEDS[0])
    n = 42157
    d = plan.depth
    conn = layout.conn_block(expected)
    assert int(conn.sum()) == n * d
    pools = sum(int(layout.partition_block(expected, p).sum())
                for p in range(len(plan.widths)))
    assert pools == n * d
    assert np.all(expected >= 0)
