"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven at a small
size on the CPU, once for each fault a cell can have (one chip, so no
exchange between chips to leave out)."""
import pytest

from portbench.harness import REPO, load_json

from portbench_small import run_small, small_bench  # noqa: F401 (fixture)

CELLS = [w["name"] for w in load_json(REPO / "BENCHMARK.json")["workloads"]]


class _Wrapped:
    """The program's sketch module with ``ingest`` replaced."""

    def __init__(self, mod):
        self._mod = mod

    def empty_like(self, sk):
        return self._mod.empty_like(sk)

    def merge(self, a, b):
        return self._mod.merge(a, b)


class StateUnchanged(_Wrapped):
    def ingest(self, sk, batch):
        return sk


class HalfTheBatch(_Wrapped):
    def ingest(self, sk, batch):
        n = batch.size // 2
        return self._mod.ingest(sk, batch.replace(
            src=batch.src[:n], dst=batch.dst[:n], weight=batch.weight[:n]))


class CounterAltered(_Wrapped):
    """One counter off by one where the ingest writes it."""

    def ingest(self, sk, batch):
        out = self._mod.ingest(sk, batch)
        counters = sk.table if hasattr(sk, "table") else sk.pools[0]
        counters.view(-1)[0] += 1
        return out


FAULTS = {"state_unchanged": StateUnchanged, "half_the_batch": HalfTheBatch,
          "counter_altered": CounterAltered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_ingest_is_not_correct(small_bench, cell, fault):
    out = run_small(small_bench, cell, seconds=0.3,
                    module=lambda mod, ctx: FAULTS[fault](mod))
    assert not out["line"]["correct"], out["checks"]


@pytest.mark.parametrize("cell", [c for c in CELLS if "serve" in c])
def test_an_answer_altered_where_it_is_produced_is_not_correct(
        small_bench, cell, monkeypatch):
    from repro_torch.serving import engine as eng

    execute = eng.QueryEngine.execute

    def altered(self, snapshot, requests):
        results = execute(self, snapshot, requests)
        for i, r in enumerate(results):
            if r.family == "edge_freq":
                results[i] = eng.Result(r.family, r.epoch, r.value + 1)
                break
        return results

    monkeypatch.setattr(eng.QueryEngine, "execute", altered)
    out = run_small(small_bench, cell, seconds=0.3)
    checks = out["checks"]
    assert not out["line"]["correct"]
    assert checks["answer_mismatches"][0] > 0
    assert checks["front_mismatches"][0] == 0
