"""The comparisons that decide ``correct``: the program's plan, counters and
answers against the reference's, each a count of disagreements whose limit
is 0 (the configurations state exact counters and exact answers).

The program's side arrives as plain NumPy arrays and tuples, extracted by
the harness; this module imports nothing of the program.
"""
from __future__ import annotations

import numpy as np

from portbench.reference.counters import Answers, Layout
from portbench.reference.plan import Plan


def _diff(expected, got) -> int:
    """Elements of ``expected`` that ``got`` does not hold; a shape that
    differs counts every element of the larger."""
    e, g = np.asarray(expected), np.asarray(got)
    if e.shape != g.shape:
        return int(max(e.size, g.size, 1))
    return int((e.astype(np.int64) != g.astype(np.int64)).sum())


def plan_mismatches(plan: Plan, program: dict) -> dict[str, int]:
    """Disagreements, by part, between the reference's plan and the
    program's (hash family, routing, widths, class arrangement)."""
    out = {"hash_a": _diff(plan.a, program["a"]),
           "hash_b": _diff(plan.b, program["b"])}
    if plan.kind == "gmatrix":
        out["width"] = int(plan.w != program["w"])
        return out
    out.update({
        "route_keys": _diff(plan.route_keys, program["route_keys"]),
        "route_part": _diff(plan.route_part, program["route_part"]),
        "outlier": int(plan.outlier != program["outlier"]),
        "widths": _diff(plan.widths, program["part_width"]),
        "part_class": _diff(plan.part_class, program["part_class"]),
        "part_index": _diff(plan.part_index, program["part_index"]),
        "classes": int(tuple(plan.class_widths) != tuple(program["class_widths"])
                       or tuple(plan.class_counts)
                       != tuple(program["class_counts"])),
        "conn_w": int(plan.conn_w != program["conn_w"]),
    })
    return out


def counter_mismatches(layout: Layout, expected: np.ndarray,
                       program: dict) -> int:
    """Counters of the program's sketch that differ from ``expected`` (a
    flat reference vector): every partition block, found by the
    reference's own class arrangement, and the connectivity matrix; or
    the gMatrix table."""
    plan = layout.plan
    if plan.kind == "gmatrix":
        return _diff(layout.table(expected), program["table"])
    pools = program["pools"]
    bad = 0
    for p in range(len(plan.widths)):
        c, i = int(plan.part_class[p]), int(plan.part_index[p])
        block = layout.partition_block(expected, p)
        if c >= len(pools) or i >= pools[c].shape[1]:
            bad += block.size
            continue
        bad += _diff(block, pools[c][:, i])
    return bad + _diff(layout.conn_block(expected), program["conn"])


def _as_pair(value):
    ids, freqs = value
    return np.asarray(ids, np.int64), np.asarray(freqs, np.int64)


def answer_mismatches(layout: Layout, counters_at, records) -> tuple[int, int, list]:
    """Check every answer against the reference on its own epoch.

    ``counters_at(epoch)`` gives the flat counters the reference expects
    the front of ``epoch`` to hold (None for an epoch that was never
    published); ``records`` is a list of (epoch, requests, values), one
    per served batch.  Returns (checked, mismatched, the first few
    mismatches as text).
    """
    by_epoch: dict[int, list] = {}
    for epoch, reqs, values in records:
        by_epoch.setdefault(int(epoch), []).append((reqs, values))
    checked = bad = 0
    notes: list[str] = []

    def note(epoch, req, got, want):
        if len(notes) < 5:
            notes.append(f"epoch {epoch} {req!r}: {got!r} != {want!r}")

    for epoch, batches in sorted(by_epoch.items()):
        reqs = [r for rs, _ in batches for r in rs]
        vals = [v for _, vs in batches for v in vs]
        checked += len(reqs)
        flat = counters_at(epoch)
        if flat is None:
            bad += len(reqs)
            note(epoch, "all", "an epoch never published", "-")
            continue
        ans = Answers(layout, flat)
        fams: dict[str, list[int]] = {}
        for j, r in enumerate(reqs):
            fams.setdefault(r[0], []).append(j)
        for fam, js in fams.items():
            if fam == "heavy_nodes":
                cache = {}
                for j in js:
                    key = reqs[j][1:]
                    if key not in cache:
                        cache[key] = ans.heavy_nodes(*key)
                    want = cache[key]
                    got = _as_pair(vals[j])
                    if not (np.array_equal(got[0], want[0])
                            and np.array_equal(got[1], want[1])):
                        bad += 1
                        note(epoch, reqs[j], "ids/freqs", "differ")
                continue
            if fam in ("edge_freq", "reach"):
                s = np.asarray([reqs[j][1] for j in js])
                t = np.asarray([reqs[j][2] for j in js])
                want = (ans.edge_freq(s, t) if fam == "edge_freq"
                        else ans.reach(s, t))
            elif fam == "node_out":
                want = ans.node_out(np.asarray([reqs[j][1] for j in js]))
            elif fam == "path_weight":
                nodes = np.asarray([reqs[j][1] for j in js], np.int64)
                want = ans.edge_freq(nodes[:, :-1], nodes[:, 1:]).reshape(
                    len(js), -1).sum(axis=1)
            elif fam == "subgraph_weight":
                edges = np.asarray([reqs[j][1] for j in js], np.int64)
                want = ans.edge_freq(edges[..., 0], edges[..., 1]).reshape(
                    len(js), -1).sum(axis=1)
            else:
                bad += len(js)
                note(epoch, fam, "unknown family", "-")
                continue
            for k, j in enumerate(js):
                got = vals[j]
                ok = (bool(got) == bool(want[k]) if fam == "reach"
                      else not isinstance(got, bool)
                      and int(got) == int(want[k]))
                if not ok:
                    bad += 1
                    note(epoch, reqs[j], got, want[k])
    return checked, bad, notes
