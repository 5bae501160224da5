"""The program's own spans in a traced run: what the per-layer metrics
``from_numpy_us``, ``ingest_launch_us``, ``query_core_ms``,
``engine_readback_ms`` and ``publish_ms`` read, and a breakdown of the
device's idle time by the innermost span, the program's ``repro.*`` ones
among the benchmark's ``pb.*``.

The port opens a ``repro.<site>`` range (``repro_torch.obs.profile``)
whenever a profiler session is active, and keeps each as (site, start,
end) on ``time.perf_counter``'s clock (``recorded_spans``).  A slice's ends
(``TraceSlice.t0``, ``t1``) are readings of that clock, so the slice's
spans are those that lie inside them.  A program without that log, or a
slice in which it recorded nothing, gives no span: the readers return
None.

The breakdown needs the spans on the profiler's own clock beside the
device's operations, which ``TraceSlice`` does not keep.  Run one cell
with ``ProgramTraceSlice`` in its place:

    python3 -m portbench.program_spans --workload <cell> --seed <n> \\
        --seconds <s>

It prints the cell's traced result line, whose ``breakdown`` adds
``program_idle_gaps`` (the idle time charged to the innermost span open
over it, however deep the nesting: each gap is cut at every span's start
and end, and each piece goes to the span holding it), the share of the
idle time
inside ``pb.*`` spans that a ``repro.*`` span names, the same inside
``pb.execute`` for spans below ``repro.engine.execute``, each site's count
and mean length, and the count of ``repro.dispatch.matrix_ingest_edges``
spans beside the change in the wrapper's launch counter.
"""
from __future__ import annotations

import argparse
import bisect
import heapq
import json
import os
import sys

from portbench import trace
from portbench.trace import TraceSlice, union_seconds

PREFIX = "repro."


def slice_spans(run) -> list[tuple[str, float, float]]:
    """The program's recorded spans inside the run's traced slice, as
    (site, start, end) seconds; empty where there are none to read."""
    tr = run.trace
    if tr is None or tr.t0 is None or tr.t1 is None:
        return []
    from repro_torch.obs import profile
    recorded = getattr(profile, "recorded_spans", None)
    if recorded is None:
        return []
    return [(n, s, e) for n, s, e in recorded() if tr.t0 <= s and e <= tr.t1]


def mean_seconds(run, site: str) -> float | None:
    """The mean length of the slice's ``repro.<site>`` spans."""
    lengths = [e - s for n, s, e in slice_spans(run) if n == site]
    return sum(lengths) / len(lengths) if lengths else None


def per_execute_seconds(run, prefix: str) -> float | None:
    """For each ``repro.engine.execute`` span of the slice, the union
    length of the spans inside it whose site starts with ``prefix``; the
    mean over the executes."""
    spans = sorted(slice_spans(run), key=lambda x: x[1])
    executes = [(s, e) for n, s, e in spans if n == "engine.execute"]
    if not executes:
        return None
    starts = [s for _, s, _ in spans]
    total = 0.0
    for s0, e0 in executes:
        inside = []
        for n, s, e in spans[bisect.bisect_left(starts, s0):]:
            if s > e0:
                break
            if e <= e0 and n.startswith(prefix):
                inside.append((s, e))
        total += union_seconds(inside)
    return total / len(executes)


def innermost(spans, times) -> list[str]:
    """For each of the ascending ``times``, the name of the innermost span
    holding it (the latest-starting, the shortest among equal starts), or
    "none": exact at any depth of nesting."""
    order = sorted(spans, key=lambda x: x[1])
    heap: list = []
    out, i = [], 0
    for t in times:
        while i < len(order) and order[i][1] <= t:
            name, s, e = order[i]
            heapq.heappush(heap, (-s, e, i, name))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][3] if heap else "none")
    return out


class ProgramTraceSlice(TraceSlice):
    """A ``TraceSlice`` that also keeps the program's ``repro.*`` host
    ranges (``program_spans``: site, start, end on the profiler's clock)
    and breaks the idle time down by them."""

    def __init__(self, device, spans):
        super().__init__(device, spans)
        self.program_spans: list[tuple[str, float, float]] = []
        self.device_ops_named_program = 0

    def _read(self, events):
        from torch.autograd import DeviceType
        super()._read(events)
        # a torch that does not flag a range's device-side shadow as a user
        # annotation leaves it among the device's operations: count, drop
        self.device_ops_named_program = sum(
            n.startswith(PREFIX) for n, _, _ in self.device_ops)
        self.device_ops = [x for x in self.device_ops
                           if not x[0].startswith(PREFIX)]
        for e in events:
            if e.device_type == DeviceType.CPU and e.name.startswith(PREFIX):
                self.program_spans.append((e.name[len(PREFIX):],
                                           e.time_range.start * 1e-6,
                                           e.time_range.end * 1e-6))
        self.program_spans.sort(key=lambda x: x[1])

    def idle_pieces(self, spans) -> list[tuple[float, float]]:
        """The gaps between the device's merged operations, cut at every
        start and end of ``spans``: over each piece the same spans are
        open."""
        merged: list[list[float]] = []
        for _, s, e in self.device_ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        cuts = sorted({t for _, s, e in spans for t in (s, e)})
        pieces = []
        for (_, gs), (ge, _) in zip(merged, merged[1:]):
            points = [gs, *cuts[bisect.bisect_right(cuts, gs):
                                bisect.bisect_left(cuts, ge)], ge]
            pieces += zip(points, points[1:])
        return pieces

    def breakdown(self, top: int = 10) -> dict:
        out = super().breakdown(top)
        both = self.host_spans + [(PREFIX + n, s, e)
                                  for n, s, e in self.program_spans]
        pieces = self.idle_pieces(both)
        mids = [(s + e) / 2 for s, e in pieces]
        names = innermost(both, mids)
        in_pb = innermost(self.host_spans, mids)
        by_span: dict[str, float] = {}
        pb_idle = named = exec_idle = below = 0.0
        for (s, e), name, pb in zip(pieces, names, in_pb):
            by_span[name] = by_span.get(name, 0.0) + (e - s)
            if pb == "none":
                continue
            pb_idle += e - s
            named += (e - s) if name.startswith(PREFIX) else 0.0
            if pb == "execute":
                exec_idle += e - s
                if name not in ("execute", PREFIX + "engine.execute"):
                    below += e - s
        sites: dict[str, list] = {}
        for n, s, e in self.program_spans:
            c = sites.setdefault(n, [0, 0.0])
            c[0] += 1
            c[1] += e - s
        out["program_idle_gaps"] = [
            [n, t] for n, t in sorted(by_span.items(), key=lambda x: -x[1])]
        out["idle_in_pb_s"] = pb_idle
        out["idle_in_pb_named_by_program"] = named / pb_idle if pb_idle else None
        out["idle_in_execute_s"] = exec_idle
        out["idle_in_execute_below_engine_execute"] = (
            below / exec_idle if exec_idle else None)
        out["program_sites"] = {n: {"count": c, "mean_us": t / c * 1e6}
                                for n, (c, t) in sorted(sites.items())}
        out["ingest_spans"] = sites.get("dispatch.matrix_ingest_edges",
                                        [0])[0]
        out["ingest_launches"] = self.launches.get("matrix_ingest_edges")
        out["device_ops_named_program"] = self.device_ops_named_program
        return out


def run_with_program_spans(name: str, seed: int, seconds: float, device,
                           t_process: float, **kw) -> dict:
    """``harness.run_cell`` traced, with ``ProgramTraceSlice`` as the
    traffic kinds' ``TraceSlice``."""
    from portbench import harness
    plain = trace.TraceSlice
    trace.TraceSlice = ProgramTraceSlice
    try:
        return harness.run_cell(name, seed, seconds, True, device, t_process,
                                **kw)
    finally:
        trace.TraceSlice = plain


def main(argv=None) -> int:
    from portbench import harness, program
    from portbench.run import power_limit
    t_process = harness.process_start()
    ap = argparse.ArgumentParser(prog="python3 -m portbench.program_spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    os.environ.pop("REPRO_PROFILE", None)
    program.import_port()
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 2
    out = run_with_program_spans(args.workload, args.seed, args.seconds,
                                 torch.device("cuda", 0), t_process)
    line = dict(out["line"], card=power_limit(), checks={
        k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()})
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
