"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over the
last ``trace_slice_s`` seconds of the window, bracketed by
synchronisations so that every operation issued inside it also ran inside
it; the profiler's events are read after the window has closed.

What a slice keeps: the device's operations (kernels, copies and fills) as
(name, start, end) seconds from the slice's start; the benchmark's own
host spans (``span``: ``torch.profiler.record_function`` ranges named
``pb.*``); the change in each kernel wrapper's launch counter; and the
slice's wall time.  ``busy_s`` is the union of the device intervals.
"""
from __future__ import annotations

import bisect
import contextlib
import time

from portbench import program

SPAN_PREFIX = "pb."


class Spans:
    """Host spans of the benchmark's loop: ``torch.profiler`` ranges while
    a slice is being traced, nothing otherwise."""

    def __init__(self):
        self.active = False

    def __call__(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(SPAN_PREFIX + name)


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


class TraceSlice:
    """One profiled stretch of a window (``start`` then ``stop``)."""

    def __init__(self, device, spans: Spans):
        self.device = device
        self.spans = spans
        self.t0 = self.t1 = None  # perf_counter at the slice's ends
        self.window_s = 0.0
        self.device_ops: list[tuple[str, float, float]] = []
        self.host_spans: list[tuple[str, float, float]] = []
        self.launches: dict[str, int] = {}
        self._prof = None

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _activities(self):
        from torch.profiler import ProfilerActivity
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        return activities

    def warm(self):
        """Start and stop the profiler once around a tiny operation: its
        first start initialises the device tracer (seconds), which belongs
        to set-up, not to the slice."""
        import torch
        from torch.profiler import profile
        with profile(activities=self._activities()):
            torch.ones(1, device=self.device).add_(1)
            self._sync()

    def start(self):
        from torch.profiler import profile
        activities = self._activities()
        self._sync()
        self._launch0 = program.launch_counts()
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        self.spans.active = True
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.t1 = time.perf_counter()
        self.spans.active = False
        self._prof.__exit__(None, None, None)
        self.window_s = self.t1 - self.t0
        launch1 = program.launch_counts()
        self.launches = {k: launch1[k] - self._launch0.get(k, 0)
                         for k in launch1}
        self._read(self._prof.events())
        self._prof = None

    def _read(self, events):
        from torch.autograd import DeviceType
        for e in events:
            start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
            if e.device_type != DeviceType.CPU:
                # a host range's shadow on the device timeline is no work
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith(SPAN_PREFIX)):
                    self.device_ops.append((e.name, start, end))
            elif e.name.startswith(SPAN_PREFIX):
                self.host_spans.append((e.name[len(SPAN_PREFIX):], start, end))
        self.device_ops.sort(key=lambda x: x[1])
        self.host_spans.sort(key=lambda x: x[1])

    @property
    def busy_s(self) -> float:
        return union_seconds((s, e) for _, s, e in self.device_ops)

    def kernel_seconds(self, fragment: str) -> float:
        """Summed device time of the operations whose name holds
        ``fragment``."""
        return sum(e - s for name, s, e in self.device_ops if fragment in name)

    def _span_at(self, t: float, starts: list) -> str:
        """The innermost host span holding time ``t`` (the latest-starting
        of those that hold it), looking back over at most 64 spans."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 64, -1), -1):
            name, s, e = self.host_spans[j]
            if s <= t < e:
                return name
        return "none"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps summed by the host span they fall in ("none" outside any)."""
        by_name: dict[str, float] = {}
        for name, s, e in self.device_ops:
            name = name[:160]  # templated kernel names run to kilobytes
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
        merged: list[list[float]] = []
        for _, s, e in self.device_ops:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        # the slice spans profiler time 0 .. window_s only approximately;
        # gaps are taken between the device's own operations
        gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
        by_span: dict[str, float] = {}
        starts = [s for _, s, _ in self.host_spans]
        for gs, ge in gaps:
            name = self._span_at((gs + ge) / 2, starts)
            by_span[name] = by_span.get(name, 0.0) + (ge - gs)
        idle = sorted(by_span.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n, t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in idle]}
