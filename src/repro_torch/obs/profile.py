"""Spans at the port's layer boundaries, on the profiler's clock.

``profile_span(site, args)`` opens ``torch.profiler.record_function("repro."
+ site)`` while a ``torch.profiler`` session is active, or always under
``REPRO_PROFILE=1``.  The range lands on the same Kineto timeline as the
device's kernels and copies, so in any profile (``export_chrome_trace``
included) a gap on the device lines up with the innermost span open on the
host.  Under ``REPRO_PROFILE=1`` each span's wall time also lands in the
hub histogram ``repro_profile_seconds{site=...}``, and ``profile_call``
waits for the work the call issued on the card, so the time covers it.

Otherwise a span is one shared no-op object: no range, no allocation, no
hub sample, and no synchronisation.  The off path costs one check of a
flag and one of the profiler's state (``torch.autograd._profiler_enabled``)
besides the ``with`` statement itself, so the spans can stay on every
path.  ``REPRO_PROFILE`` is read when this module is imported.

Every span that is opened is also kept, as (site, start, end) on
``time.perf_counter``'s clock, in a bounded in-process log
(``recorded_spans``): span lengths can be read without the profiler's
events.  The log is a stopgap with one reader, the benchmark's
program-span metrics; it goes once the benchmark's trace slice keeps the
profiler's ``repro.*`` ranges itself.
"""
from __future__ import annotations

import os
import time
from collections import deque

import torch

__all__ = ["profiling_enabled", "profile_call", "profile_span",
           "recorded_spans"]

PREFIX = "repro."
LOG_SPANS = 1 << 17  # a second of a bulk ingest opens about 13,000

_LOG: deque = deque(maxlen=LOG_SPANS)
_profiler_on = torch.autograd._profiler_enabled


def _read_env() -> bool:
    return os.environ.get("REPRO_PROFILE", "") == "1"


_TIMED = _read_env()


def profiling_enabled() -> bool:
    return _TIMED


def _reset_for_tests() -> None:
    """Read ``REPRO_PROFILE`` again and empty the span log."""
    global _TIMED
    _TIMED = _read_env()
    _LOG.clear()


def recorded_spans() -> list[tuple[str, float, float]]:
    """The spans opened so far (the newest ``LOG_SPANS``), as (site,
    start, end) seconds on ``time.perf_counter``'s clock, oldest first."""
    return list(_LOG.copy())


def _record(site: str, dt_s: float) -> None:
    from repro_torch.obs.hub import get_hub
    get_hub().histogram(
        "repro_profile_seconds",
        "wall time of profiled kernel call sites (REPRO_PROFILE=1)",
        site=site).observe(dt_s)


class _Off:
    """The span of every site while nothing records.  ``__enter__`` and
    ``__exit__`` are one C callable that takes any arguments and returns
    "" (falsy, so an exception goes on): the ``with`` statement binds no
    method and makes no Python frame, which takes about a third off its
    cost."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


OFF = _Off()


class _Span:
    """One open ``repro.<site>`` range; ``timed`` under REPRO_PROFILE=1."""

    __slots__ = ("site", "args", "timed", "range", "t0")

    def __init__(self, site: str, args) -> None:
        self.site, self.args, self.timed = site, args, _TIMED

    def __enter__(self) -> None:
        self.range = torch.profiler.record_function(
            PREFIX + self.site, None if self.args is None else str(self.args))
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self.range.__exit__(*exc)
        _LOG.append((self.site, self.t0, t1))
        if self.timed:
            _record(self.site, t1 - self.t0)
        return False


def profile_span(site: str, args=None):
    """A context manager spanning a region as ``repro.<site>``; ``args``
    (shown as text in the range) is formatted only when the span records.
    The region's host time: work it issues on the card may still run."""
    if _TIMED or _profiler_on():
        return _Span(site, args)
    return OFF


def _on_card(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_on_card(x) for x in out)
    return False


def profile_call(site: str, fn, *args, span_args=None, **kwargs):
    """Call ``fn`` inside ``profile_span(site, span_args)``.  Under
    REPRO_PROFILE=1 the span also waits for the card to finish what the
    call issued (if its result lies there), so its recorded time covers
    that work; nothing else synchronises.  Returns the call's result."""
    with profile_span(site, span_args):
        out = fn(*args, **kwargs)
        if _TIMED and _on_card(out):
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
    return out
