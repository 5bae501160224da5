"""Opt-in kernel timing hooks (``REPRO_PROFILE=1``).

The JAX package's ``obs/profile.py`` on PyTorch.  When enabled, each
hooked call site runs under a ``torch.profiler.record_function`` range
(visible in a ``torch.profiler`` trace) and its wall time lands in the hub
histogram ``repro_profile_seconds{site=...}``; ``profile_call`` also waits
for the work it issued on the card (a CUDA event recorded after the call,
then synchronised) so the time covers it.

Off by default, and then nothing is recorded at all: no range, no event,
no hub sample — a range left in the code would put its device-side span
into any profile taken around it.  The disabled path is a single
env-cached bool check.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

__all__ = ["profiling_enabled", "profile_call", "profile_span"]

_ENABLED: bool | None = None


def profiling_enabled() -> bool:
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = os.environ.get("REPRO_PROFILE", "") == "1"
    return _ENABLED


def _reset_for_tests() -> None:
    global _ENABLED
    _ENABLED = None


def _record(site: str, dt_s: float) -> None:
    from repro_torch.obs.hub import get_hub
    get_hub().histogram(
        "repro_profile_seconds",
        "wall time of profiled kernel call sites (REPRO_PROFILE=1)",
        site=site).observe(dt_s)


@contextmanager
def profile_span(site: str):
    """Context manager form for multi-statement regions (host time of the
    region; the work it issues on the card may still be running)."""
    if not profiling_enabled():
        yield
        return
    with torch.profiler.record_function(site):
        t0 = time.perf_counter()
        yield
    _record(site, time.perf_counter() - t0)


def _on_card(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, (tuple, list)):
        return any(_on_card(x) for x in out)
    return False


def profile_call(site: str, fn, *args, **kwargs):
    """Call ``fn`` and, when profiling, wait for the card to finish what it
    issued (if its result lies there) and record the wall time.  The result
    is returned either way."""
    if not profiling_enabled():
        return fn(*args, **kwargs)
    with torch.profiler.record_function(site):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if _on_card(out):
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        dt = time.perf_counter() - t0
    _record(site, dt)
    return out
