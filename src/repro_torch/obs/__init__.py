"""Telemetry: the mergeable metrics hub (``hub``) and the bounded span log
(``trace``), copies of the JAX package's, the spans at the layer
boundaries (``profile``: ``torch.profiler`` ranges under any profiler
session, hub timings under ``REPRO_PROFILE=1``), and the exposition
plumbing (``dump``: the scrape payload and the ``--metrics-json`` file),
and the live terminal poller (``dashboard``, a copy of the JAX package's:
``python -m repro_torch.obs.dashboard``).
"""
from repro_torch.obs.dump import MetricsJsonDumper, scrape_payload  # noqa: F401
from repro_torch.obs.hub import (  # noqa: F401
    LADDERS,
    Counter,
    Gauge,
    Histogram,
    MetricsHub,
    get_hub,
    hist_summary,
    merge_hist_states,
    metrics_disabled,
    quantile_from_state,
    render_prometheus,
    reset_hub,
    set_disabled,
)
from repro_torch.obs.profile import (  # noqa: F401
    profile_call,
    profile_span,
    profiling_enabled,
)
from repro_torch.obs.trace import (  # noqa: F401
    TraceLog,
    get_trace_log,
    new_trace_id,
    reset_trace_log,
)
