"""Telemetry: the mergeable metrics hub (``hub``) and the bounded span log
(``trace``), copies of the JAX package's, and the ``REPRO_PROFILE=1``
timing hooks (``profile``) on ``torch.profiler``.  The JSON dumper and
dashboard of the JAX package's ``repro.obs`` are not ported yet (ROADMAP
item 13b).
"""
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
