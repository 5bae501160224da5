"""Telemetry: the mergeable metrics hub (``hub``), a copy of the JAX
package's.  The span log, profiling hooks, JSON dumper and dashboard of the
JAX package's ``repro.obs`` are not ported yet (ROADMAP items 11 and 13b).
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
