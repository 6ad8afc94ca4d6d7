"""Stdlib-only observability of the port: metrics, traces, event logs.

The port's copies of the in-process half of ``repro.obs``:

  * :mod:`repro_torch.obs.metrics` — the thread-safe counter / gauge /
    histogram registry with label support and EWMA gauges, rendered in
    Prometheus text exposition format 0.0.4;
  * :mod:`repro_torch.obs.trace` — trace-ID minting and sanitising, span
    timing contexts, and the JSON-lines structured event log.

The engine, the online refresher and ``fit(event_log=)`` report through
them. The fleet-level half sits on top:

  * :mod:`repro_torch.obs.scrape` — the Prometheus text-format parser
    (exact inverse of the renderer) and the :class:`FleetScraper` that
    polls N replicas and aggregates their families under a ``replica``
    label;
  * :mod:`repro_torch.obs.slo` — SLO objects, multi-window error-budget
    burn-rate rules, and the OK/WARN/PAGE alert state machine feeding JSONL
    alert events and ``gp_slo_*`` gauges.
"""
from repro_torch.obs.metrics import (
    NULL_REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    bucket_fraction_le,
    default_registry,
    quantile_from_buckets,
    render_prometheus,
)
from repro_torch.obs.scrape import (
    Family,
    FleetScraper,
    Sample,
    parse_prometheus,
)
from repro_torch.obs.slo import (
    AvailabilitySLO,
    BurnRateRule,
    LatencySLO,
    SLOEngine,
    default_rules,
)
from repro_torch.obs.trace import (
    TRACE_HEADER,
    EventLog,
    configure,
    current_trace_id,
    emit,
    get_event_log,
    new_trace_id,
    sanitize_trace_id,
    span,
    trace_context,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "NULL_REGISTRY", "bucket_fraction_le", "default_registry",
    "quantile_from_buckets", "render_prometheus",
    "Family", "FleetScraper", "Sample", "parse_prometheus",
    "AvailabilitySLO", "BurnRateRule", "LatencySLO", "SLOEngine",
    "default_rules",
    "TRACE_HEADER", "EventLog", "configure", "current_trace_id", "emit",
    "get_event_log", "new_trace_id", "sanitize_trace_id", "span",
    "trace_context",
]
