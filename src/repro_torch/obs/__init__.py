"""``repro_torch.obs`` — solve-pipeline observability, copied from the
reference package's ``obs`` (stdlib only).

- :mod:`repro_torch.obs.trace` — nestable span/event tracer with a
  guaranteed no-op disabled path, JSONL + Chrome-trace export.
- :mod:`repro_torch.obs.metrics` — labeled counters/gauges/histograms;
  the registry :class:`~repro_torch.solvers.driver.SolveReport` counters
  are derived from.

Span and event names are the reference package's own, documented in
docs/observability.md.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    SERVICE_REPORT_PAIRS,
    SHARD_BYTE_PAIRS,
    TRACE_REPORT_PAIRS,
    check_report_consistency,
    check_trace_report,
)
from repro_torch.obs.trace import (  # noqa: F401
    NULL_TRACER,
    NullTracer,
    Tracer,
    from_jsonl,
)
