"""Host-side observability (counterpart of ``dlbb_tpu/obs``): the span
tracer (``spans``) and the metrics registry with its Prometheus textfile
export (``export``), copies of the JAX modules.  Device traces and ``cli
obs`` come with ROADMAP Queue 1, Slice F, item 13, and the cost model's
calibration, fit and attribution with item 14."""

from dlbb_tpu_torch.obs.export import LabeledCounter, MetricsRegistry
from dlbb_tpu_torch.obs.spans import (
    SpanTracer,
    instant,
    journal_sink,
    journal_to_trace,
    span,
    tracing,
    validate_trace_events,
)

__all__ = [
    "LabeledCounter",
    "MetricsRegistry",
    "SpanTracer",
    "instant",
    "journal_sink",
    "journal_to_trace",
    "span",
    "tracing",
    "validate_trace_events",
]
