"""Observability: the typed metrics registry (:mod:`.metrics`), its
Prometheus text exposition (:mod:`.export`) and request-scoped tracing
(:mod:`.tracing`), the port's copies of the reference's jax-free modules."""

from repro_torch.obs.export import prometheus_text
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry)
from repro_torch.obs.tracing import Span, TraceContext, Tracer, now_ns

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS", "Span", "TraceContext", "Tracer", "now_ns",
           "prometheus_text"]
