"""Unified telemetry: metrics registry, request tracing, MFU accounting.

Dependency-free (stdlib only — no torch, no numpy): the engine hot path
and the HTTP exposition layer share it. The series, their names, types,
labels, help text and buckets are the JAX package's (schema.py), so
one dashboard and one metric table read both packages.

  metrics.py      process-wide registry (counters / gauges / fixed-bucket
                  histograms) + Prometheus text exposition + mergeable
                  snapshots for multi-host aggregation
  schema.py       THE declaration site for every ollamamq_* metric —
                  imported by the engine/server for handles
  tracing.py      request-lifecycle span traces in a bounded ring buffer,
                  exported as Chrome trace-event JSON (/debug/trace)
  attribution.py  per-request latency attribution: phase timelines from
                  trace events
  slo.py          SLO objectives + multi-window burn-rate alerting + the
                  process-wide alert table (/health, TUI alerts panel)
  mfu.py          analytic FLOPs-per-token model + per-card peak FLOPs
  stepprof.py     per-dispatch phase profiler + HBM timeline
"""

from ollamamq_tpu_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                            MetricsRegistry, REGISTRY)
from ollamamq_tpu_torch.telemetry.slo import Alert, AlertManager, SLOEngine
from ollamamq_tpu_torch.telemetry.tracing import Trace, Tracer

__all__ = [
    "Alert", "AlertManager", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "REGISTRY", "SLOEngine", "Trace", "Tracer",
]
