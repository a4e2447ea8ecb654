"""Gopher Scope: unified tracing, metrics and skew analytics.

Three host-side layers with one rule — zero cost when disabled, and no
device read or launch beyond what the run already does:

  trace.py    nested-span tracer (run → phase → superstep → stage) with
              Chrome-trace/Perfetto + JSONL export; the engine's traced
              stepped driver emits into it
  metrics.py  labeled counters/gauges/histograms; engine, tier planner,
              block patcher, serving loop and resilience all feed the
              process default registry; snapshottable as a plain dict
  skew.py     partition imbalance / straggler scores off live telemetry —
              the input Gopher Balance consumes
"""
from repro_torch.obs.metrics import (MetricsRegistry, default_registry,
                                     set_default_registry, validate_metrics)
from repro_torch.obs.skew import (SkewTracker, imbalance_score, pair_skew,
                                  skew_report)
from repro_torch.obs.trace import (NOOP, Span, Tracer, get_tracer,
                                   set_tracer, validate_chrome_trace)

__all__ = [
    "Tracer", "Span", "NOOP", "get_tracer", "set_tracer",
    "validate_chrome_trace",
    "MetricsRegistry", "default_registry", "set_default_registry",
    "validate_metrics",
    "imbalance_score", "pair_skew", "skew_report", "SkewTracker",
]
