"""Gopher Scope, the part ported so far: the partition-skew analytics
(``skew``) that Gopher Balance reads. The tracer and the metrics registry
wait for ROADMAP A7."""
from repro_torch.obs.skew import (SkewTracker, imbalance_score, pair_skew,
                                  skew_report)

__all__ = ["SkewTracker", "imbalance_score", "pair_skew", "skew_report"]
