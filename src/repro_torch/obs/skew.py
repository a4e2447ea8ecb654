"""Gopher Scope: partition skew & straggler analytics.

The port's copy of the JAX package's ``obs/skew.py`` (numpy only, the same
arithmetic).

GoFFish's central empirical claim is that time-to-completion is gated by
the SLOWEST sub-graph per superstep (paper Fig. 5; the partitioning-
strategies follow-up attacks exactly this). The engine already accumulates
the raw signals — per-partition cumulative local sweep iterations
(``Telemetry.local_iters``), per-pair packed slot counts
(``Telemetry.pair_slots``) and the host block's ``wire_ewma`` traffic
profile — this module turns them into the scores Gopher Balance will
consume to decide WHICH sub-graphs to migrate:

  * :func:`imbalance_score` — the classic straggler ratio max/mean of the
    per-partition load vector (1.0 = perfectly balanced; the superstep
    barrier makes makespan ∝ max while resources ∝ mean, so the score IS
    the wasted-speedup factor);
  * :func:`skew_report` — per-run report off a Telemetry: compute skew from
    local_iters, wire skew from the per-pair counts (row = send load,
    column = receive load), and the argmax partitions to migrate from;
  * :class:`SkewTracker` — the serving-loop accumulator: folds every
    batch's Telemetry and answers with a live report
    (``GraphQueryService.stats()`` exposes it per graph).

Everything here is O(P²) numpy on post-run host telemetry — nothing
touches the device.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["imbalance_score", "pair_skew", "skew_report", "SkewTracker"]


def imbalance_score(load: Optional[np.ndarray]) -> float:
    """max/mean of a per-partition load vector; 1.0 when balanced, and the
    factor by which the superstep barrier stretches makespan past the
    balanced ideal. 0.0 for empty/all-zero load (nothing ran)."""
    if load is None:
        return 0.0
    v = np.asarray(load, np.float64).reshape(-1)
    if v.size == 0 or not np.any(v > 0):
        return 0.0
    return float(v.max() / v.mean())


def pair_skew(pair_slots: Optional[np.ndarray]) -> dict:
    """Wire-side skew off a (P, P) per-pair slot matrix (Telemetry.pair_slots
    or a block's wire_ewma): send/receive imbalance scores and the heaviest
    pair's share of total traffic."""
    if pair_slots is None:
        return dict(send_imbalance=0.0, recv_imbalance=0.0,
                    max_pair_frac=0.0)
    m = np.asarray(pair_slots, np.float64)
    total = float(m.sum())
    return dict(
        send_imbalance=round(imbalance_score(m.sum(1)), 4),
        recv_imbalance=round(imbalance_score(m.sum(0)), 4),
        max_pair_frac=round(float(m.max()) / total, 4) if total > 0 else 0.0)


def skew_report(telemetry=None, local_iters: Optional[np.ndarray] = None,
                pair_slots: Optional[np.ndarray] = None,
                part_seconds: Optional[np.ndarray] = None) -> dict:
    """The per-run skew report. Pass a ``Telemetry`` (preferred — reads
    local_iters + pair_slots + part_seconds off it) or the raw arrays.

    Keys:
      imbalance       max/mean of per-partition sweep iterations — the
                      straggler score (Telemetry.skew() returns this dict)
      straggler       partition index carrying the max load
      cv              coefficient of variation of the load vector
      mean_iters / max_iters
      wire            pair_skew() of the per-pair slot matrix (None-safe)
      time_imbalance  max/mean of per-partition WALL seconds (Gopher
      time_straggler  Balance's channel: an injected or physical straggler
                      shows up here even when iteration counts stay flat).
                      0.0 / -1 when the run carried no time channel (fused
                      single-dispatch loops).
    """
    if telemetry is not None:
        local_iters = telemetry.local_iters
        pair_slots = telemetry.pair_slots if pair_slots is None \
            else pair_slots
        if part_seconds is None:
            part_seconds = getattr(telemetry, "part_seconds", None)
    li = (np.asarray(local_iters, np.float64).reshape(-1)
          if local_iters is not None else np.zeros(0))
    if li.size and np.any(li > 0):
        rep = dict(imbalance=round(float(li.max() / li.mean()), 4),
                   straggler=int(li.argmax()),
                   cv=round(float(li.std() / max(li.mean(), 1e-12)), 4),
                   mean_iters=round(float(li.mean()), 2),
                   max_iters=int(li.max()))
    else:
        rep = dict(imbalance=0.0, straggler=-1, cv=0.0, mean_iters=0.0,
                   max_iters=0)
    ps = (np.asarray(part_seconds, np.float64).reshape(-1)
          if part_seconds is not None else np.zeros(0))
    if ps.size and np.any(ps > 0):
        rep["time_imbalance"] = round(float(ps.max() / ps.mean()), 4)
        rep["time_straggler"] = int(ps.argmax())
        rep["part_seconds"] = [round(float(x), 6) for x in ps]
    else:
        rep["time_imbalance"] = 0.0
        rep["time_straggler"] = -1
    rep["wire"] = pair_skew(pair_slots)
    return rep


class SkewTracker:
    """Accumulates per-run telemetry into a live per-partition load picture
    — the serving loop keeps one per graph and Gopher Balance's migration
    policy reads it. Loads ACCUMULATE (cumulative sweep iterations are the
    makespan currency); ``decay`` < 1 lets a long-lived service forget old
    shape so a migrated hotspot stops dominating the score."""

    def __init__(self, num_parts: Optional[int] = None, decay: float = 1.0):
        self.decay = float(decay)
        self.runs = 0
        self.liters: Optional[np.ndarray] = (
            np.zeros(num_parts, np.float64) if num_parts else None)
        self.pair_slots: Optional[np.ndarray] = None
        # wall-seconds channel (Telemetry.part_seconds): Gopher Balance's
        # straggler evidence — None until a host-stepped run reports it
        self.seconds: Optional[np.ndarray] = None

    def observe(self, telemetry) -> None:
        li = np.asarray(telemetry.local_iters, np.float64).reshape(-1)
        if self.liters is None:
            self.liters = np.zeros(li.size, np.float64)
        if li.size == self.liters.size:          # a repartition resets shape
            self.liters = self.decay * self.liters + li
        else:
            self.liters = li.copy()
            self.pair_slots = None
            self.seconds = None
        if telemetry.pair_slots is not None:
            ps = np.asarray(telemetry.pair_slots, np.float64)
            if self.pair_slots is None or self.pair_slots.shape != ps.shape:
                self.pair_slots = np.zeros_like(ps)
            self.pair_slots = self.decay * self.pair_slots + ps
        sec = getattr(telemetry, "part_seconds", None)
        if sec is not None:
            sec = np.asarray(sec, np.float64).reshape(-1)
            if self.seconds is None or self.seconds.size != sec.size:
                self.seconds = np.zeros_like(sec)
            self.seconds = self.decay * self.seconds + sec
        self.runs += 1

    def imbalance(self) -> float:
        return round(imbalance_score(self.liters), 4)

    def time_imbalance(self) -> float:
        return round(imbalance_score(self.seconds), 4)

    def report(self) -> dict:
        rep = skew_report(local_iters=self.liters,
                          pair_slots=self.pair_slots,
                          part_seconds=self.seconds)
        rep["runs"] = self.runs
        if self.liters is not None:
            rep["per_partition_iters"] = [round(float(x), 1)
                                          for x in self.liters]
        return rep
