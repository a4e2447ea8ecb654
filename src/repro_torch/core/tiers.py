"""Gopher Mesh and Gopher Phases: capacity-tiered exchange planning.

The port's copy of the JAX package's ``core/tiers.py``, numpy only, with
the same arithmetic and the same metrics (plan builds by kind, profile
updates and their drift, in the default registry):

  * every partition pair carries a per-pair **traffic profile** — an EWMA of
    the packed slot counts the compact/tiered exchange already computes
    (``wire_ewma`` on the host graph block, seeded with the structural slot
    occupancy, updated by :func:`update_profile` after each run;
    :func:`announce_frontier` pre-announces a delta's dirty frontier as
    expected traffic);
  * :meth:`TierPlan.build` classifies pairs into static capacity **tiers**
    — hot pairs keep the full ``cap``-slot row, warm pairs ship a packed
    ``cap/8``-slot prefix, cold pairs ship a single width-1 slot, and pairs
    with zero structural occupancy ship **nothing**;
  * :meth:`TierPlan.schedule` lays the tiers out on ``D`` devices: the hot
    tier as one block of per-device-pair rows, the warm/cold tiers as a
    round-robin over only the nonzero device shifts. Every table is a
    numpy constant, so the routed buffer shapes — the physical wire — are
    known before the run (:meth:`TierSchedule.round_slots`). The port runs
    one device (D = 1), where the route is a gather into the receivers'
    slot array (``core.messages.route_tiered``);
  * :class:`PhasedTierPlan` carries K tier tables, one per frontier band
    of a run, derived from the changed-histogram EWMA (:func:`phase_bands`).

Correctness is never bet on the profile: the pack kernel reports per-pair
**overflow** (a pair whose active slot count exceeded its tier width had
messages truncated), the engine repairs it on the dense route — results
stay bit-identical to ``exchange='dense'`` unconditionally — and
:meth:`TierPlan.escalate` promotes the overflowed pairs one tier for the
next run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.gofs.formats import PAD
from repro_torch.obs import metrics as obs_metrics

# tier codes, ordered so escalation is "+1 and clamp"
EXCLUDED = 0    # zero structural occupancy: the pair can never carry a slot
COLD = 1        # width-1 row: historically silent pair, count-only headroom
WARM = 2        # packed cap/8 prefix
HOT = 3         # the full cap-slot row (the dense geometry, per pair)

TIER_NAMES = {EXCLUDED: "excluded", COLD: "cold", WARM: "warm", HOT: "hot"}

# classification thresholds (see TierPlan.build)
COLD_THRESH = 0.5   # expected slots/round at or below this -> cold
PROFILE_DECAY = 0.25  # update_profile: weight kept on the OLD ewma

# Gopher Phases: the changed-histogram EWMA persisted on the graph block —
# per-ROUND expected frontier width (changed slots per exchange round; round 0
# is the inbox prime, superstep s ships round s+1), folded across runs by
# update_changed_profile. Phase boundaries, the announce-floor horizon and the
# per-phase width scaling all derive from it.
PHASE_HIST_LEN = 64   # rounds of history kept (EWMA truncates past this)
MAX_PHASES = 3        # bands a phased plan can carry (and the per-band pair
                      # profile ``phase_pair_ewma`` persists on the block)
CHANGED_EPS = 0.5     # expected slots/round below this counts as quiesced
WIDE_FRAC = 0.25      # frontier >= this fraction of peak -> the wide phase
NARROW_FRAC = 0.05    # frontier < this fraction of peak -> the narrow phase
DEMOTE_STREAK = 2     # consecutive fitting supersteps before a phase demotes


def occupancy_from_ob_inv(ob_inv: np.ndarray) -> np.ndarray:
    """(P, P*cap) outbox slot map -> (P, P) live-slot count per pair: the
    structural ceiling on any superstep's packed count."""
    P = ob_inv.shape[0]
    cap = ob_inv.shape[1] // P
    return (ob_inv.reshape(P, P, cap) != PAD).sum(-1).astype(np.int64)


def occupancy_from_graph(pg) -> np.ndarray:
    """(P, P) live remote-edge count per pair straight from the GoFS fields
    (no block needed)."""
    P = pg.num_parts
    occ = np.zeros((P, P), np.int64)
    live = pg.re_src != PAD
    sp, e = np.nonzero(live)
    np.add.at(occ, (sp, pg.re_dst_part[sp, e]), 1)
    return occ


@dataclasses.dataclass(frozen=True)
class TierPlan:
    """Static per-pair tier assignment. Frozen and hashable, with value
    semantics: two plans with the same fields compare and hash equal.

    Invariants: every field is a plain ``int``/``bytes`` constant, and
    ``tier_bytes`` has exactly ``num_parts**2`` entries — the (P, P)
    row-major pair table the pack and route stages index."""
    num_parts: int
    cap: int
    warm_cap: int
    tier_bytes: bytes            # (P*P,) int8 row-major tier codes

    @property
    def tiers(self) -> np.ndarray:
        P = self.num_parts
        return np.frombuffer(self.tier_bytes, np.int8).reshape(P, P)

    def limits(self) -> np.ndarray:
        """(P, P) int32 slot budget per pair: the tier width the pack stage
        truncates to (and the overflow detector compares counts against)."""
        w = np.array([0, 1, self.warm_cap, self.cap], np.int32)
        return w[self.tiers]

    def counts(self) -> dict:
        t = self.tiers
        return {name: int((t == code).sum()) for code, name in TIER_NAMES.items()}

    # ---------------- construction ----------------
    @staticmethod
    def build(expected: np.ndarray, occupancy: np.ndarray, cap: int,
              warm_div: int = 8) -> "TierPlan":
        """Classify pairs from ``expected`` (EWMA slots/round, (P, P) float)
        clamped by ``occupancy`` (structural live slots, (P, P) int):

          occupancy == 0      -> EXCLUDED  (nothing can ever ship)
          occupancy == 1      -> COLD      (width 1 covers the worst case)
          ew >  warm_cap      -> HOT       (full cap row)
          ew <= COLD_THRESH   -> COLD      (width 1)
          otherwise           -> WARM      (cap / warm_div prefix)

        where ``ew = min(expected, occupancy)``. With ``expected ==
        occupancy`` (the structural prior a cold-built block carries) no
        pair's width can be below its maximum possible count, so the plan
        provably never overflows; a learned profile trades that guarantee
        for geometry, backstopped by the dense fallback retry."""
        P = occupancy.shape[0]
        warm_cap = min(max(1, -(-cap // warm_div)), cap)
        ew = np.minimum(np.asarray(expected, np.float64), occupancy)
        t = np.full((P, P), WARM, np.int8)
        t[ew <= COLD_THRESH] = COLD
        t[ew > warm_cap] = HOT
        t[occupancy <= 1] = COLD
        t[occupancy <= 0] = EXCLUDED
        _plan_built("static")
        return TierPlan(num_parts=P, cap=int(cap), warm_cap=int(warm_cap),
                        tier_bytes=t.tobytes())

    @staticmethod
    def from_block(host_gb: dict, warm_div: int = 8) -> "TierPlan":
        """Plan from a host graph block: structural occupancy from its
        outbox slot map, expected traffic from its ``wire_ewma`` profile."""
        occ = occupancy_from_ob_inv(host_gb["ob_inv"])
        ew = host_gb.get("wire_ewma")
        if ew is None:
            ew = occ
        cap = host_gb["ob_inv"].shape[1] // host_gb["ob_inv"].shape[0]
        return TierPlan.build(ew, occ, cap, warm_div=warm_div)

    @staticmethod
    def from_graph(pg, warm_div: int = 8) -> "TierPlan":
        """Structural plan (no history): expected = occupancy, so every
        pair's width covers its worst case — never overflows. The engine's
        default when ``exchange='tiered'`` is requested without a plan."""
        occ = occupancy_from_graph(pg)
        return TierPlan.build(occ, occ, pg.mailbox_cap, warm_div=warm_div)

    # ---------------- escalation ----------------
    def escalate(self, pair_mask: np.ndarray) -> "TierPlan":
        """Promote overflowed pairs one tier (COLD->WARM->HOT); a pair that
        overflowed while EXCLUDED signals a plan/block mismatch and jumps
        straight to HOT. Returns a new plan (self is frozen)."""
        t = self.tiers.copy()
        m = np.asarray(pair_mask, bool)
        t[m & (t == EXCLUDED)] = HOT
        t[m & (t > EXCLUDED)] = np.minimum(t[m & (t > EXCLUDED)] + 1, HOT)
        return dataclasses.replace(self, tier_bytes=t.tobytes())

    def escalations_from(self, old: "TierPlan") -> int:
        return int((self.tiers > old.tiers).sum())

    # ---------------- physical schedule ----------------
    def schedule(self, num_devices: int = 1) -> "TierSchedule":
        return TierSchedule(self, num_devices)


# sentinel boundary for a plan's last phase: it runs to quiescence
_NO_BOUNDARY = 1 << 30


def phase_bands(changed_ewma: Optional[np.ndarray],
                max_phases: int = 3) -> Tuple[Tuple[int, int, float], ...]:
    """Derive up to ``max_phases`` frontier bands from the changed-histogram
    EWMA: ``[(end_round, span, mean_width), ...]`` in ROUND units (round 0
    is the inbox prime, superstep s ships round s+1). A band ends at the
    first round after which the expected width STAYS below its threshold
    (``WIDE_FRAC`` / ``NARROW_FRAC`` of the peak) — robust to a frontier
    that briefly dips and rebounds. With no usable history (cold block,
    all-zero EWMA) there is a single unbounded band."""
    if changed_ewma is None:
        return ((_NO_BOUNDARY, _NO_BOUNDARY, 1.0),)
    ch = np.asarray(changed_ewma, np.float64).reshape(-1)
    peak = float(ch.max()) if ch.size else 0.0
    if peak <= CHANGED_EPS:
        return ((_NO_BOUNDARY, _NO_BOUNDARY, 1.0),)
    horizon = int(np.flatnonzero(ch >= CHANGED_EPS).max()) + 1
    # suffix maxima: band k ends where the rest of the run never widens back
    suf = np.maximum.accumulate(ch[::-1])[::-1]
    bands = []
    start = 0
    fracs = [WIDE_FRAC, NARROW_FRAC] if max_phases >= 3 else [NARROW_FRAC]
    for frac in fracs[:max_phases - 1]:
        below = np.flatnonzero(suf < frac * peak)
        end = int(below.min()) if below.size else horizon
        end = min(end, horizon)
        if end - start >= 1:
            bands.append((end, end - start, float(ch[start:end].mean())))
            start = end
    tail = ch[start:horizon]
    bands.append((_NO_BOUNDARY, max(horizon - start, 1),
                  float(tail.mean()) if tail.size else 0.0))
    return tuple(bands)


def expected_horizon(changed_ewma: Optional[np.ndarray]) -> Optional[int]:
    """Expected round horizon of the next run: the last round the
    changed-histogram EWMA still expects activity at (plus one). ``None``
    when there is no usable history — callers must fall back to their
    unbounded/conservative behavior."""
    if changed_ewma is None:
        return None
    ch = np.asarray(changed_ewma, np.float64).reshape(-1)
    live = np.flatnonzero(ch >= CHANGED_EPS)
    if live.size == 0:
        return None
    return int(live.max()) + 1


@dataclasses.dataclass(frozen=True)
class PhasedTierPlan:
    """Gopher Phases: K per-pair tier tables, one per frontier band of the
    run, each with a PREDICTED switch superstep. A static :class:`TierPlan`
    fixes one interconnect geometry for the whole run even though the
    frontier contracts by orders of magnitude between round 1 and
    convergence; a phased plan lets the engine run one SEGMENT of the BSP
    loop per phase, each with its own tables, and ride the contraction
    within a single run.

    Derivation (:meth:`from_block`): phase boundaries come from the
    changed-histogram EWMA persisted on the graph block
    (``changed_ewma``, fed by :func:`update_changed_profile`); phase k's
    per-pair expectation is the pair profile scaled by the band's relative
    frontier width,

        expected_k = min(wire_ewma, occupancy) · mean_k / mean_run

    so the wide band is at least as wide as the static plan (on a cold
    block that degenerates to the structural prior — provably
    overflow-free) while the narrow tail drops to the converged-frontier
    geometry a static cold plan only reaches on the NEXT version.

    Hashable, with value semantics like :class:`TierPlan`. ``boundaries``
    holds each phase's predicted END round in ROUND units (round 0 is the
    inbox prime, superstep s ships round s+1; phase k's segment stops
    before shipping round ``boundaries[k]``). The last phase carries the
    ``_NO_BOUNDARY`` sentinel: it runs to quiescence. The engine may leave
    a phase EARLY — global halt, or the dynamic demotion trigger (observed
    per-pair counts under the next phase's caps for ``DEMOTE_STREAK``
    consecutive supersteps) — and repairs any phase that truncated with a
    per-superstep dense retry plus a per-phase escalation
    (:meth:`escalate_phase`).

    Shares :class:`TierPlan`'s invariants: every field a plain constant,
    each ``phase_tier_bytes[k]`` exactly ``num_parts**2`` long, one
    boundary per phase with predicted ends strictly increasing and only
    the last phase open-ended (``_NO_BOUNDARY``). The dense-retry repair
    path additionally requires an IDEMPOTENT ⊕ for bit-exactness —
    re-delivering a truncated round must not double-count; PageRank's
    ``sum`` ⊕ is allclose-only."""
    num_parts: int
    cap: int
    warm_cap: int
    phase_tier_bytes: Tuple[bytes, ...]
    boundaries: Tuple[int, ...]

    @property
    def num_phases(self) -> int:
        return len(self.phase_tier_bytes)

    def phase_plans(self) -> Tuple[TierPlan, ...]:
        return tuple(TierPlan(num_parts=self.num_parts, cap=self.cap,
                              warm_cap=self.warm_cap, tier_bytes=b)
                     for b in self.phase_tier_bytes)

    def counts(self) -> list:
        return [p.counts() for p in self.phase_plans()]

    # ---------------- construction ----------------
    @staticmethod
    def build(expected: np.ndarray, occupancy: np.ndarray, cap: int,
              changed_ewma: Optional[np.ndarray] = None, warm_div: int = 8,
              max_phases: int = MAX_PHASES,
              phase_pair_ewma: Optional[np.ndarray] = None
              ) -> "PhasedTierPlan":
        """``phase_pair_ewma`` (K, P, P), when taught (any band nonzero),
        gives band k its OWN observed per-pair profile — the per-band EWMA
        :func:`update_phase_profile` persists on the block — instead of the
        single run-wide profile scaled by the band's relative frontier
        width. A scaled global profile smears the wide band's hub pairs
        into the narrow tail (and vice versa); the per-band record keeps a
        pair that only fires early out of the tail's geometry entirely.
        Untaught bands (all-zero) keep the scaled-global fallback, and an
        under-taught band still costs at most a dense retry, never
        correctness."""
        bands = phase_bands(changed_ewma, max_phases=max_phases)
        ew = np.minimum(np.asarray(expected, np.float64), occupancy)
        spans = np.array([s for _, s, _ in bands], np.float64)
        means = np.array([m for _, _, m in bands], np.float64)
        mean_run = float((spans * means).sum() / max(spans.sum(), 1.0))
        ppe = (np.asarray(phase_pair_ewma, np.float64)
               if phase_pair_ewma is not None else None)
        plans = []
        for k, (_, _, mean_k) in enumerate(bands):
            if ppe is not None and k < ppe.shape[0] and np.any(ppe[k] > 0):
                ek = np.minimum(ppe[k], occupancy)
            else:
                scale = mean_k / mean_run if mean_run > 0 else 1.0
                ek = ew * max(scale, 0.0)
            plans.append(TierPlan.build(ek, occupancy, cap,
                                        warm_div=warm_div))
        ref = plans[0]
        _plan_built("phased")
        return PhasedTierPlan(
            num_parts=ref.num_parts, cap=ref.cap, warm_cap=ref.warm_cap,
            phase_tier_bytes=tuple(p.tier_bytes for p in plans),
            boundaries=tuple(b for b, _, _ in bands))

    @staticmethod
    def from_block(host_gb: dict, warm_div: int = 8,
                   max_phases: int = MAX_PHASES) -> "PhasedTierPlan":
        """Phased plan from a host graph block: structural occupancy from
        the outbox slot map, pair profile from ``wire_ewma``, phase
        boundaries from ``changed_ewma``, per-band pair profiles from
        ``phase_pair_ewma`` when runs have taught them (see
        :func:`update_phase_profile`). On a block with no taught
        changed histogram this degenerates to a single-phase plan identical
        to ``TierPlan.from_block``."""
        occ = occupancy_from_ob_inv(host_gb["ob_inv"])
        ew = host_gb.get("wire_ewma")
        if ew is None:
            ew = occ
        cap = host_gb["ob_inv"].shape[1] // host_gb["ob_inv"].shape[0]
        return PhasedTierPlan.build(ew, occ, cap,
                                    changed_ewma=host_gb.get("changed_ewma"),
                                    warm_div=warm_div, max_phases=max_phases,
                                    phase_pair_ewma=host_gb.get(
                                        "phase_pair_ewma"))

    @staticmethod
    def from_graph(pg, warm_div: int = 8) -> "PhasedTierPlan":
        """Single structural phase (no history): identical geometry to
        ``TierPlan.from_graph`` — never overflows."""
        occ = occupancy_from_graph(pg)
        return PhasedTierPlan.build(occ, occ, pg.mailbox_cap,
                                    changed_ewma=None, warm_div=warm_div)

    @staticmethod
    def from_tier_plan(plan: TierPlan) -> "PhasedTierPlan":
        return PhasedTierPlan(num_parts=plan.num_parts, cap=plan.cap,
                              warm_cap=plan.warm_cap,
                              phase_tier_bytes=(plan.tier_bytes,),
                              boundaries=(_NO_BOUNDARY,))

    @staticmethod
    def for_resume(host_gb: dict, warm_div: int = 8,
                   max_phases: int = 3) -> "PhasedTierPlan":
        """Phased plan for a POST-DELTA RESTART (an incremental resume from
        the previous fixpoint). A restart is narrow from round 0 — its
        traffic is the delta's dirty frontier, not the run-shape history —
        and apply_delta pre-announced that frontier EXACTLY
        (``announce_ewma``: per-pair prime-round counts plus the
        horizon-bounded warm floor). Building phase 0 from the announce
        record instead of the pair EWMA is what makes a COLD replica's
        restart cheap: the structural prior (wire_ewma on an untaught
        block) covers the worst case of ANY run, while the announce covers
        exactly this one — the prime round provably fits (announced counts
        are exact, and TierPlan.build gives every pair at least its
        expected width), and later supersteps ride the warm floor plus the
        per-superstep dense-retry backstop. Tail phases scale the announce
        down by the changed-histogram bands' relative widths. Falls back
        to :meth:`from_block` when no announce is pending (e.g. a re-run
        with no intervening delta)."""
        ann = host_gb.get("announce_ewma")
        if ann is None or not np.any(np.asarray(ann) > 0):
            return PhasedTierPlan.from_block(host_gb, warm_div=warm_div,
                                             max_phases=max_phases)
        occ = occupancy_from_ob_inv(host_gb["ob_inv"])
        cap = host_gb["ob_inv"].shape[1] // host_gb["ob_inv"].shape[0]
        ew = np.minimum(np.asarray(ann, np.float64), occ)
        bands = phase_bands(host_gb.get("changed_ewma"),
                            max_phases=max_phases)
        plans = [TierPlan.build(ew, occ, cap, warm_div=warm_div)]
        mean0 = max(bands[0][2], 1e-9)
        for _, _, mean_k in bands[1:]:
            plans.append(TierPlan.build(ew * (mean_k / mean0), occ, cap,
                                        warm_div=warm_div))
        ref = plans[0]
        _plan_built("resume")
        return PhasedTierPlan(
            num_parts=ref.num_parts, cap=ref.cap, warm_cap=ref.warm_cap,
            phase_tier_bytes=tuple(p.tier_bytes for p in plans),
            boundaries=tuple(b for b, _, _ in bands))

    @staticmethod
    def narrow_resume(host_gb: dict, warm_div: int = 8) -> "PhasedTierPlan":
        """Single-phase plan at the resume geometry — for runs that are
        narrow-frontier resumes from superstep 0 and stay narrow (the
        landmark refresh path: a handful of stale query lanes re-relaxing
        a small dirty region never sees the wide band). The widths come
        from the announce record (:meth:`for_resume`'s phase 0); with no
        announce pending (a resume with no intervening delta is quiesced)
        they fall back to the profile plan's NARROW tail. Overflow is
        repaired by the phased engine's per-superstep dense retry, so
        underestimating a resume's width costs a retried round, never
        correctness."""
        ann = host_gb.get("announce_ewma")
        announced = ann is not None and bool(np.any(np.asarray(ann) > 0))
        full = (PhasedTierPlan.for_resume(host_gb, warm_div=warm_div)
                if announced
                else PhasedTierPlan.from_block(host_gb, warm_div=warm_div))
        pick = 0 if announced else -1
        return PhasedTierPlan(
            num_parts=full.num_parts, cap=full.cap, warm_cap=full.warm_cap,
            phase_tier_bytes=(full.phase_tier_bytes[pick],),
            boundaries=(_NO_BOUNDARY,))

    # ---------------- escalation ----------------
    def escalate_phase(self, phase: int, pair_mask: np.ndarray
                       ) -> "PhasedTierPlan":
        """Promote the overflowed pairs of ONE phase one tier — the other
        phases' geometry is untouched (a spill in the narrow tail says
        nothing about the wide band's widths)."""
        plans = list(self.phase_plans())
        plans[phase] = plans[phase].escalate(pair_mask)
        return dataclasses.replace(
            self, phase_tier_bytes=tuple(p.tier_bytes for p in plans))

    def escalations_from(self, old: "PhasedTierPlan") -> int:
        return sum(p.escalations_from(q) for p, q in
                   zip(self.phase_plans(), old.phase_plans()))


class TierSchedule:
    """The tier plan laid out on a concrete mesh of ``D`` devices (``v =
    P / D`` partitions each). All tables are numpy constants consumed at
    the engine's route; the leading axis is the device id (the port runs
    D = 1, so it is always 0).

      hot_send (D, D, h)  sender i, destination-device block j, row r ->
                          flat local outbox row ``(s % v) * P + d`` (PAD pads)
      hot_recv (D, D, h)  receiver j, source-device block i, row r ->
                          flat local inbox pair ``(d % v) * P + s``
      hot_res_shifts      [(k, g, send (D, g), recv (D, g)), ...] — hot rows
                          BEYOND the uniform all_to_all block, shipped dense
                          (full cap, no ids) by one ppermute per shift
      warm/cold shifts    [(k, g, send (D, g), recv (D, g)), ...] — shift k
                          ships rows whose destination device is ``(i + k) %
                          D`` via one ppermute; shifts with zero pairs on
                          every device are skipped entirely (the round-robin
                          covers only the nonzero device pairs).

    The hot tier is TWO-LEVEL: the all_to_all row block ``h`` is sized to
    the MINIMUM per-device-pair hot count (uniform — every pair contributes
    ``h`` full rows, so nothing inside it is padding), and the rows beyond
    it ride a residual ppermute schedule. A skewed mesh therefore stops
    padding every device's tables to the global max pair count: only the
    devices that actually own the excess ship it. At D == 1 (or any
    perfectly balanced mesh) min == max and the residual is empty, so the
    layout — and every routed bit — is unchanged.
    """

    def __init__(self, plan: TierPlan, num_devices: int):
        P, D = plan.num_parts, num_devices
        assert P % D == 0, "partitions must tile the device mesh"
        v = P // D
        self.plan = plan
        self.D, self.v, self.P = D, v, P
        self.cap, self.warm_cap = plan.cap, plan.warm_cap
        tiers = plan.tiers

        # hot tier, two-level: a uniform all_to_all block sized to the
        # MINIMUM per-device-pair count, plus a residual ppermute schedule
        # for the rows beyond it (dense rows — same geometry, no ids)
        hs, hd = np.nonzero(tiers == HOT)
        di, dj = hs // v, hd // v
        m = np.zeros((D, D), np.int64)
        np.add.at(m, (di, dj), 1)
        self.hot_h = hb = int(m.min()) if m.size else 0
        self.hot_send = np.full((D, D, max(hb, 1)), PAD, np.int32)
        self.hot_recv = np.full((D, D, max(hb, 1)), PAD, np.int32)
        fill = np.zeros((D, D), np.int64)
        res = []            # residual hot rows past the uniform block
        for s, d in zip(hs, hd):
            i, j = s // v, d // v
            r = fill[i, j]
            fill[i, j] = r + 1
            if r < hb:
                self.hot_send[i, j, r] = (s % v) * P + d
                self.hot_recv[j, i, r] = (d % v) * P + s
            else:
                res.append((int((j - i) % D), int(i), int(s), int(d)))
        shifts = []
        for k in sorted({k for k, _, _, _ in res}):
            rows = [(i, s, d) for kk, i, s, d in res if kk == k]
            cnt = np.zeros(D, np.int64)
            for i, _, _ in rows:
                cnt[i] += 1
            g = int(cnt.max())
            send = np.full((D, g), PAD, np.int32)
            recv = np.full((D, g), PAD, np.int32)
            fillr = np.zeros(D, np.int64)
            for i, s, d in rows:
                j = (i + k) % D
                r = fillr[i]
                fillr[i] = r + 1
                send[i, r] = (s % v) * P + d
                recv[j, r] = (d % v) * P + s
            shifts.append((k, g, send, recv))
        self.hot_res_shifts = tuple(shifts)

        # warm/cold tiers: ppermute round-robin over device shifts
        def shifts_for(code):
            ss, dd = np.nonzero(tiers == code)
            out = []
            for k in range(D):
                sel = (dd // v) == ((ss // v) + k) % D
                if not sel.any():
                    continue
                cnt = np.zeros(D, np.int64)
                np.add.at(cnt, ss[sel] // v, 1)
                g = int(cnt.max())
                send = np.full((D, g), PAD, np.int32)
                recv = np.full((D, g), PAD, np.int32)
                fill = np.zeros(D, np.int64)
                for s, d in zip(ss[sel], dd[sel]):
                    i = s // v
                    j = (i + k) % D
                    r = fill[i]
                    fill[i] = r + 1
                    send[i, r] = (s % v) * P + d
                    recv[j, r] = (d % v) * P + s
                out.append((k, g, send, recv))
            return tuple(out)

        self.warm_shifts = shifts_for(WARM)
        self.cold_shifts = shifts_for(COLD)

    # ---------------- static wire accounting ----------------
    def round_slots(self) -> int:
        """Value slots (Q-groups) physically routed per exchange round —
        the buffer geometry, data-independent. Dense ships P²·cap."""
        hot = self.D * self.D * self.hot_h * self.cap
        hot += sum(self.D * g * self.cap for _, g, _, _ in self.hot_res_shifts)
        warm = sum(self.D * g * self.warm_cap for _, g, _, _ in self.warm_shifts)
        cold = sum(self.D * g for _, g, _, _ in self.cold_shifts)
        return hot + warm + cold

    def round_index_slots(self) -> int:
        """int32 slot-id lanes riding beside the warm/cold value slots (hot
        rows are dense — no ids travel)."""
        warm = sum(self.D * g * self.warm_cap for _, g, _, _ in self.warm_shifts)
        cold = sum(self.D * g for _, g, _, _ in self.cold_shifts)
        return warm + cold

    def round_bytes(self, num_queries: Optional[int]) -> int:
        q = num_queries or 1
        return self.round_slots() * 4 * q + self.round_index_slots() * 4

    def device_round_slots(self) -> int:
        """Per-device share of round_slots (what one shard reports before
        the cross-device psum)."""
        return self.round_slots() // self.D

    def kind_byte_budgets(self, num_queries: Optional[int]) -> dict:
        """Per-HLO-collective-kind, PER-DEVICE byte ceilings of one exchange
        round, split by the collective kind a multi-device mesh would use.

        ``all-to-all`` is the hot tier's uniform row block: every device
        ships D destination blocks of ``hot_h`` dense rows, ``cap`` value
        slots each. ``collective-permute`` is everything shifted — hot
        residual rows (dense, no ids), warm rows (values + int32 slot-id
        lanes) and cold singles (one value + one id) — summed over the
        round's shifts. The two budgets sum to
        ``round_bytes(q) // D``: the per-kind split is a refinement of the
        round total, not a second accounting."""
        q = num_queries or 1
        a2a = self.D * self.hot_h * self.cap * 4 * q
        cp = sum(g * self.cap * 4 * q for _, g, _, _ in self.hot_res_shifts)
        cp += sum(g * self.warm_cap * (4 * q + 4)
                  for _, g, _, _ in self.warm_shifts)
        cp += sum(g * (4 * q + 4) for _, g, _, _ in self.cold_shifts)
        return {"all-to-all": a2a, "collective-permute": cp}


def announce_frontier(host_gb: dict, pg, dirty: np.ndarray) -> None:
    """Pre-announce a delta's dirty frontier into the block's ``wire_ewma``
    (in place), two layers deep:

      1. pairs whose SOURCE VERTEX is dirty rise to their exact live-slot
         count — precisely what the next incremental run's inbox-prime
         round ships;
      2. every pair of a partition within the restart's EXPECTED SUPERSTEP
         HORIZON of the dirty set (meta-graph hops) rises to a WARM floor
         (``min(occupancy, COLD_THRESH·2 + 1)``): an incremental
         superstep's senders can only be partitions the dirty seeds reach
         through meta-edges, and in an h-superstep restart they can reach
         at most h hops — so the floor warms exactly the pairs that CAN
         fire before the predicted quiescence, not the whole closure. The
         horizon comes from the block's changed-histogram EWMA
         (:func:`expected_horizon`); with no taught history the floor
         falls back to the full meta-closure (the conservative
         behavior), and a horizon the history underestimates costs at most
         an overflow retry, never correctness.

    ``max``, not ``+=`` — idempotent across event replays on block
    replicas. The overflow/escalation retry backstops whatever this floor
    still underestimates."""
    ew = host_gb.get("wire_ewma")
    if ew is None:
        return
    P = pg.num_parts
    expect = np.zeros((P, P), np.float64)
    live = pg.re_src != PAD
    sp, e = np.nonzero(live)
    src_dirty = np.asarray(dirty, bool)[sp, pg.re_src[sp, e]]
    np.add.at(expect, (sp[src_dirty], pg.re_dst_part[sp[src_dirty],
                                                     e[src_dirty]]), 1)
    # meta-closure warm floor, bounded by the expected superstep horizon
    occ = occupancy_from_graph(pg)
    reach = np.asarray(dirty, bool).any(1)
    adj = occ > 0
    horizon = expected_horizon(host_gb.get("changed_ewma"))
    hops = 0
    while horizon is None or hops < horizon:
        grown = reach | adj[reach].any(0)
        if (grown == reach).all():
            break
        reach = grown
        hops += 1
    floor = np.where(reach[:, None], np.minimum(occ, 2 * COLD_THRESH + 1),
                     0.0)
    announced = np.maximum(expect, floor)
    host_gb["wire_ewma"] = np.maximum(
        np.asarray(ew, np.float64), announced).astype(np.float32)
    # the announce record itself, kept SEPARATE from the EWMA: the exact
    # per-pair expectation of the NEXT restart's traffic. On a fresh
    # replica the EWMA still sits at the structural prior (the max above is
    # a no-op), but the restart's prime round ships exactly ``expect`` —
    # PhasedTierPlan.for_resume builds from this record, which is how a
    # COLD block still gets restart-narrow geometry. max-combined so
    # stacked deltas before one run stay covered; consumed (cleared) by
    # update_profile once a run has folded its observation.
    prev = host_gb.get("announce_ewma")
    if prev is not None:
        announced = np.maximum(np.asarray(prev, np.float64), announced)
    host_gb["announce_ewma"] = announced.astype(np.float32)


def update_profile(host_gb: dict, pair_slots: np.ndarray, rounds: int,
                   decay: float = PROFILE_DECAY) -> np.ndarray:
    """Fold one run's observed per-pair packed counts into the block's
    ``wire_ewma`` profile (in place):

        ewma' = decay * ewma + (1 - decay) * pair_slots / rounds

    ``pair_slots`` is ``Telemetry.pair_slots`` — the (P, P) sum of packed
    counts over the run's exchange rounds (compact and tiered modes record
    it; the tiered counts are pre-truncation, so an overflowing pair's true
    demand raises its profile even while its messages were clipped). After
    a dense fallback retry, normalize by ``Telemetry.pair_rounds`` — the
    aborted tiered attempt's round count, which the counts actually cover —
    not ``supersteps + 1``. A block with no profile (not built by
    host_graph_block) is left untouched.

    Folding an observation also CONSUMES the pending announce record
    (``announce_ewma``): the run it pre-announced has happened, and the
    observation now carries the real counts."""
    ew = host_gb.get("wire_ewma")
    if ew is None:
        return None
    old = np.asarray(ew, np.float64)
    obs = np.asarray(pair_slots, np.float64) / max(int(rounds), 1)
    out = (decay * old + (1.0 - decay) * obs).astype(np.float32)
    host_gb["wire_ewma"] = out
    if host_gb.get("announce_ewma") is not None:
        host_gb["announce_ewma"] = np.zeros_like(out)
    _profile_updated("wire", out, old)
    return out


def update_changed_profile(host_gb: dict, count_hist,
                           decay: float = PROFILE_DECAY) -> Optional[np.ndarray]:
    """Fold one run's per-ROUND changed-slot histogram into the block's
    ``changed_ewma`` (in place):

        ewma' = decay * ewma + (1 - decay) * count_hist (zero-extended)

    ``count_hist`` is ``Telemetry.count_hist`` — the Σ of packed per-pair
    counts each exchange round shipped, indexed in round units: entry 0 is
    the inbox prime, entry s+1 is superstep s's exchange (the frontier
    width in mailbox slots; compact, tiered and phased runs all record
    it). Observations are ZERO-extended past the run's realized rounds: a
    run that converged early is evidence the tail is quiet, exactly what
    the phase boundaries and the announce-floor horizon should learn.
    Entries past ``PHASE_HIST_LEN`` are truncated (a run that long pins
    its tail phase anyway). A block with no ``changed_ewma`` is left
    untouched."""
    ch = host_gb.get("changed_ewma")
    if ch is None or count_hist is None:
        return None
    obs = np.zeros(PHASE_HIST_LEN, np.float64)
    hist = np.asarray(count_hist, np.float64).reshape(-1)[:PHASE_HIST_LEN]
    obs[:hist.size] = hist
    old = np.asarray(ch, np.float64)
    out = (decay * old + (1.0 - decay) * obs).astype(np.float32)
    host_gb["changed_ewma"] = out
    _profile_updated("changed", out, old)
    return out


def update_phase_profile(host_gb: dict, phase_pair_slots, phase_hist,
                         decay: float = PROFILE_DECAY
                         ) -> Optional[np.ndarray]:
    """Fold one phased run's PER-BAND pair observations into the block's
    ``phase_pair_ewma`` (in place), band by band:

        ewma'[k] = decay * ewma[k]
                   + (1 - decay) * phase_pair_slots[k] / rounds_in_band_k

    ``phase_pair_slots`` is ``Telemetry.phase_pair_slots`` — the (K, P, P)
    per-phase sum of packed counts — and ``phase_hist`` is
    ``Telemetry.phase_hist``, the per-round phase index, whose bincount
    gives each band's realized round count (the normalizer). A band the
    run never entered (zero rounds — e.g. an early global halt skipped the
    narrow tail) is LEFT ALONE rather than decayed toward zero: absence of
    rounds is absence of evidence, not evidence of silence. Bands past the
    stored profile's depth (``MAX_PHASES``) are dropped. A block without
    the profile (not built by host_graph_block) is left untouched.

    :meth:`PhasedTierPlan.build` consumes the taught profile per band, so
    each band's geometry tracks the pairs that actually fire IN that band
    instead of one global EWMA rescaled by frontier width."""
    ppe = host_gb.get("phase_pair_ewma")
    if ppe is None or phase_pair_slots is None or phase_hist is None:
        return None
    obs = np.asarray(phase_pair_slots, np.float64)
    old = np.asarray(ppe, np.float64)
    K = min(obs.shape[0], old.shape[0])
    rounds_k = np.bincount(np.asarray(phase_hist, np.int64).reshape(-1),
                           minlength=K)
    out = old.copy()
    for k in range(K):
        if rounds_k[k] <= 0:
            continue
        out[k] = (decay * old[k]
                  + (1.0 - decay) * obs[k] / int(rounds_k[k]))
    host_gb["phase_pair_ewma"] = out.astype(np.float32)
    _profile_updated("phase_pair", out, old)
    return host_gb["phase_pair_ewma"]


def _plan_built(kind: str) -> None:
    obs_metrics.default_registry().counter(
        "tiers_plans_built_total", labels={"kind": kind}).inc()


def _profile_updated(profile: str, out: np.ndarray, old: np.ndarray) -> None:
    """Count one profile fold and gauge its drift, |out − old|₁ over
    max(|old|₁, 1): how far the observation moved the profile, the signal
    that a plan rebuild is due."""
    reg = obs_metrics.default_registry()
    reg.counter("tiers_profile_updates_total",
                labels={"profile": profile}).inc()
    reg.gauge("tiers_profile_drift", labels={"profile": profile}).set(
        float(np.abs(out - old).sum()) / max(float(np.abs(old).sum()), 1.0))
