"""Graph blocks: the per-partition tensor bundle the engine runs over, and
its zero-repack versioned patch path.

A *graph block* is the per-partition array bundle (leading axis P) derived
from a PartitionedGraph: the raw GoFS fields, the two-binned ELL adjacency
(``_binned_adjacency``), the gather-form mailbox inverse maps
(``_mailbox_inverse``), and the planning metadata the tier plans are built
from (``core.tiers``). The HOST block (numpy) is built once, O(E) host
work; ``device_block`` uploads it as torch tensors onto one device,
decoding the feed maps to runtime flat indices on the way and leaving the
host-only entries behind: the planning metadata, and — unless asked for
with ``binned=True`` — the binned adjacency, which only the serving sweeps
(query-batched programs) read. ``graph_block``, the engine's cold build,
computes the binned adjacency only for such a program.

``patch_host_block`` edits the previous version's HOST block in O(|delta|)
for the temporal path (``gofs.temporal.apply_delta``): touched local ELL
rows are re-binned one by one (hubs grow monotonically; the w_lo / m_lo
lane widths stay those of the base build, so almost no delta changes an
array shape), freed mailbox slots are PAD-ed out of ``ob_inv`` and the
destination feed lists, and new remote edges splice into both sides of the
routing plan. Shapes change only when a delta overflows a frozen budget
(hub rows, feed width, mailbox cap), each growth lane-padded.
``verify_host_block`` audits a host block's structure.

This is the host half of the JAX package's ``core/blocks.py`` with the same
arithmetic, so the two host blocks, cold or patched, agree entry for entry.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tiers import (MAX_PHASES, PHASE_HIST_LEN,
                                    occupancy_from_ob_inv)
from repro_torch.gofs.formats import (LANE_PAD, PAD, PartitionedGraph,
                                      _cumcount, grow_last_axis)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.resilience import faults as _faults

_GB_FIELDS = ["nbr", "wgt", "vmask", "out_degree", "global_id", "sg_id",
              "re_src", "re_wgt", "re_dst_part", "re_dst_local", "re_slot"]

# host-block feed-position encoding: src_part * _SLOT_STRIDE + slot. The
# stride is FIXED (not the mailbox cap), so cap growth never invalidates
# stored positions; device_block re-bases onto the runtime cap at upload.
_SLOT_STRIDE = 1 << 16

# host-only block entries: planning metadata no run reads. They stay off
# the device block (their shapes do not follow the per-partition
# leading-axis convention).
_HOST_ONLY = ("changed_ewma", "announce_ewma", "phase_pair_ewma")

# the binned adjacency: read only by the serving sweeps, so it stays in the
# host block, where patch_host_block keeps it current, and goes to the
# device only for query-batched programs (device_block(binned=True))
_BINNED = ("nbr_lo", "wgt_lo", "adj_hub_idx", "adj_hub_nbr", "adj_hub_wgt")


def _binned_adjacency(pg: PartitionedGraph):
    """Two-bin the local ELL by degree: a narrow (P, v_max, w_lo) block for
    the bulk plus a full-width (P, ah_max, d_max) block for the few hub
    rows. One mega-hub otherwise forces every row's sweep lane to its
    width."""
    P, v_max, d_pad = pg.nbr.shape
    deg = (pg.nbr != PAD).sum(2)
    bulk = deg[deg > 0]
    p95 = int(np.percentile(bulk, 95)) if bulk.size else 1
    w_lo = min(((max(p95, 1) + LANE_PAD - 1) // LANE_PAD) * LANE_PAD, d_pad)
    # hub = degree past the narrow width OR any live entry parked past it —
    # post-delta ELL rows can carry holes (apply_delta pokes PAD mid-row),
    # so a row whose degree shrank back under w_lo may still have a live
    # neighbor at a column >= w_lo; truncating it to [:w_lo] would silently
    # drop edges
    is_hub = (deg > w_lo) | (pg.nbr[:, :, w_lo:] != PAD).any(2)
    ah_max = max(int(is_hub.sum(1).max()) if is_hub.size else 0, 1)
    nbr_lo = pg.nbr[:, :, :w_lo].copy()
    wgt_lo = pg.wgt[:, :, :w_lo].copy()
    nbr_lo[is_hub] = PAD
    wgt_lo[is_hub] = 0.0
    hub_idx = np.full((P, ah_max), PAD, np.int32)
    hub_nbr = np.full((P, ah_max, d_pad), PAD, np.int32)
    hub_wgt = np.zeros((P, ah_max, d_pad), np.float32)
    for p in range(P):
        hv = np.flatnonzero(is_hub[p])
        hub_idx[p, :hv.size] = hv
        hub_nbr[p, :hv.size] = pg.nbr[p, hv]
        hub_wgt[p, :hv.size] = pg.wgt[p, hv]
    return nbr_lo, wgt_lo, hub_idx, hub_nbr, hub_wgt


def _mailbox_inverse(pg: PartitionedGraph, lane_pad: int = LANE_PAD):
    """Precompute the mailbox routing plan's INVERSE maps so both sides of
    the superstep exchange are pure gathers (the plan is static: GoFS
    already fixed every slot at build).

      ob_inv   (P, P*cap)        outbox slot -> remote-edge index (PAD empty)
      ib_lo    (P, v_max, m_lo)  vertex -> received positions, PAD fill
      ib_hub_idx (P, hr_max)     vertices receiving > m_lo messages
      ib_hub   (P, hr_max, m_hi) their (wider) feed lists

    The inbox side is two-binned by in-message count: one hub receiver
    would otherwise pad every vertex's feed list to the hub's width.

    HOST blocks store feed positions CAP-INDEPENDENTLY as
    ``src_part * _SLOT_STRIDE + slot``; ``device_block`` decodes to the
    runtime flat index ``src_part * cap + slot`` at upload.
    """
    P, _ = pg.re_src.shape
    cap = pg.mailbox_cap
    v_max = pg.v_max
    # encoding bounds: slot ids share an int32 with src_part at _SLOT_STRIDE;
    # overflow would silently bleed slot bits into the partition field
    if cap >= _SLOT_STRIDE:
        raise ValueError(f"mailbox cap {cap} >= slot stride {_SLOT_STRIDE}")
    if P * _SLOT_STRIDE >= 2 ** 31:
        raise ValueError(
            f"{P} partitions overflow the int32 feed-position encoding")
    sp_all, e_all = np.nonzero(pg.re_src != PAD)
    d_all = pg.re_dst_part[sp_all, e_all].astype(np.int64)
    v_all = pg.re_dst_local[sp_all, e_all].astype(np.int64)
    c_all = pg.re_slot[sp_all, e_all].astype(np.int64)

    ob_inv = np.full((P, P * cap), PAD, np.int32)
    ob_inv[sp_all, d_all * cap + c_all] = e_all

    counts = np.zeros((P, v_max), np.int64)
    np.add.at(counts, (d_all, v_all), 1)
    m_hi = max(int(counts.max()) if counts.size else 1, 1)
    bulk = counts[counts > 0]
    p95 = int(np.percentile(bulk, 95)) if bulk.size else 1
    m_lo = min(((max(p95, 1) + lane_pad - 1) // lane_pad) * lane_pad, m_hi)
    m_hi = ((m_hi + lane_pad - 1) // lane_pad) * lane_pad
    is_hub = counts > m_lo
    hr_max = max(int(is_hub.sum(1).max()) if is_hub.size else 0, 1)

    ib_lo = np.full((P, v_max, m_lo), PAD, np.int32)
    ib_hub_idx = np.full((P, hr_max), PAD, np.int32)
    ib_hub = np.full((P, hr_max, m_hi), PAD, np.int32)
    hub_row = np.full((P, v_max), -1, np.int64)
    for d in range(P):
        hv = np.flatnonzero(is_hub[d])
        hub_row[d, hv] = np.arange(hv.size)
        ib_hub_idx[d, :hv.size] = hv
    k_all = _cumcount(d_all * v_max + v_all)
    f_all = (sp_all * _SLOT_STRIDE + c_all).astype(np.int32)
    hub_msg = is_hub[d_all, v_all]
    ib_lo[d_all[~hub_msg], v_all[~hub_msg], k_all[~hub_msg]] = f_all[~hub_msg]
    ib_hub[d_all[hub_msg], hub_row[d_all[hub_msg], v_all[hub_msg]],
           k_all[hub_msg]] = f_all[hub_msg]
    return ob_inv, ib_lo, ib_hub_idx, ib_hub


def _engine_host_block(pg: PartitionedGraph) -> dict:
    """The host block without the binned adjacency: what the engine's cold
    build (:func:`graph_block`) uploads."""
    gb = {k: np.asarray(getattr(pg, k)) for k in _GB_FIELDS}
    gb["part_index"] = np.arange(pg.num_parts, dtype=np.int32)
    (gb["ob_inv"], gb["ib_lo"],
     gb["ib_hub_idx"], gb["ib_hub"]) = _mailbox_inverse(pg)
    gb["wire_ewma"] = occupancy_from_ob_inv(gb["ob_inv"]).astype(np.float32)
    gb["changed_ewma"] = np.zeros(PHASE_HIST_LEN, np.float32)
    gb["announce_ewma"] = np.zeros_like(gb["wire_ewma"])
    gb["phase_pair_ewma"] = np.zeros(
        (MAX_PHASES,) + gb["wire_ewma"].shape, np.float32)
    for name, arr in pg.attrs.items():
        gb[f"attr_{name}"] = np.asarray(arr)
    return gb


def host_graph_block(pg: PartitionedGraph) -> dict:
    """Cold-build the HOST (numpy) graph block: the raw GoFS fields, the
    partition ids, the binned adjacency, the mailbox inverse maps, the
    planning metadata and the vertex attributes — the JAX package's host
    block, key for key. This is the representation ``patch_host_block``
    edits in O(|delta|) per version.

    The planning metadata: ``wire_ewma`` (P, P float32), the per-pair
    traffic profile (an EWMA of packed slot counts per exchange round),
    seeded with the STRUCTURAL slot occupancy — the worst case any round
    can ship, so a plan built from a fresh block never overflows; and,
    host-only, ``changed_ewma`` (PHASE_HIST_LEN, float32), the expected
    frontier width per round, seeded zero (no history: phased plans
    degenerate to one structural phase until runs teach it),
    ``announce_ewma`` (P, P), the pending announce record (zero: no delta
    pending), and ``phase_pair_ewma`` (MAX_PHASES, P, P), the per-band
    pair profiles. Runs fold their observations in through
    ``core.tiers.update_profile`` / ``update_changed_profile`` /
    ``update_phase_profile``."""
    gb = _engine_host_block(pg)
    gb.update(zip(_BINNED, _binned_adjacency(pg)))
    return gb


def _decode_feeds(host_gb: dict):
    """Re-base the cap-independent feed positions onto the runtime mailbox
    cap: src_part * _SLOT_STRIDE + slot  ->  src_part * cap + slot."""
    P = host_gb["ob_inv"].shape[0]
    cap = host_gb["ob_inv"].shape[1] // P

    def dec(arr):
        q, r = np.divmod(arr, _SLOT_STRIDE)
        return np.where(arr == PAD, PAD, q * cap + r).astype(np.int32)

    return dec(host_gb["ib_lo"]), dec(host_gb["ib_hub"])


def device_block(host_gb: dict, device, binned: bool = False,
                 rows: slice = slice(None)) -> dict:
    """Upload a host block to ``device`` as torch tensors, decoding the feed
    maps to runtime flat indices (see _SLOT_STRIDE). Host-only metadata
    (_HOST_ONLY) stays behind, and so does the binned adjacency (_BINNED)
    unless ``binned``: only query-batched programs (``serving``) read it,
    so a scalar run's device memory holds none of it. The serving layer
    uploads one such block a graph, which all its pooled engines share.

    ``rows`` uploads only those partitions: a ``shard_map`` rank's
    [r·v, (r+1)·v). Every uploaded entry has the leading P axis, and
    ``part_index`` keeps the global partition ids."""
    device = torch.device(device)
    ib_lo, ib_hub = _decode_feeds(host_gb)
    out = {}
    for k, v in host_gb.items():
        if k in _HOST_ONLY or (k in _BINNED and not binned):
            continue
        if k == "ib_lo":
            v = ib_lo
        elif k == "ib_hub":
            v = ib_hub
        out[k] = torch.from_numpy(np.ascontiguousarray(v[rows])).to(device)
    return out


def graph_block(pg: PartitionedGraph, device, binned: bool = False,
                rows: slice = slice(None)) -> dict:
    """The device-side dict of per-partition tensors (leading axis P, or
    the partitions ``rows`` of a ``shard_map`` rank), built without the
    binned adjacency unless ``binned`` (what a query-batched program
    reads)."""
    if binned:
        return device_block(host_graph_block(pg), device, binned=True,
                            rows=rows)
    return device_block(_engine_host_block(pg), device, rows=rows)


def verify_host_block(host_gb: dict) -> list:
    """Cheap structural audit of a host graph block, the corrupted-block
    detector. Returns a list of human-readable problems
    (empty == structurally sound). Vectorized O(block size): catches the
    corruption classes the fault injector (and real bit-rot) produce —
    missing keys, shape drift between paired arrays, out-of-range ids,
    non-finite weights on live lanes — without re-deriving the layout."""
    need = set(_GB_FIELDS) | {"nbr_lo", "wgt_lo", "adj_hub_idx",
                              "adj_hub_nbr", "adj_hub_wgt", "ob_inv",
                              "ib_lo", "ib_hub_idx", "ib_hub", "part_index"}
    missing = sorted(need - set(host_gb))
    if missing:
        return [f"missing block keys: {missing}"]
    problems = []
    nbr = np.asarray(host_gb["nbr"])
    P, v_max = nbr.shape[0], nbr.shape[1]

    def adj(name_n, name_w, bound):
        a = np.asarray(host_gb[name_n])
        w = np.asarray(host_gb[name_w])
        if w.shape != a.shape:
            problems.append(f"{name_w} shape {w.shape} != "
                            f"{name_n} shape {a.shape}")
            return
        live = a != PAD
        if live.any():
            if not np.isfinite(w[live]).all():
                problems.append(f"non-finite weight on live {name_n} lane")
            bad = live & ((a < 0) | (a >= bound))
            if bad.any():
                problems.append(f"{int(bad.sum())} {name_n} ids outside "
                                f"[0, {bound})")

    adj("nbr", "wgt", v_max)
    adj("nbr_lo", "wgt_lo", v_max)
    adj("adj_hub_nbr", "adj_hub_wgt", v_max)
    adj("re_src", "re_wgt", v_max)
    for name, bound in (("re_dst_part", P), ("re_dst_local", v_max)):
        a = np.asarray(host_gb[name])
        live = np.asarray(host_gb["re_src"]) != PAD
        if a.shape == live.shape and live.any():
            bad = live & ((a < 0) | (a >= bound))
            if bad.any():
                problems.append(f"{int(bad.sum())} {name} ids outside "
                                f"[0, {bound})")
    ob_inv = np.asarray(host_gb["ob_inv"])
    if ob_inv.ndim != 2 or ob_inv.shape[0] != P or ob_inv.shape[1] % P:
        problems.append(f"ob_inv shape {ob_inv.shape} is not (P, P*cap) "
                        f"for P={P}")
    return problems


# ---------------- zero-repack versioned patch ----------------

def _grow_axis1(arr: np.ndarray, extra: int, fill):
    pad = [(0, 0), (0, extra)] + [(0, 0)] * (arr.ndim - 2)
    return np.pad(arr, pad, constant_values=fill)


def patch_host_block(gb: dict, new_pg: PartitionedGraph,
                     touched_rows, rdel, radd) -> dict:
    """Patch the previous version's host block into ``new_pg``'s block in
    O(|delta|) — no re-bin, no inverse-map rebuild.

    ``touched_rows``  (T, 2) int (p, v) pairs     local ELL rows whose
                      (or any iterable of pairs)  nbr/wgt changed
    ``rdel``          [(sp, dp, dv, slot)]        freed remote-edge slots
    ``radd``          [(sp, dp, dv, slot, eidx)]  spliced remote edges

    Invariants preserved (the cold build's contract):
      - non-hub adjacency rows keep every live entry inside [:w_lo]
        (apply_delta fills the first PAD hole, so a row only spills past
        w_lo the moment its degree exceeds w_lo — at which point it is
        promoted); hubs never demote, so the hub set grows monotonically;
      - a destination vertex's feed positions live in EITHER ib_lo or its
        ib_hub row, never both (⊕ = sum would double-count otherwise);
      - the mailbox cap is STICKY: it grows (lane-padded) when a new slot
        overflows it and never shrinks, so almost every version keeps the
        block's shapes; feed positions are stride-encoded
        (_SLOT_STRIDE), so growth re-lays only ob_inv, in O(P²·cap).
    """
    _faults.fire("blocks.patch", version=getattr(new_pg, "version", None),
                 parts=new_pg.num_parts)
    out = dict(gb)                               # copy-on-write per array
    for k in _GB_FIELDS:
        out[k] = np.asarray(getattr(new_pg, k))
    P, v_max = new_pg.num_parts, new_pg.v_max
    nbr, wgt = out["nbr"], out["wgt"]
    d_pad = nbr.shape[2]

    # ---- binned adjacency: re-bin only the touched rows (vectorized over
    # the touch set; only the rare hub PROMOTION falls back to a loop) ----
    touched_rows = np.asarray(
        touched_rows if isinstance(touched_rows, np.ndarray)
        else sorted(touched_rows), np.int64).reshape(-1, 2)
    if len(touched_rows):
        nbr_lo = gb["nbr_lo"].copy()
        wgt_lo = gb["wgt_lo"].copy()
        hub_idx = gb["adj_hub_idx"].copy()
        hub_nbr = gb["adj_hub_nbr"]
        hub_wgt = gb["adj_hub_wgt"]
        if hub_nbr.shape[2] < d_pad:             # local ELL widened this delta
            hub_nbr = grow_last_axis(hub_nbr, d_pad - hub_nbr.shape[2], PAD)
            hub_wgt = grow_last_axis(hub_wgt, d_pad - hub_wgt.shape[2], 0.0)
        else:
            hub_nbr, hub_wgt = hub_nbr.copy(), hub_wgt.copy()
        w_lo = nbr_lo.shape[2]
        rows = touched_rows
        ps, vs = rows[:, 0], rows[:, 1]
        hub_eq = hub_idx[ps] == vs[:, None]               # (T, ah_max)
        was_hub = hub_eq.any(1)
        hrow = np.argmax(hub_eq, 1)
        hub_nbr[ps[was_hub], hrow[was_hub]] = nbr[ps[was_hub], vs[was_hub]]
        hub_wgt[ps[was_hub], hrow[was_hub]] = wgt[ps[was_hub], vs[was_hub]]
        fits = (np.all(nbr[ps, vs][:, w_lo:] == PAD, axis=1)
                if w_lo < d_pad else np.ones(ps.size, bool))
        ok = ~was_hub & fits                              # stays narrow-bin
        nbr_lo[ps[ok], vs[ok]] = nbr[ps[ok], vs[ok], :w_lo]
        wgt_lo[ps[ok], vs[ok]] = wgt[ps[ok], vs[ok], :w_lo]
        for p, v in rows[~was_hub & ~fits]:               # promote to hub
            free = np.flatnonzero(hub_idx[p] == PAD)
            if free.size == 0:
                hub_idx = grow_last_axis(hub_idx, LANE_PAD, PAD)
                hub_nbr = _grow_axis1(hub_nbr, LANE_PAD, PAD)
                hub_wgt = _grow_axis1(hub_wgt, LANE_PAD, 0.0)
                free = np.flatnonzero(hub_idx[p] == PAD)
            hub_idx[p, free[0]] = v
            hub_nbr[p, free[0]] = nbr[p, v]
            hub_wgt[p, free[0]] = wgt[p, v]
            nbr_lo[p, v] = PAD
            wgt_lo[p, v] = 0.0
        out["nbr_lo"], out["wgt_lo"] = nbr_lo, wgt_lo
        out["adj_hub_idx"] = hub_idx
        out["adj_hub_nbr"], out["adj_hub_wgt"] = hub_nbr, hub_wgt

    # ---- mailbox inverse maps: splice the remote-edge events ----
    if rdel or radd:
        ib_lo = gb["ib_lo"].copy()
        ib_hub_idx = gb["ib_hub_idx"].copy()
        ib_hub = gb["ib_hub"].copy()
        ob_inv = gb["ob_inv"]
        cap_old = ob_inv.shape[1] // P
        cap = new_pg.mailbox_cap
        if cap >= _SLOT_STRIDE:
            raise ValueError(
                f"mailbox cap {cap} >= slot stride {_SLOT_STRIDE}")
        # a cap SMALLER than the block's would mis-stride every ob_inv splice
        # below (and leave the engine's exchange shapes inconsistent with the
        # graph): replaying DeltaResult.events on a replica block requires
        # the originating apply_delta to have run with block= (sticky cap) —
        # an exact-fit apply_delta can shrink cap and its events are then
        # not replayable onto a wider block.
        if cap < cap_old:
            raise ValueError(f"graph cap {cap} < block cap {cap_old}: "
                             "events not replayable")
        if cap > cap_old:                        # sticky cap overflowed: grow
            # feed positions are cap-independent (_SLOT_STRIDE), so only the
            # outbox slot map itself needs re-laying
            ob_inv = grow_last_axis(ob_inv.reshape(P, P, cap_old),
                                cap - cap_old, PAD).reshape(P, P * cap)
        else:
            ob_inv = ob_inv.copy()
        m_lo = ib_lo.shape[2]

        def _feed_add(dp, dv, fpos):
            # slow path: hub append / promotion / width growth (rare)
            nonlocal ib_hub, ib_hub_idx
            hr = np.flatnonzero(ib_hub_idx[dp] == dv)
            if hr.size:
                free = np.flatnonzero(ib_hub[dp, hr[0]] == PAD)
                if free.size == 0:               # hub feed width overflowed
                    ib_hub = grow_last_axis(ib_hub, LANE_PAD, PAD)
                    free = np.flatnonzero(ib_hub[dp, hr[0]] == PAD)
                ib_hub[dp, hr[0], free[0]] = fpos
                return
            free = np.flatnonzero(ib_lo[dp, dv] == PAD)
            if free.size:
                ib_lo[dp, dv, free[0]] = fpos
                return
            # promote dv to hub receiver: MOVE its feed list (exclusive
            # membership — ⊕ = sum must not see a position twice)
            hfree = np.flatnonzero(ib_hub_idx[dp] == PAD)
            if hfree.size == 0:
                ib_hub_idx = grow_last_axis(ib_hub_idx, LANE_PAD, PAD)
                ib_hub = _grow_axis1(ib_hub, LANE_PAD, PAD)
                hfree = np.flatnonzero(ib_hub_idx[dp] == PAD)
            h = hfree[0]
            ib_hub_idx[dp, h] = dv
            if ib_hub.shape[2] <= m_lo:          # hub width == m_lo: widen so
                ib_hub = grow_last_axis(ib_hub, LANE_PAD, PAD)  # the moved list +
            ib_hub[dp, h, :m_lo] = ib_lo[dp, dv]            # new pos fit
            ib_hub[dp, h, m_lo] = fpos
            ib_lo[dp, dv] = PAD

        if rdel:
            ev = np.asarray(rdel, np.int64)               # (E, 4)
            sp, dp, dv, slot = ev.T
            fpos = (sp * _SLOT_STRIDE + slot).astype(np.int32)
            ob_inv[sp, dp * cap + slot] = PAD
            # each fpos occurs exactly once in its destination's feed list;
            # distinct events hit distinct positions, so one fancy scatter
            # clears them all (hub and narrow receivers separately)
            hub_eq = ib_hub_idx[dp] == dv[:, None]
            in_hub = hub_eq.any(1)
            hr = np.argmax(hub_eq, 1)
            nh = ~in_hub
            if nh.any():
                j = np.argmax(ib_lo[dp[nh], dv[nh]] == fpos[nh][:, None], 1)
                ib_lo[dp[nh], dv[nh], j] = PAD
            if in_hub.any():
                j = np.argmax(ib_hub[dp[in_hub], hr[in_hub]]
                              == fpos[in_hub][:, None], 1)
                ib_hub[dp[in_hub], hr[in_hub], j] = PAD

        if radd:
            ev = np.asarray(radd, np.int64)               # (E, 5)
            sp, dp, dv, slot, eidx = ev.T
            ob_inv[sp, dp * cap + slot] = eidx
            fpos = (sp * _SLOT_STRIDE + slot).astype(np.int32)
            # k-th add to the same feed row takes the row's (k+1)-th PAD
            # hole — vectorized over all events whose row has room; hub
            # appends, overflow and promotion take the slow path
            k = _cumcount(dp * v_max + dv)
            hub_eq = ib_hub_idx[dp] == dv[:, None]
            in_hub = hub_eq.any(1)
            nh = ~in_hub
            holes = np.cumsum(ib_lo[dp, dv] == PAD, 1)    # (E, m_lo)
            room = nh & (holes[:, -1] >= k + 1)
            if room.any():
                j = np.argmax(holes[room] == (k[room] + 1)[:, None], 1)
                ib_lo[dp[room], dv[room], j] = fpos[room]
            rest = ~room
            for i in np.flatnonzero(rest):
                _feed_add(int(dp[i]), int(dv[i]), int(fpos[i]))
        out["ob_inv"] = ob_inv
        out["ib_lo"] = ib_lo
        out["ib_hub_idx"] = ib_hub_idx
        out["ib_hub"] = ib_hub
    elif new_pg.mailbox_cap != gb["ob_inv"].shape[1] // P:
        raise ValueError("mailbox cap changed without remote-edge events")
    reg = obs_metrics.default_registry()
    reg.counter("blocks_patches_total").inc()
    reg.counter("blocks_rows_rebinned_total").inc(len(touched_rows))
    reg.counter("blocks_remote_slots_freed_total").inc(
        len(rdel) if rdel else 0)
    reg.counter("blocks_remote_slots_spliced_total").inc(
        len(radd) if radd else 0)
    return out
