"""Graph blocks: the per-partition tensor bundle the engine runs over.

A *graph block* is the per-partition array bundle (leading axis P) derived
from a PartitionedGraph: the raw GoFS fields and the gather-form mailbox
inverse maps (``_mailbox_inverse``), and the planning metadata the tier
plans are built from (``core.tiers``). The HOST block (numpy) is built
once, O(E) host work; ``device_block`` uploads it as torch tensors onto one
device, decoding the feed maps to runtime flat indices on the way and
leaving the host-only planning entries behind.

This is the host half of the JAX package's ``core/blocks.py`` with the same
arithmetic, so the two host blocks agree entry for entry. Still to come
(ROADMAP): the binned adjacency of the serving path, the zero-repack patch
path and ``verify_host_block``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tiers import (MAX_PHASES, PHASE_HIST_LEN,
                                    occupancy_from_ob_inv)
from repro_torch.gofs.formats import PAD, PartitionedGraph, _cumcount

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


def _mailbox_inverse(pg: PartitionedGraph, lane_pad: int = 8):
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


def host_graph_block(pg: PartitionedGraph) -> dict:
    """Cold-build the HOST (numpy) graph block: the raw GoFS fields, the
    partition ids, the mailbox inverse maps, the planning metadata and the
    vertex attributes.

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


def _decode_feeds(host_gb: dict):
    """Re-base the cap-independent feed positions onto the runtime mailbox
    cap: src_part * _SLOT_STRIDE + slot  ->  src_part * cap + slot."""
    P = host_gb["ob_inv"].shape[0]
    cap = host_gb["ob_inv"].shape[1] // P

    def dec(arr):
        q, r = np.divmod(arr, _SLOT_STRIDE)
        return np.where(arr == PAD, PAD, q * cap + r).astype(np.int32)

    return dec(host_gb["ib_lo"]), dec(host_gb["ib_hub"])


def device_block(host_gb: dict, device) -> dict:
    """Upload a host block to ``device`` as torch tensors, decoding the feed
    maps to runtime flat indices (see _SLOT_STRIDE). Host-only metadata
    (_HOST_ONLY) stays behind."""
    device = torch.device(device)
    ib_lo, ib_hub = _decode_feeds(host_gb)
    out = {}
    for k, v in host_gb.items():
        if k in _HOST_ONLY:
            continue
        if k == "ib_lo":
            v = ib_lo
        elif k == "ib_hub":
            v = ib_hub
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def graph_block(pg: PartitionedGraph, device) -> dict:
    """The device-side dict of per-partition tensors (leading axis P)."""
    return device_block(host_graph_block(pg), device)
