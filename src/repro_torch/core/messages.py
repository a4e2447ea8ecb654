"""Mailbox message routing — the superstep-boundary exchange.

The port of the JAX package's ``core/messages.py``. A mailbox is a
fixed-capacity (P_src, P_dst, cap) tensor; on one device (the ``local``
backend) the route between partitions is a transpose, and each partition's
inbox is a ⊕-combine of the slots it receives. Capacity is the most
messages between any partition pair, fixed by GoFS at build time, and
empty slots carry the combine identity.

Every function works on a whole batch of partitions at once: all P on
``local``, a rank's v = P / D rows on ``shard_map`` (the JAX package
``vmap``s its per-partition forms, the port writes the leading partition
axis out).

- :func:`build_outbox_gather` / :func:`combine_inbox_gather` are the hot
  path: both ends are gathers through the inverse maps of the graph block.
  Their scatter forms :func:`build_outbox` / :func:`combine_inbox` stay as
  the oracles the gather forms are tested against.
- :func:`build_outbox_compact` / :func:`unpack_slots` are the compact
  exchange: each pair row is packed to the prefix of its active slots
  (``kernels.ops.outbox_pack``, kernel K5 on the card) and rebuilt at the
  receiver by a gather, bit-identical to the dense exchange.
- :func:`route_local` (a transpose) and :func:`route_shard_map` (one
  ``all_to_all_single`` over the mesh's process group) deliver the dense
  and compact exchanges' rows.
- :func:`route_tiered` is the tiered exchange's route along a
  ``core.tiers.TierSchedule``: hot pairs ship the dense row, warm and cold
  pairs their packed tier-width prefix, excluded pairs nothing; over D > 1
  ranks by ``all_to_all_single`` and ``batch_isend_irecv`` shifts.
- the ``*_batched`` forms carry a query batch: values QUERY-TRAILING,
  (P, r_max, Q) at the sender and (P, P, cap·Q) on the wire, so every slot
  moves one contiguous Q-vector; the pack's plan and the active slots are
  those of the any-over-Q send set.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import wire
from repro_torch.gofs.formats import PAD
from repro_torch.kernels import ops
from repro_torch.kernels.flat import COMBINE_IDENTITY, combine_reduce

_SCATTER = {"min": "amin", "max": "amax", "sum": "sum"}


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-partition gather: ``out[p, ...] = src[p, idx[p, ...]]`` for a
    (P, m) ``src`` and a (P, ...) index tensor with no PAD left in it."""
    P = src.shape[0]
    return torch.gather(src, 1, idx.reshape(P, -1).long()).reshape(idx.shape)


# ---------------- scatter oracles ----------------

def build_outbox(vals, re_src, re_dst_part, re_dst_local, re_slot, send_mask,
                 num_parts: int, cap: int, combine: str):
    """Scatter each partition's per-remote-edge values into its
    (P_dst, cap) outbox. ``vals``/``send_mask`` and the ``re_*`` maps are
    (P, r_max). Returns (out_vals, out_idx), each (P, P_dst, cap): the
    value and the destination-local vertex of every slot (PAD if empty)."""
    ident = COMBINE_IDENTITY[combine]
    P = vals.shape[0]
    valid = (re_src != PAD) & send_mask
    flat = torch.where(valid, re_dst_part.long() * cap + re_slot.long(),
                       num_parts * cap)                 # OOB -> dropped
    out_vals = torch.full((P, num_parts * cap + 1), ident, dtype=vals.dtype,
                          device=vals.device)
    out_idx = torch.full((P, num_parts * cap + 1), PAD, dtype=torch.int32,
                         device=vals.device)
    out_vals.scatter_(1, flat, torch.where(valid, vals, ident))
    out_idx.scatter_(1, flat, torch.where(valid, re_dst_local, PAD).int())
    return (out_vals[:, :-1].reshape(P, num_parts, cap),
            out_idx[:, :-1].reshape(P, num_parts, cap))


def combine_inbox(in_vals, in_idx, v_max: int, combine: str):
    """Segment-⊕ the received (P, num_src, cap) slots into a dense
    (P, v_max) inbox; PAD slots are dropped."""
    P = in_vals.shape[0]
    idx = in_idx.reshape(P, -1)
    idx = torch.where(idx == PAD, v_max, idx).long()
    out = torch.full((P, v_max + 1), COMBINE_IDENTITY[combine],
                     dtype=in_vals.dtype, device=in_vals.device)
    out.scatter_reduce_(1, idx, in_vals.reshape(P, -1), _SCATTER[combine],
                        include_self=True)
    return out[:, :v_max]


# ---------------- gather-form mailbox (the hot path) ----------------

def build_outbox_gather(vals, send_mask, ob_inv, num_parts: int, cap: int,
                        combine: str):
    """Gather-form outbox: each of a partition's P·cap slots pulls its
    remote edge's value, or the identity when the slot is empty or its
    source is not in the send set. ``vals``/``send_mask`` (P, r_max),
    ``ob_inv`` (P, P·cap). Returns (P, P_dst, cap)."""
    ident = COMBINE_IDENTITY[combine]
    P = vals.shape[0]
    masked = torch.where(send_mask, vals, ident)
    valid = ob_inv != PAD
    got = _take(masked, torch.where(valid, ob_inv, 0))
    return torch.where(valid, got, ident).reshape(P, num_parts, cap)


def combine_inbox_gather(in_vals, ib_lo, ib_hub_idx, ib_hub, v_max: int,
                         combine: str):
    """Gather-form inbox combine: received (P, num_src, cap) slots ->
    (P, v_max). Each vertex pulls its feed list (``ib_lo``) and reduces it;
    the few hub receivers (``ib_hub_idx``, feeds ``ib_hub``) merge back by a
    ``scatter_reduce_`` onto a (P, v_max + 1) buffer whose last column
    takes the PAD entries."""
    ident = COMBINE_IDENTITY[combine]
    P = in_vals.shape[0]
    flat = in_vals.reshape(P, -1)

    def pull(m):
        valid = m != PAD
        return torch.where(valid, _take(flat, torch.where(valid, m, 0)),
                           ident)

    y = combine_reduce(combine, pull(ib_lo), -1)        # (P, v_max)
    yh = combine_reduce(combine, pull(ib_hub), -1)      # (P, hr_max)
    idx = torch.where(ib_hub_idx != PAD, ib_hub_idx, v_max).long()
    out = torch.cat([y, y.new_full((P, 1), ident)], dim=1)
    out.scatter_reduce_(1, idx, yh, _SCATTER[combine], include_self=True)
    return out[:, :v_max]


def build_outbox_gather_batched(vals, send_mask, ob_inv, num_parts: int,
                                cap: int, combine: str):
    """The query-batched gather-form outbox, QUERY-TRAILING: ``vals`` and
    ``send_mask`` are (P, r_max, Q), and each slot pulls its edge's
    contiguous Q-vector in one gather. Returns (P, P_dst, cap·Q), slot-major
    (slot·Q + q) along each pair row."""
    ident = COMBINE_IDENTITY[combine]
    P, _, Q = vals.shape
    masked = torch.where(send_mask, vals, ident)
    valid = ob_inv != PAD
    idx = torch.where(valid, ob_inv, 0).long()
    got = torch.gather(masked, 1, idx[..., None].expand(-1, -1, Q))
    return torch.where(valid[..., None], got, ident).reshape(
        P, num_parts, cap * Q)


def combine_inbox_gather_batched(in_vals, ib_lo, ib_hub_idx, ib_hub,
                                 v_max: int, cap: int, combine: str):
    """The query-batched gather-form combine, QUERY-TRAILING: received
    (P, num_src, cap·Q) slots -> (P, v_max, Q). Each vertex's feed slots
    pull contiguous Q-vectors and reduce over the feed axis; the hub
    receivers merge back by a ``scatter_reduce_``, as in
    :func:`combine_inbox_gather`."""
    ident = COMBINE_IDENTITY[combine]
    P, num_src = in_vals.shape[:2]
    Q = in_vals.shape[2] // cap
    flat = in_vals.reshape(P, num_src * cap, Q)

    def pull(m):
        valid = m != PAD
        idx = torch.where(valid, m, 0).long().reshape(P, -1, 1)
        got = torch.gather(flat, 1, idx.expand(-1, -1, Q))
        return torch.where(valid[..., None], got.reshape(*m.shape, Q), ident)

    y = combine_reduce(combine, pull(ib_lo), -2)        # (P, v_max, Q)
    yh = combine_reduce(combine, pull(ib_hub), -2)      # (P, hr_max, Q)
    idx = torch.where(ib_hub_idx != PAD, ib_hub_idx, v_max).long()
    out = torch.cat([y, y.new_full((P, 1, Q), ident)], dim=1)
    out.scatter_reduce_(1, idx[..., None].expand(-1, -1, Q), yh,
                        _SCATTER[combine], include_self=True)
    return out[:, :v_max]


# ---------------- the compact exchange ----------------

def active_slots(send_mask, ob_inv, num_parts: int, cap: int):
    """(P, P_dst, cap) bool: the outbox slots whose source vertex is in the
    send set this superstep. A query-batched (P, r_max, Q) send mask
    activates a slot when ANY lane sends: its contiguous Q-vector ships (or
    does not) as one unit."""
    if send_mask.dim() == 3:
        send_mask = send_mask.any(dim=-1)
    P = send_mask.shape[0]
    valid = ob_inv != PAD
    act = _take(send_mask, torch.where(valid, ob_inv, 0))
    return (valid & act).reshape(P, num_parts, cap)


def build_outbox_compact(vals, send_mask, ob_inv, num_parts: int, cap: int,
                         combine: str):
    """Frontier-compacted outbox. Returns (pvals (P, P_dst, cap), pinv
    (P, P_dst, cap) int32, counts (P, P_dst) int32): per pair row the
    packed prefix of active slot values, the slot -> prefix position map,
    and the prefix length (the wire header). The pack is
    ``kernels.ops.outbox_pack`` over the P·P rows at once."""
    ident = COMBINE_IDENTITY[combine]
    P = vals.shape[0]
    slot_vals = build_outbox_gather(vals, send_mask, ob_inv, num_parts, cap,
                                    combine)
    active = active_slots(send_mask, ob_inv, num_parts, cap)
    R = P * num_parts
    full = torch.full((R,), cap, dtype=torch.int32, device=vals.device)
    pvals, _, pinv, counts, _ = ops.outbox_pack(
        slot_vals.reshape(R, cap), active.reshape(R, cap), full, ident)
    return (pvals.reshape(P, num_parts, cap), pinv.reshape(P, num_parts, cap),
            counts.reshape(P, num_parts))


def build_outbox_compact_batched(vals, send_mask, ob_inv, num_parts: int,
                                 cap: int, combine: str):
    """The query-batched compacted outbox: ``vals``/``send_mask`` (P, r_max,
    Q); the pack is ``kernels.ops.outbox_pack`` over (P·P, cap, Q) slot
    values (kernel K5's plan on the card, then one masked scatter of the
    Q-vectors). Returns (pvals (P, P_dst, cap·Q), pinv (P, P_dst, cap),
    counts (P, P_dst))."""
    ident = COMBINE_IDENTITY[combine]
    P, _, Q = vals.shape
    slot_vals = build_outbox_gather_batched(vals, send_mask, ob_inv,
                                            num_parts, cap, combine)
    active = active_slots(send_mask, ob_inv, num_parts, cap)
    R = P * num_parts
    full = torch.full((R,), cap, dtype=torch.int32, device=vals.device)
    pvals, _, pinv, counts, _ = ops.outbox_pack(
        slot_vals.reshape(R, cap, Q), active.reshape(R, cap), full, ident)
    return (pvals.reshape(P, num_parts, cap * Q),
            pinv.reshape(P, num_parts, cap), counts.reshape(P, num_parts))


def unpack_slots(pvals, pinv, combine: str):
    """Receiver side: packed (P, num_src, cap) prefixes and their slot ->
    position maps -> the dense slot values the inbox combine expects. A
    gather; bit-identical to what the dense exchange delivers."""
    ident = COMBINE_IDENTITY[combine]
    valid = pinv != PAD
    got = torch.gather(pvals, 2, torch.where(valid, pinv, 0).long())
    return torch.where(valid, got, ident)


def unpack_slots_batched(pvals, pinv, combine: str):
    """The query-batched receiver: packed (P, num_src, cap·Q) prefixes and
    their (P, num_src, cap) maps -> the dense (P, num_src, cap·Q) slots,
    each slot pulling its contiguous Q-vector."""
    ident = COMBINE_IDENTITY[combine]
    P, num_src, cap = pinv.shape
    Q = pvals.shape[2] // cap
    valid = (pinv != PAD)[..., None]
    idx = torch.where(pinv != PAD, pinv, 0).long()[..., None]
    got = torch.gather(pvals.reshape(P, num_src, cap, Q), 2,
                       idx.expand(-1, -1, -1, Q))
    return torch.where(valid, got, ident).reshape(P, num_src, cap * Q)


def route_local(outbox_vals):
    """Local backend: outbox (P_src, P_dst, cap) -> received (P_dst, P_src,
    cap). With every partition on one device the transpose IS the
    all_to_all."""
    return outbox_vals.transpose(0, 1)


def route_shard_map(outbox_vals, group):
    """The ``shard_map`` backend's route: each rank holds ``v = P / D``
    source partitions, (v, D·v, cap[, ...]) outbox rows. Rearranged to
    (D, v_src, v_dst, ...) so that ONE ``all_to_all_single`` over the
    mesh's ``group`` delivers every rank pair's block, then reassembled as
    the receiver's (v_dst, P_src, cap[, ...]) slots. A query batch's
    trailing Q rides along; int32 slot maps route the same way. Runs its
    collective at D = 1 too, as the JAX package's does."""
    v, P = outbox_vals.shape[:2]
    tail = outbox_vals.shape[2:]
    D = P // v
    x = outbox_vals.reshape(v, D, v, -1).transpose(0, 1).contiguous()
    out = torch.empty_like(x)
    wire.all_to_all_single(out, x, group=group)
    # out[d_src, v_src, v_dst] on this (destination) rank
    return out.permute(2, 0, 1, 3).reshape(v, P, *tail)


# ---------------- the tiered exchange ----------------

def tiered_tables(sched, device, me: int = 0) -> dict:
    """The index tensors :func:`route_tiered` moves rows by on rank ``me``
    of a ``core.tiers.TierSchedule`` over ``sched.D`` devices: for the hot
    tier's uniform block and for every shift ``k`` (the residual hot rows,
    then the warm and the cold tiers), the rows this rank SENDS (its local
    outbox rows, PAD entries read row 0) and the rows it RECEIVES into (its
    local inbox pairs, PAD entries pointing at the sink row ``v·P`` past
    the end). A shift's buffer row r on the sender is row r on the
    receiver, so the padding travels and lands in the sink, as the JAX
    package's ``mode="drop"`` writes do. At D = 1 no table has PAD
    entries. Built once per run, so no superstep copies a table to the
    device."""
    sink = sched.v * sched.P

    def rows(send, recv):
        send = np.asarray(send).reshape(-1).astype(np.int64)
        recv = np.asarray(recv).reshape(-1).astype(np.int64)
        return (torch.from_numpy(np.where(send == PAD, 0, send)).to(device),
                torch.from_numpy(np.where(recv == PAD, sink, recv)).to(device))

    hot = (rows(sched.hot_send[me], sched.hot_recv[me])
           if sched.hot_h else None)
    return {"hot": hot,
            "hot_res": [(k, rows(st[me], rt[me]))
                        for k, _, st, rt in sched.hot_res_shifts],
            "packed": [(sched.warm_cap, k, rows(st[me], rt[me]))
                       for k, _, st, rt in sched.warm_shifts]
                      + [(1, k, rows(st[me], rt[me]))
                         for k, _, st, rt in sched.cold_shifts]}


def _shift(bufs, k: int, D: int, me: int, group):
    """One ``batch_isend_irecv`` over the mesh: send ``bufs`` to rank
    (me + k) % D and receive the same shapes from (me − k) % D."""
    import torch.distributed as dist
    recv = [torch.empty_like(b) for b in bufs]
    to = dist.get_global_rank(group, (me + k) % D)
    frm = dist.get_global_rank(group, (me - k) % D)
    ops_ = ([dist.P2POp(dist.isend, b.contiguous(), to, group) for b in bufs]
            + [dist.P2POp(dist.irecv, r, frm, group) for r in recv])
    wire.batch_isend_irecv(ops_, group=group)
    return recv


def route_tiered(dense_vals, pvals, sids, sched, combine: str, group=None,
                 tables=None):
    """Route one superstep's outboxes along the tier schedule.

    dense_vals (v, P, cap[, Q])  gather-form dense slot values (hot rows
                                 ship these as they are — no slot ids
                                 travel)
    pvals      (v, P, cap[, Q])  packed prefixes (warm/cold rows ship their
                                 first tier-width columns)
    sids       (v, P, cap)       packed position -> slot id maps
    sched                        a ``core.tiers.TierSchedule`` over D
                                 devices
    group                        the mesh's process group (D > 1); this
                                 process is its rank ``me``
    tables                       :func:`tiered_tables` for this rank
                                 (built here if None)

    The hot tier's uniform block is ONE ``all_to_all_single`` of (D, h,
    cap[, Q]) row blocks; the residual hot rows and every warm and cold
    shift k are one ``batch_isend_irecv`` each (to (me + k) % D, from
    (me − k) % D; skipped, local, when k % D == 0); warm and cold values
    travel with their int32 slot ids. At D = 1 no collective runs. A query
    batch carries the trailing Q axis, and every slot moves its Q-vector.

    Returns the received dense slot array, shaped as ``dense_vals``: every
    occupied slot of a routed pair holds its exact value, everything else
    the ⊕-identity, so when no pair overflowed its tier width it is
    bit-identical to :func:`route_local`'s (or :func:`route_shard_map`'s)
    delivery. A write the JAX package drops (``mode="drop"``) goes to one
    extra sink row past the end, which is cut off; each real slot is
    written at most once."""
    import torch.distributed as dist
    D = sched.D
    if D > 1 and group is None:
        raise ValueError("a tier schedule over several devices routes over "
                         "a mesh: pass its process group")
    me = dist.get_rank(group) if D > 1 else 0
    if tables is None:
        tables = tiered_tables(sched, dense_vals.device, me)
    ident = COMBINE_IDENTITY[combine]
    v, P, cap = dense_vals.shape[:3]
    tail = dense_vals.shape[3:]
    rows = v * P
    dflat = dense_vals.reshape(rows, cap, *tail)
    out = torch.full((rows + 1, cap, *tail), ident, dtype=dense_vals.dtype,
                     device=dense_vals.device)
    if tables["hot"] is not None:
        src, dst = tables["hot"]
        buf = dflat[src]                                # (D·h, cap, ...)
        if D > 1:
            got = torch.empty_like(buf)
            wire.all_to_all_single(got, buf, group=group)
            buf = got
        out[dst] = buf
    for k, (src, dst) in tables["hot_res"]:
        buf = dflat[src]
        if k % D:
            (buf,) = _shift([buf], k, D, me, group)
        out[dst] = buf
    flat = out.reshape(-1, *tail)
    pflat = pvals.reshape(rows, cap, *tail)
    iflat = sids.reshape(rows, cap)
    for width, k, (src, dst) in tables["packed"]:
        bv = pflat[src][:, :width]
        bi = iflat[src][:, :width]
        if k % D:
            bv, bi = _shift([bv, bi], k, D, me, group)
        # a PAD receive row is the sink row, so its slots land past the end
        pos = torch.where(bi != PAD, dst[:, None] * cap + bi.long(),
                          rows * cap)
        flat[pos.reshape(-1)] = bv.reshape(-1, *tail)
    return out[:rows].reshape(v, P, cap, *tail)
