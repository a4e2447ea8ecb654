"""The fused superstep over flat (P·v_max,) state, and kernel K3.

The port of the JAX package's ``kernels/megastep.py``:

- :func:`compose_mailbox` folds the graph block's three routing hops
  (remote edge -> outbox slot via ``ob_inv``, slot -> wire, wire -> inbox
  feed via ``ib_lo``/``ib_hub``) into direct gather maps from each
  destination vertex's feed lanes to the SOURCE vertex's flat state index,
  once per run. It also holds the flat local adjacency
  (``kernels.flat.flat_adjacency``, which the staged route sweeps too),
  read by the masked sweep and by PageRank's pull.
- :func:`megastep_semiring` runs one superstep: frontier-gated mailbox
  delivery, inbox ⊕-combine, the masked local fixpoint and the new send
  set. On a CUDA tensor it is ONE launch of kernel K3
  (``csrc/megastep.cu``, :func:`megastep_semiring_cuda`: a thread-block
  cluster per partition, each sweep over a work list of the rows with an
  active in-neighbour, read through :func:`out_adjacency`); on a CPU
  tensor it is the plain :func:`megastep_semiring_ref`, whose fixpoint is
  ``kernels.flat.local_fixpoint`` over the plain masked sweep.
- :func:`megastep_semiring_batched` is the fused superstep of a query
  batch over (P·v_max, Q) state, with the composed mailbox's two-bin
  adjacency (``compose_mailbox(adjacency='binned')``): plain torch ops on
  every device, as the JAX package's is plain XLA (no kernel takes it).
- :func:`megastep_pagerank` is one PageRank superstep; its pull is
  ``kernels.flat.sweep_flat_dense``, kernel K1 on the card.
- :func:`resident_megastep` runs the resident narrow-phase mode: many
  relaxation rounds (:func:`resident_step_semiring`: one delivery and ONE
  masked sweep each) until a round changes nothing or ``max_steps``. On a
  CUDA tensor it is ONE launch of kernel K4
  (:func:`resident_megastep_cuda`: deliveries over the :func:`feed_rows`,
  sweeps over every row or a work list, as K3's); on a CPU tensor the
  plain loop
  :func:`resident_megastep_ref`. :func:`resident_enter_round` decides where
  a run switches to it.

Exactness: for idempotent ⊕ (min/max) every value is a ⊕-fold of the same
multiset of path sums, and float32 min/max are order-independent, so the
kernel, the plain version and the JAX package agree bit for bit. PageRank's
⊕ = sum folds in another association, so its parity class is allclose.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.gofs.formats import PAD
from repro_torch.kernels import _build
from repro_torch.kernels.flat import (COMBINE_IDENTITY, binned_plan_of,
                                      binned_sweep_frontier, combine_ew,
                                      combine_reduce, flat_adjacency,
                                      flat_binned_adjacency,
                                      idempotent_combine, local_fixpoint,
                                      sweep_flat_dense)
from repro_torch.kernels.ref import semiring_spmv_frontier_ref

# The resident mode's gate: the mode may take over where every remaining
# phase band's predicted round geometry is at most this many bytes. It is
# the JAX package's threshold (MEGASTEP_VMEM_BUDGET, the TPU's room for the
# mailbox in VMEM), kept so the port switches where the reference does —
# the switch sets the run's superstep count and telemetry. It is not a
# capacity of this card: K4 keeps its state in HBM and L2. Read when
# resident_enter_round is called, so a caller can lower it.
RESIDENT_ROUND_BYTES_BUDGET = 4 * 2 ** 20

# K3's choice between its two walks of a sweep: a partition whose frontier
# holds at least this share of its rows walks all of them; a smaller one
# walks the work list of its frontier's out-neighbours. Both give the same
# iterates. Read when K3 is launched, so a caller can set it: 0 walks every
# sweep densely, anything above 1 every sweep by work list.
K3_DENSE_FRONTIER = 0.125

# K4's choice between its two walks of a round's sweep: a round whose
# frontier holds at least this share of all n rows walks every row; a
# smaller one walks its frontier's rows and their out-neighbours. Both
# give the same iterates. Set from tools/k4_rounds.py's timings at the
# main path's size; read when K4 is launched, so a caller can set it: 0
# walks every sweep densely, anything above 1 every sweep by work list.
K4_DENSE_FRONTIER = 0.0625


# ---------------- composed routing maps ----------------

def compose_mailbox(gb: dict, adjacency: str = "full") -> dict:
    """Fold the staged mailbox's three routing hops into direct gather maps
    (the JAX package's ``compose_mailbox``).

    For destination vertex (p, v), feed lane m of ``ib_lo[p, v]`` names a
    received slot ``src * cap + slot``; that slot's value on the staged path
    is ``x[src][re_src[src, ob_inv[src, p*cap + slot]]]`` (⊗ the edge
    weight) when the source vertex is in the send set. Composing the maps
    once per run yields, per feed lane: the source's FLAT state index, a
    validity mask and the edge weight. Also composed: the vertex-level slot
    map ``vdst`` and per-vertex edge counts ``edge_cnt`` that give a round's
    per-pair counts and message count (:func:`round_stats`), and the local
    adjacency: ``adjacency='full'`` the flat ELL
    (``kernels.flat.flat_adjacency``) of the scalar programs, ``'binned'``
    the flat two-bin ELL (``kernels.flat.flat_binned_adjacency``) of the
    query batches.
    """
    if adjacency not in ("full", "binned"):
        raise ValueError(f"unknown adjacency {adjacency!r}")
    ob_inv = gb["ob_inv"]
    dev = ob_inv.device
    P = ob_inv.shape[0]
    cap = ob_inv.shape[1] // P
    vmask = gb["vmask"]
    v_max = vmask.shape[1]
    n = P * v_max
    re_src = gb["re_src"].long()
    re_wgt = gb["re_wgt"]
    parts = torch.arange(P, device=dev)
    p1 = parts[:, None]

    def feed_maps(feeds):
        # feeds (P, ..., m): flat received positions src*cap + slot per
        # destination-partition row; returns (src_flat, ok, w) same shape
        valid = feeds != PAD
        ms = torch.where(valid, feeds, 0).long()
        src = ms // cap
        slot = ms % cap
        pidx = parts.reshape((P,) + (1,) * (feeds.dim() - 1))
        e = ob_inv[src, pidx * cap + slot]
        ev = e != PAD
        es = torch.where(ev, e, 0).long()
        s_local = re_src[src, es]
        sv = s_local != PAD
        ok = valid & ev & sv
        src_flat = torch.where(ok, src * v_max + torch.where(sv, s_local, 0),
                               0)
        return src_flat.int(), ok, re_wgt[src, es]

    lo_src, lo_ok, lo_w = feed_maps(gb["ib_lo"])           # (P, v_max, m_lo)
    m_lo = lo_src.shape[-1]
    hub_src, hub_ok, hub_w = feed_maps(gb["ib_hub"])       # (P, hr_max, m_hi)
    hr_max, m_hi = hub_src.shape[1], hub_src.shape[2]

    # inverse of ib_hub_idx: flat vertex -> its row in the flattened hub
    # feed table (each vertex receives through EITHER ib_lo or ONE hub row,
    # never both), so the hub merge is a pure gather
    hidx = gb["ib_hub_idx"].long()                         # (P, hr_max)
    hv = hidx != PAD
    tgt = torch.where(hv, p1 * v_max + hidx, n).reshape(-1)
    hub_row = torch.full((n + 1,), PAD, dtype=torch.int32, device=dev)
    hub_row[tgt] = torch.arange(P * hr_max, dtype=torch.int32, device=dev)
    hub_row = hub_row[:n]
    hub_row_ok = hub_row != PAD
    hub_row = torch.where(hub_row_ok, hub_row, 0)

    # vdst[v, j] = 1 iff vertex v occupies an outbox slot to partition j
    # (at most one: the outbox dedupes per pair), so a round's per-pair
    # counts are one contraction over the send set
    ov = ob_inv != PAD
    o_local = re_src[p1, torch.where(ov, ob_inv, 0).long()]
    slot_ok = ov & (o_local != PAD)
    slot_src = torch.where(slot_ok, p1 * v_max + torch.where(
        o_local != PAD, o_local, 0), n)
    dst_col = parts.repeat_interleave(cap).repeat(P, 1)
    vdst = torch.zeros((n + 1, P), dtype=torch.float32, device=dev)
    vdst.index_put_((slot_src.reshape(-1), dst_col.reshape(-1)),
                    torch.ones(slot_src.numel(), device=dev), accumulate=True)
    vdst = vdst[:n]

    # edge_cnt[v] = how many remote edges vertex v sources (messages_sent)
    e_ok = re_src != PAD
    edge_cnt = torch.bincount((p1 * v_max + re_src)[e_ok],
                              minlength=n).float()

    return {
        "num_parts": P, "v_max": v_max, "cap": cap, "n": n,
        "vmask": vmask.reshape(-1).contiguous(),
        "lo_src": lo_src.reshape(n, m_lo).contiguous(),
        "lo_ok": lo_ok.reshape(n, m_lo).contiguous(),
        "lo_w": lo_w.reshape(n, m_lo).contiguous(),
        "hub_src": hub_src.reshape(P * hr_max, m_hi).contiguous(),
        "hub_ok": hub_ok.reshape(P * hr_max, m_hi).contiguous(),
        "hub_w": hub_w.reshape(P * hr_max, m_hi).contiguous(),
        "hub_row": hub_row.contiguous(), "hub_row_ok": hub_row_ok,
        "vdst": vdst.contiguous(), "edge_cnt": edge_cnt,
        **(flat_adjacency(gb) if adjacency == "full"
           else flat_binned_adjacency(gb)),
    }


# ---------------- fused mailbox delivery ----------------

def deliver_flat(vals: torch.Tensor, live, cm: dict, combine: str,
                 with_weight: bool) -> torch.Tensor:
    """The staged exchange's pack -> route -> inbox-combine pipeline as one
    gather + lane reduce over the composed maps. ``vals`` is the (n,) or
    query-trailing (n, Q) per-source message value (pre-⊗ except the edge
    weight); ``live`` (same shape) gates sends (None = unconditional,
    PageRank-style)."""
    ident = COMBINE_IDENTITY[combine]
    batched = vals.dim() == 2

    def pull(src, ok, w):
        g = vals[src]
        if batched:
            ok, w = ok[..., None], w[..., None]
        if with_weight:
            g = g + w
        if live is not None:
            ok = ok & live[src]
        return torch.where(ok, g, ident)

    lanes = -2 if batched else -1
    y = combine_reduce(combine, pull(cm["lo_src"], cm["lo_ok"], cm["lo_w"]),
                       lanes)
    yh = combine_reduce(combine, pull(cm["hub_src"], cm["hub_ok"],
                                      cm["hub_w"]), lanes)
    hro = cm["hub_row_ok"]
    hub = torch.where(hro[:, None] if batched else hro, yh[cm["hub_row"]],
                      ident)
    return combine_ew(combine, y, hub)


def round_stats(changed, cm: dict):
    """One round's wire observation from the send set: the (P, P) per-pair
    active slot counts and the message count. ``changed=None`` counts
    unconditional sends (PageRank). A query-trailing (n, Q) send set
    activates a slot when ANY lane sends (its Q-vector ships as one unit)
    but counts messages per lane. Counts stay below 2^24, exact in f32."""
    P, v_max = cm["num_parts"], cm["v_max"]
    cnt, vdst = cm["edge_cnt"], cm["vdst"]
    if changed is None:
        pairs = vdst.reshape(P, v_max, P).sum(dim=1)
        return pairs.int(), cnt.sum().int()
    if changed.dim() == 2:
        nsent = torch.dot(changed.float().sum(dim=1), cnt)
        chf = changed.any(dim=1).float()
    else:
        chf = changed.float()
        nsent = torch.dot(chf, cnt)
    pairs = torch.bmm(chf.reshape(P, 1, v_max), vdst.reshape(P, v_max, P))
    return pairs.reshape(P, P).int(), nsent.int()


# ---------------- the fused superstep ----------------

def megastep_semiring_ref(x, changed, frontier, cm: dict, semiring: str,
                          unroll: int = 1):
    """The plain fused superstep: deliver the previous round's messages,
    ⊕-combine, run the masked local fixpoint, emit the new send set.
    Returns ``(x2, changed2, f_left, liters)``; liters (P,) int32 counts the
    sweeps each partition was active for, ``unroll`` per loop trip."""
    combine = idempotent_combine(semiring)
    vm = cm["vmask"]
    inbox = deliver_flat(x, changed, cm, combine, semiring == "min_plus")
    xc = combine_ew(combine, x, inbox)
    f = frontier | ((xc != x) & vm)
    xc, f, li = local_fixpoint(xc, f, cm, vm, cm["num_parts"], semiring,
                               unroll)
    return xc, (xc != x) & vm, f, li


def sweep_flat_batched(x, f, cm: dict, semiring: str):
    """The frontier-masked two-bin multi-query sweep over the composed
    mailbox's flat binned adjacency (``compose_mailbox(adjacency=
    'binned')``): ``ops.binned_sweep`` over all P partitions at once."""
    return binned_sweep_frontier(x, f, binned_plan_of(cm), semiring)[0]


def megastep_semiring_batched(x, changed, frontier, cm: dict, semiring: str,
                              unroll: int = 2):
    """The fused superstep of a query batch on flat query-trailing (n, Q)
    state — the serving path's: deliver, ⊕-combine, the masked local
    fixpoint over the two-bin sweep (:func:`sweep_flat_batched`), the new
    send set. Plain torch ops on every device, as the JAX package computes
    it in plain XLA; lane for lane the batched program's superstep and
    exchange. Returns ``(x2, changed2, f_left, liters)``."""
    combine = idempotent_combine(semiring)
    vm = cm["vmask"][:, None]
    binned_plan_of(cm)
    inbox = deliver_flat(x, changed, cm, combine, semiring == "min_plus")
    xc = combine_ew(combine, x, inbox)
    f = frontier | ((xc != x) & vm)
    xc, f, li = local_fixpoint(xc, f, cm, vm, cm["num_parts"], semiring,
                               unroll, sweep=binned_sweep_frontier,
                               operands=("plan",))
    return xc, (xc != x) & vm, f, li


_K3_INPUTS = (  # (name, dtype) of the mailbox entries K3 and K4 read
    ("vmask", torch.bool), ("nbr", torch.int32), ("wgt", torch.float32),
    ("lo_src", torch.int32), ("lo_ok", torch.bool), ("lo_w", torch.float32),
    ("hub_src", torch.int32), ("hub_ok", torch.bool), ("hub_w", torch.float32),
    ("hub_row", torch.int32), ("hub_row_ok", torch.bool))


def _check_k3_k4_inputs(x, changed, frontier, cm: dict, kernel: str):
    """Raise unless the state and the mailbox entries are what K3 and K4
    take: on x's device, of the right dtype and shape, contiguous."""
    dev = x.device
    n = cm["n"]
    d, m_lo = cm["nbr"].shape[1], cm["lo_src"].shape[1]
    h, m_hi = cm["hub_src"].shape
    shapes = {"vmask": (n,), "nbr": (n, d), "wgt": (n, d),
              "lo_src": (n, m_lo), "lo_ok": (n, m_lo), "lo_w": (n, m_lo),
              "hub_src": (h, m_hi), "hub_ok": (h, m_hi), "hub_w": (h, m_hi),
              "hub_row": (n,), "hub_row_ok": (n,)}
    _build.need(x, "x", torch.float32, dev, (n,))
    _build.need(changed, "changed", torch.bool, dev, (n,))
    _build.need(frontier, "frontier", torch.bool, dev, (n,))
    for name, dtype in _K3_INPUTS:
        _build.need(cm[name], name, dtype, dev, shapes[name])
    if max(n * d, n * m_lo, h * m_hi) >= 2 ** 31:
        raise ValueError(f"kernel {kernel} indexes with int32: n·D must be "
                         f"< 2^31")


def out_adjacency(cm: dict):
    """The transpose of the flat local adjacency as CSR, for K3's work
    lists: ``out_src[out_off[s]:out_off[s + 1]]`` are the rows u whose
    ``nbr[u]`` lists s, in ascending order (twice if it lists s twice).
    Local edges never leave a partition, so neither do these. Built on
    first use with torch ops on the mailbox's device and kept in ``cm``;
    returns ``(out_off (n+1,) int32, out_src (nnz,) int32)``.

    Raises if a row outside ``vmask`` has a local edge: such a row may
    change without entering the frontier, and K3's sweeps take every row
    that changes into it without reading vmask (K4's sweeps write only the
    rows that are or enter a frontier)."""
    if "out_off" not in cm:
        nbr = cm["nbr"]
        n = nbr.shape[0]
        ok = nbr != PAD
        if bool((ok.any(dim=1) & ~cm["vmask"]).any()):
            raise ValueError("kernels K3 and K4 need rows outside vmask to "
                             "have no local edge")
        rows = torch.arange(n, dtype=torch.int32, device=nbr.device)
        src = nbr[ok]
        order = torch.argsort(src, stable=True)
        off = torch.zeros(n + 1, dtype=torch.int32, device=nbr.device)
        off[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
        cm["out_off"] = off
        cm["out_src"] = rows[:, None].expand_as(nbr)[ok][order].contiguous()
    return cm["out_off"], cm["out_src"]


def k3_lanes(cm: dict, semiring: str):
    """The flat adjacency as K3 reads it: ``nbr`` (and for min_plus
    ``wgt``) cut to the lanes some row uses, rounded up to a multiple of 4
    for 16-byte loads. The ELL pads its width to a multiple of 8 (a road
    network's rows use 4 of 8 lanes), and the lanes past the last used one
    are PAD in every row, so the sweeps read the same edges in fewer bytes.
    Built on first use with torch ops on the mailbox's device and kept in
    ``cm``; returns ``(nbr, wgt)``, where ``wgt`` is None for max_first,
    which reads no weights."""
    if "k3_nbr" not in cm:
        nbr = cm["nbr"]
        used = (nbr != PAD).any(dim=0).nonzero()
        width = int(used.max()) + 1 if used.numel() else 0
        cm["k3_width"] = min(nbr.shape[1], -(-width // 4) * 4)
        cm["k3_nbr"] = nbr[:, :cm["k3_width"]].contiguous()
    if semiring == "min_plus" and "k3_wgt" not in cm:
        cm["k3_wgt"] = cm["wgt"][:, :cm["k3_width"]].contiguous()
    return cm["k3_nbr"], cm.get("k3_wgt") if semiring == "min_plus" else None


def _walk_inputs(cm: dict, semiring: str):
    """What K3's and K4's walks read beside the mailbox, built into it on
    first use and checked: ``(out_off, out_src, nbr, wgt)``, the
    :func:`out_adjacency` and the :func:`k3_lanes` (``wgt`` is ``nbr`` as
    a placeholder for max_first, which reads no weights)."""
    out_off, out_src = out_adjacency(cm)
    nbr, wgt = k3_lanes(cm, semiring)
    dev = nbr.device
    _build.need(out_off, "out_off", torch.int32, dev, (cm["n"] + 1,))
    _build.need(out_src, "out_src", torch.int32, dev, (out_src.numel(),))
    return out_off, out_src, nbr, nbr if wgt is None else wgt


def k3_dense_rows(v_max: int) -> int:
    """The frontier size from which a K3 sweep walks all of a partition's
    ``v_max`` rows (:data:`K3_DENSE_FRONTIER` of them)."""
    if K3_DENSE_FRONTIER > 1:
        return v_max + 1
    return max(0, math.ceil(K3_DENSE_FRONTIER * v_max))


def k3_cluster_shape(num_parts: int, semiring: str, device) -> dict:
    """K3's launch shape for ``num_parts`` partitions on a card: blocks a
    cluster, clusters (each takes partitions c, c + C, ...), threads a
    block, and ``cudaOccupancyMaxActiveClusters`` at each cluster size."""
    idempotent_combine(semiring)
    out = (ctypes.c_int * 8)()
    dev = torch.device(device)
    _build.check(_build.library().megastep_cluster_shape(
        num_parts, int(semiring == "min_plus"), dev.index or 0, out),
        "K3 megastep_semiring cluster shape")
    return {"blocks_per_cluster": out[0], "clusters": out[1],
            "threads": out[2],
            "max_active_clusters": dict(zip((1, 2, 4, 8, 16), out[3:8]))}


def megastep_semiring_cuda(x, changed, frontier, cm: dict, semiring: str,
                           unroll: int = 1):
    """The fused superstep as ONE launch of kernel K3 — a thread-block
    cluster per partition, no grid-wide barrier — with the same contract
    and bits as :func:`megastep_semiring_ref`. Builds the mailbox's
    :func:`out_adjacency` and :func:`k3_lanes` on first use."""
    idempotent_combine(semiring)
    if unroll < 1:
        raise ValueError("unroll must be >= 1")
    if not x.is_cuda:
        raise ValueError(f"kernel K3 needs CUDA tensors, got {x.device}")
    dev = x.device
    n, P, v_max = cm["n"], cm["num_parts"], cm["v_max"]
    m_lo, m_hi = cm["lo_src"].shape[1], cm["hub_src"].shape[1]
    _check_k3_k4_inputs(x, changed, frontier, cm, "K3")
    out_off, out_src, nbr, wgt = _walk_inputs(cm, semiring)
    d = nbr.shape[1]
    x_out = torch.empty_like(x)
    ch_out = torch.empty(n, dtype=torch.bool, device=dev)
    fr_out = torch.empty(n, dtype=torch.bool, device=dev)
    liters = torch.empty(P, dtype=torch.int32, device=dev)
    fgen = torch.empty((2, n), dtype=torch.int32, device=dev)
    stamp = torch.empty(n, dtype=torch.int32, device=dev)
    x_alt = torch.empty_like(x)
    lists = torch.empty((2, n), dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.megastep_semiring_launch(
        x.data_ptr(), changed.data_ptr(), frontier.data_ptr(),
        cm["vmask"].data_ptr(), nbr.data_ptr(), wgt.data_ptr(),
        *(cm[name].data_ptr() for name, _ in _K3_INPUTS[3:]),
        out_off.data_ptr(), out_src.data_ptr(),
        x_out.data_ptr(), ch_out.data_ptr(), fr_out.data_ptr(),
        liters.data_ptr(), fgen.data_ptr(), stamp.data_ptr(),
        x_alt.data_ptr(), lists.data_ptr(), n, d, m_lo, m_hi, P, v_max, unroll,
        k3_dense_rows(v_max), int(semiring == "min_plus"), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K3 megastep_semiring")
    _build.launches["megastep_semiring"] += 1
    return x_out, ch_out, fr_out, liters


def megastep_semiring(x, changed, frontier, cm: dict, semiring: str,
                      unroll: int = 1):
    """One fused superstep: kernel K3 for a CUDA tensor, the plain version
    for a CPU tensor; any other device raises."""
    if x.is_cuda:
        return megastep_semiring_cuda(x, changed, frontier, cm, semiring,
                                      unroll)
    if x.device.type == "cpu":
        return megastep_semiring_ref(x, changed, frontier, cm, semiring,
                                     unroll)
    raise ValueError(f"megastep_semiring has no path for device {x.device}")


def megastep_pagerank(r, cm: dict, deg, tele, n_global: int, damping: float,
                      num_iters: int, step: int):
    """One fused PageRank superstep on flat state: contributions, pull
    sweep, unconditional mailbox delivery, dangling redistribution, rank
    update. The dangling-mass and delta reductions keep the staged path's
    per-partition-then-global association (sum over v_max, then over P).
    Returns ``(r_new, delta, changed)``; ``changed`` is a host bool, since
    the schedule is a fixed iteration count."""
    vm = cm["vmask"]
    P = cm["num_parts"]
    contrib = torch.where(deg > 0, r / torch.clamp(deg, min=1.0), 0.0)
    pull = sweep_flat_dense(contrib, cm)
    inbox = deliver_flat(contrib, None, cm, "sum", False)
    dangling = torch.where(vm & (deg == 0), r, 0.0).reshape(P, -1) \
        .sum(dim=1).sum()
    r_new = torch.where(
        vm,
        (1.0 - damping) * tele + damping * (pull + inbox + dangling * tele),
        0.0)
    delta = (r_new - r).abs().reshape(P, -1).sum(dim=1).sum()
    return r_new, delta, step + 1 < num_iters


# ---------------- the resident narrow-phase mode ----------------

def resident_step_semiring(x, changed, frontier, cm: dict, semiring: str):
    """One relaxation round of the resident narrow-phase loop: deliver
    pending news, then a SINGLE masked sweep (local consequences settle
    across rounds instead of per-superstep fixpoints — chaotic relaxation).
    Every improvement is rebroadcast the following round, so the loop
    converges to the same unique ⊕-fixpoint as the BSP schedule, bitwise
    for idempotent ⊕. ``changed2``/``frontier2`` keep the BSP state
    contract (pending sends, locally unsettled rows), so a later superstep
    can take over. Returns ``(x2, changed2, frontier2, active_p)``;
    ``active_p`` (P,) bool marks the partitions with a frontier."""
    combine = idempotent_combine(semiring)
    vm = cm["vmask"]
    inbox = deliver_flat(x, changed, cm, combine, semiring == "min_plus")
    x1 = combine_ew(combine, x, inbox)
    f = frontier | ((x1 != x) & vm)
    y, _ = semiring_spmv_frontier_ref(x1, f, cm["nbr"], cm["wgt"], semiring)
    x2 = combine_ew(combine, x1, y)
    active_p = f.reshape(cm["num_parts"], -1).any(dim=1)
    return x2, (x2 != x) & vm, (x2 != x1) & vm, active_p


def resident_enter_round(phase_round_bytes, boundaries, budget=None):
    """Earliest superstep from which the resident narrow-phase mode may
    take over: the start of the first phase band such that EVERY remaining
    band's predicted per-round wire geometry fits ``budget`` (default
    :data:`RESIDENT_ROUND_BYTES_BUDGET`). The frontier only contracts
    across bands by construction, but a non-monotone profile keeps the
    conservative suffix rule honest. Returns None when no suffix fits."""
    if budget is None:
        budget = RESIDENT_ROUND_BYTES_BUDGET
    k0 = None
    for k in range(len(phase_round_bytes) - 1, -1, -1):
        if phase_round_bytes[k] <= budget:
            k0 = k
        else:
            break
    if k0 is None:
        return None
    return 0 if k0 == 0 else int(boundaries[k0 - 1])


def resident_megastep_ref(x, changed, frontier, cm: dict, semiring: str,
                          max_steps: int):
    """The plain resident loop: :func:`resident_step_semiring` rounds while
    any vertex changed in the last round and fewer than ``max_steps`` rounds
    ran. Returns ``(x2, changed2, frontier2, iters, liters)``: ``iters`` a
    0-d int32 tensor, ``liters`` (P,) int32, where each round adds 1 to
    every partition whose frontier was non-empty."""
    li = torch.zeros(cm["num_parts"], dtype=torch.int32, device=x.device)
    it = 0
    while it < max_steps and bool(changed.any()):
        x, changed, frontier, ap = resident_step_semiring(x, changed,
                                                          frontier, cm,
                                                          semiring)
        li += ap.int()
        it += 1
    return (x, changed, frontier,
            torch.tensor(it, dtype=torch.int32, device=x.device), li)


def feed_rows(cm: dict) -> torch.Tensor:
    """The rows K4's deliveries walk: those with a valid lo feed lane or a
    hub feed row, ascending, (nf,) int32. Every other row receives nothing,
    so its x1 is its x. Built on first use on the mailbox's device and kept
    in ``cm``."""
    if "feed_rows" not in cm:
        feed = cm["lo_ok"].any(dim=1) | cm["hub_row_ok"]
        cm["feed_rows"] = feed.nonzero().reshape(-1).int().contiguous()
    return cm["feed_rows"]


def k4_dense_rows(n: int) -> int:
    """The frontier size from which a K4 sweep walks all ``n`` rows
    (:data:`K4_DENSE_FRONTIER` of them)."""
    if K4_DENSE_FRONTIER > 1:
        return n + 1
    return max(0, math.ceil(K4_DENSE_FRONTIER * n))


def resident_megastep_cuda(x, changed, frontier, cm: dict, semiring: str,
                           max_steps: int, phase_ns=None):
    """The resident loop as ONE cooperative launch of kernel K4 — two
    grid-wide barriers a round, deliveries over :func:`feed_rows`, sweeps
    over every row or a work list through :func:`out_adjacency` by the
    frontier's size, on the lanes of :func:`k3_lanes` — with the same
    contract and bits as :func:`resident_megastep_ref`. Builds those three
    into the mailbox on first use. ``phase_ns``, a (3,) int64 CUDA tensor
    or None, receives the kernel's own timing of its set-up, deliveries
    and sweeps in nanoseconds (each with the wait at its barrier)."""
    idempotent_combine(semiring)
    if not 0 <= max_steps < 2 ** 31:
        raise ValueError(f"max_steps must be in [0, 2^31), got {max_steps}")
    if not x.is_cuda:
        raise ValueError(f"kernel K4 needs CUDA tensors, got {x.device}")
    dev = x.device
    n, P, v_max = cm["n"], cm["num_parts"], cm["v_max"]
    m_lo, m_hi = cm["lo_src"].shape[1], cm["hub_src"].shape[1]
    _check_k3_k4_inputs(x, changed, frontier, cm, "K4")
    out_off, out_src, nbr, wgt = _walk_inputs(cm, semiring)
    feed = feed_rows(cm)
    _build.need(feed, "feed_rows", torch.int32, dev, (feed.numel(),))
    if phase_ns is not None:
        _build.need(phase_ns, "phase_ns", torch.int64, dev, (3,))
    dense_rows = k4_dense_rows(n)
    cap = max(1, min(dense_rows, n))   # a walked list holds < dense_rows
    x_out = torch.empty_like(x)
    ch_out = torch.empty(n, dtype=torch.bool, device=dev)
    fr_out = torch.empty(n, dtype=torch.bool, device=dev)
    iters = torch.empty((), dtype=torch.int32, device=dev)
    liters = torch.empty(P, dtype=torch.int32, device=dev)
    ys = torch.empty((2, n, 2), dtype=torch.int32, device=dev)
    snd = torch.empty((2, n, 2), dtype=torch.int32, device=dev)
    claim = torch.empty(n, dtype=torch.int32, device=dev)
    lists = torch.empty((2, cap), dtype=torch.int32, device=dev)
    ctr = torch.zeros(3 * (P + 2), dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.resident_megastep_launch(
        x.data_ptr(), changed.data_ptr(), frontier.data_ptr(),
        cm["vmask"].data_ptr(), nbr.data_ptr(), wgt.data_ptr(),
        *(cm[name].data_ptr() for name, _ in _K3_INPUTS[3:]),
        feed.data_ptr(), out_off.data_ptr(), out_src.data_ptr(),
        x_out.data_ptr(), ch_out.data_ptr(), fr_out.data_ptr(),
        iters.data_ptr(), liters.data_ptr(), ys.data_ptr(), snd.data_ptr(),
        claim.data_ptr(), lists.data_ptr(), ctr.data_ptr(),
        None if phase_ns is None else phase_ns.data_ptr(), n, nbr.shape[1],
        m_lo, m_hi, P, v_max, feed.numel(), max_steps, dense_rows, cap,
        int(semiring == "min_plus"), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K4 resident_megastep")
    _build.launches["resident_megastep"] += 1
    return x_out, ch_out, fr_out, iters, liters


def resident_megastep(x, changed, frontier, cm: dict, semiring: str,
                      max_steps: int):
    """The resident narrow-phase loop: kernel K4 for a CUDA tensor, the
    plain version for a CPU tensor; any other device raises."""
    if x.is_cuda:
        return resident_megastep_cuda(x, changed, frontier, cm, semiring,
                                      max_steps)
    if x.device.type == "cpu":
        return resident_megastep_ref(x, changed, frontier, cm, semiring,
                                     max_steps)
    raise ValueError(f"resident_megastep has no path for device {x.device}")
