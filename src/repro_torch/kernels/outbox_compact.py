"""Kernels K5 and K6 — the compact exchange's pack and plan on the card.

``outbox_pack_cuda`` launches K5 in ``csrc/outbox_compact.cu`` (the port of
the JAX package's Pallas ``outbox_pack_pallas``): per mailbox row the
compaction plan, truncation at the row's slot budget, the value pack and
the overflow flag. ``outbox_compact_plan_cuda`` launches K6 (the port of
``outbox_compact_plan_pallas``): the plan alone. Each row gets a block,
which loads a tile of slots in one round and scans its ballot counts after
one barrier (:func:`k5_layout` reports the build's layout). The int32
outputs share one allocation. Query-batched (R, cap, Q) values take K5's
plan and one masked scatter of their Q-vectors. Their plain versions are
``kernels.ref.outbox_pack_ref`` and ``outbox_compact_plan_ref``;
``kernels.ops`` picks between kernel and plain version by the tensors'
device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.gofs.formats import PAD
from repro_torch.kernels import _build
from repro_torch.kernels.ref import scatter_prefix


def _check_rows(active: torch.Tensor, what: str):
    if not active.is_cuda:
        raise ValueError(f"kernel {what} needs CUDA tensors, got "
                         f"{active.device}")
    if active.dim() != 2:
        raise ValueError(f"active must be (R, cap), got {tuple(active.shape)}")
    rows, cap = active.shape
    _build.need(active, "active", torch.bool, active.device, (rows, cap))
    if rows * cap >= 2 ** 31:
        raise ValueError(f"kernel {what} indexes rows with int32: R·cap must "
                         f"be < 2^31")
    return active.device, rows, cap


def _int_outputs(dev, rows: int, cap: int, per_row: int):
    """Two (rows, cap) and then ``per_row`` (1 or 2) (rows,) int32 tensors,
    views of one allocation, each starting on 16 bytes: the (rows,) ones
    first, then the (rows, cap) ones. A caller that keeps any of them keeps
    the whole allocation alive."""
    def up(k):
        return -(-k // 4) * 4               # int32s to the next 16 bytes
    head, n = per_row * up(rows), up(rows * cap)
    buf = torch.empty(head + 2 * n, dtype=torch.int32, device=dev)
    return (buf.as_strided((rows, cap), (cap, 1), head),
            buf.as_strided((rows, cap), (cap, 1), head + n),
            *(buf.as_strided((rows,), (1,), k * up(rows))
              for k in range(per_row)))


def outbox_pack_cuda(slot_vals: torch.Tensor, active: torch.Tensor,
                     limit: torch.Tensor, ident: float):
    """(R, cap) float32 slot values, (R, cap) bool active mask and (R,)
    int32 budget -> (pvals, sids, pinv, counts, over) by kernel K5,
    bit-identical to ``outbox_pack_ref``.

    Query-batched (R, cap, Q) values take the JAX package's route: the plan
    (with each row's truncation and overflow) does not depend on the
    values, so K5 computes it over zero values, and the Q-vectors go to
    their packed positions through ``pinv`` by one masked scatter
    (``kernels.ref.scatter_prefix``)."""
    dev, rows, cap = _check_rows(active, "K5")
    batched = slot_vals.dim() == 3
    if batched:
        _build.need(slot_vals, "slot_vals", torch.float32, dev,
                    (rows, cap, slot_vals.shape[2]))
        vals = torch.zeros((rows, cap), dtype=torch.float32, device=dev)
    else:
        _build.need(slot_vals, "slot_vals", torch.float32, dev, (rows, cap))
        vals = slot_vals
    _build.need(limit, "limit", torch.int32, dev, (rows,))
    pvals = torch.empty((rows, cap), dtype=torch.float32, device=dev)
    sids, pinv, counts, over = _int_outputs(dev, rows, cap, 2)
    err = _build.library().outbox_pack_launch(
        active.data_ptr(), vals.data_ptr(), limit.data_ptr(),
        pvals.data_ptr(), sids.data_ptr(), pinv.data_ptr(), counts.data_ptr(),
        over.data_ptr(), rows, cap, float(ident), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "outbox_pack")
    _build.launches["outbox_pack"] += 1
    if batched:
        pvals = scatter_prefix(slot_vals, torch.where(pinv != PAD, pinv, cap)
                               .long(), ident)
    return pvals, sids, pinv, counts, over


def outbox_compact_plan_cuda(active: torch.Tensor):
    """(R, cap) bool active mask -> (pfwd, pinv, counts) by kernel K6,
    bit-identical to ``outbox_compact_plan_ref``."""
    dev, rows, cap = _check_rows(active, "K6")
    pfwd, pinv, counts = _int_outputs(dev, rows, cap, 1)
    err = _build.library().outbox_compact_plan_launch(
        active.data_ptr(), pfwd.data_ptr(), pinv.data_ptr(), counts.data_ptr(),
        rows, cap, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "outbox_compact_plan")
    _build.launches["outbox_compact_plan"] += 1
    return pfwd, pinv, counts


def launch_floor_cuda(rows: int, dev: torch.device) -> None:
    """Launch an empty kernel on the grid K5 and K6 take over ``rows`` rows:
    the launch floor their device time is read against. It is no port of a
    kernel and counts no launch."""
    err = _build.library().outbox_launch_floor(
        rows, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "outbox_launch_floor")


def k5_layout() -> dict:
    """The layout K5 and K6 were built with (``-DK5_THREADS``,
    ``-DK5_SLOTS``): a row's threads and a thread's slots a tile."""
    out = (ctypes.c_int * 2)()
    _build.library().outbox_pack_layout(out)
    return dict(zip(("threads", "slots"), out))
