"""The one entry point for every collective of the port.

Each ``torch.distributed`` call the port makes — the engine's halt votes,
sums and run-end gathers, the mailbox routes and tier shifts, the
service's agreement calls, the checkpoint barrier, the LM's named
collectives and the mesh's subgroups — goes through a thin function here,
one a kind, with ``torch.distributed``'s own signature.

While a recorder is active on this thread (``analysis.collectives``'s
:class:`~repro_torch.analysis.collectives.Recorder`, installed by
:func:`set_recorder`), each call first tells it what is about to run
(kind, tensor, reduce op, group, the caller's frame); the recorder may
check the call and agree on it with the group's other ranks before the
collective itself is issued. With no recorder the cost is one attribute
read and one branch, and the call is exactly the ``torch.distributed``
one.
"""
from __future__ import annotations

import sys
import threading

import torch.distributed as dist

_local = threading.local()


def recorder():
    """The recorder active on this thread, or None."""
    return getattr(_local, "rec", None)


def set_recorder(rec):
    """Install ``rec`` (None: none) on this thread; returns the previous
    one."""
    prev = getattr(_local, "rec", None)
    _local.rec = rec
    return prev


def all_reduce(t, op=dist.ReduceOp.SUM, group=None):
    """``dist.all_reduce(t, op, group)``, in place."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.collective("all_reduce", (t,), group, sys._getframe(1), op=op)
    dist.all_reduce(t, op=op, group=group)


def all_gather(parts, t, group=None):
    """``dist.all_gather(parts, t, group)``: every rank's ``t`` into
    ``parts``."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.collective("all_gather", (t,), group, sys._getframe(1))
    dist.all_gather(parts, t, group=group)


def all_gather_into_tensor(out, t, group=None):
    """``dist.all_gather_into_tensor(out, t, group)``."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.collective("all_gather_into_tensor", (t,), group,
                       sys._getframe(1))
    dist.all_gather_into_tensor(out, t, group=group)


def all_to_all_single(out, t, group=None):
    """``dist.all_to_all_single(out, t, group=group)``, equal splits."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.collective("all_to_all_single", (t,), group, sys._getframe(1))
    dist.all_to_all_single(out, t, group=group)


def broadcast(t, src: int, group=None):
    """``dist.broadcast(t, src, group)`` (``src`` a global rank)."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.collective("broadcast", (t,), group, sys._getframe(1))
    dist.broadcast(t, src=src, group=group)


def barrier(group=None):
    """``dist.barrier(group)``."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.collective("barrier", (), group, sys._getframe(1))
    dist.barrier(group=group)


def batch_isend_irecv(p2p_ops, group=None):
    """``dist.batch_isend_irecv(p2p_ops)``, every op on ``group``; waits
    for all of them. Every rank of ``group`` issues one such round at the
    same point (a tier shift), so it is recorded as one collective of the
    group, sized by the tensors this rank sends."""
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.collective("batch_isend_irecv",
                       tuple(p.tensor for p in p2p_ops if p.op is dist.isend),
                       group, sys._getframe(1))
    for w in dist.batch_isend_irecv(p2p_ops):
        w.wait()


def new_group(ranks, **kwargs):
    """``dist.new_group(ranks, **kwargs)``; an active recorder notes the
    group (a group made, not a collective)."""
    group = dist.new_group(ranks, **kwargs)
    rec = getattr(_local, "rec", None)
    if rec is not None:
        rec.group_made(group, ranks, sys._getframe(1))
    return group
