"""Device meshes over ``torch.distributed``.

The port of the JAX package's ``launch/mesh.py``. A JAX mesh is a grid of
the devices one controller sees; here it is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of a process
group that the CALLER has initialised, one process a rank:

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method="file:///tmp/rdv",
                            rank=r, world_size=4)          # CPU ranks
    mesh = make_mesh((4,), ("parts",), device="cpu")

On ``cuda`` the group must be NCCL's (``init_process_group("nccl",
device_id=torch.device("cuda", local_rank), ...)``) and each rank owns
one card; on ``cpu`` it must be gloo's. Nothing here falls back from NCCL
to gloo or from the card to the CPU: a mismatch raises.

The graph engine (``GopherEngine(backend='shard_map', mesh=...)``) runs on
a one-axis ``('parts',)`` mesh: over the whole group (:func:`make_mesh`)
or over some of its ranks (:func:`sub_mesh`, what a mesh that lost a
device shrinks to). The production LM mesh waits for ROADMAP A8.3 and
raises naming it.

:func:`launch_ranks` starts a command once a rank and waits for them all
under one deadline (the scope and chaos CLIs' ``--devices N``);
:func:`init_rank` is what each such rank calls first.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

_BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}


def check_group(group, device: torch.device) -> None:
    """Raise unless ``group``'s backend is the one ``device`` runs on:
    NCCL for ``cuda``, gloo for ``cpu``."""
    want = _BACKEND_OF.get(device.type)
    got = dist.get_backend(group)
    if want is None or got != want:
        raise ValueError(f"a {device.type} mesh needs a {want} process "
                         f"group, got {got}")


def _local_rank() -> int:
    """This process's card on its host: ``LOCAL_RANK`` as launchers set
    it, else the global rank modulo the cards present."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() % max(torch.cuda.device_count(), 1)


def make_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    default process group (the product of ``shape`` must be its world
    size). On ``cuda`` this process's card (``LOCAL_RANK``, else the rank
    modulo the cards present) becomes the current device."""
    device = torch.device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call torch.distributed.init_process_group "
                           "first")
    check_group(None, device)
    if device.type == "cuda":
        torch.cuda.set_device(_local_rank())
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def sub_mesh(ranks, axes=("parts",), device="cuda"):
    """A one-axis ``DeviceMesh`` named ``axes`` over the ``ranks`` of the
    default group, in that order (a survivor keeps its place), or None on
    a rank outside them. Only the members build the group
    (``new_group(use_local_synchronization=True)``): a rank outside never
    enters the call, so a lost rank is never waited on (on NCCL that
    holds only where the default group was not bound to a card by
    ``init_process_group(device_id=)``: see :func:`init_rank`). The
    group's name hashes its ranks and the number of groups each member
    has made so far, so the members must have made as many, as the ranks
    of one SPMD program have (survivors share their history). The group
    must be the one ``device`` runs on (NCCL for ``cuda``, gloo for
    ``cpu``)."""
    device = torch.device(device)
    ranks = [int(r) for r in ranks]
    if len(axes) != 1:
        raise ValueError(f"a sub-mesh has one axis, got {tuple(axes)}")
    if dist.get_rank() not in ranks:
        return None
    group = dist.new_group(ranks, use_local_synchronization=True)
    check_group(group, device)
    if device.type == "cuda":
        torch.cuda.set_device(_local_rank())
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh.from_group(group, device.type,
                                 mesh_dim_names=tuple(axes))


def mesh_ranks(mesh) -> list:
    """The default group's ranks of a one-axis mesh, in mesh order."""
    return dist.get_process_group_ranks(mesh.get_group())


def launch_ranks(module: str, argv, devices: int, device: str,
                 timeout: float = 900.0) -> str:
    """Run ``python -m module *argv --rank r --rendezvous FILE`` once for
    each of ``devices`` ranks (a ``file://`` rendezvous in a temporary
    directory) and return rank 0's standard output. Every rank is held to
    one deadline ``timeout`` seconds away: when a rank fails or the
    deadline passes, every rank still running is killed and this raises.
    On ``cuda`` each rank needs a card of its own."""
    if device.startswith("cuda") and devices > torch.cuda.device_count():
        raise ValueError(f"--devices {devices} on cuda needs as many cards; "
                         f"{torch.cuda.device_count()} present")
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        out_path = os.path.join(tmp, "rank0.out")
        with open(out_path, "w") as out:
            procs = [subprocess.Popen(
                [sys.executable, "-m", module, *argv, "--rank", str(r),
                 "--rendezvous", os.path.join(tmp, "rdv")], env=env,
                stdout=out if r == 0 else subprocess.DEVNULL, text=True)
                for r in range(devices)]
            try:
                rcs = _wait_all(procs, time.monotonic() + timeout)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        with open(out_path) as f:
            text = f.read()
    if rcs is None:
        raise TimeoutError(f"{module} ranks still running after {timeout}s; "
                           f"killed")
    if any(rc != 0 for rc in rcs):
        raise RuntimeError(f"{module} ranks exited with {rcs} (None: "
                           f"killed after a peer failed)")
    return text


def _wait_all(procs, deadline: float):
    """The processes' exit codes once all have exited or one has failed
    (None for those still running, which the caller kills: a peer of a
    failed rank may wait on it for ever), or None at the deadline."""
    while True:
        rcs = [p.poll() for p in procs]
        if None not in rcs or any(rcs):
            return rcs
        if time.monotonic() > deadline:
            return None
        time.sleep(0.05)


def init_rank(rank: int, world: int, rendezvous: str, device: str):
    """This rank's default process group (gloo on the CPU, NCCL on the
    card, one card a rank) through the ``file://`` ``rendezvous`` of
    :func:`launch_ranks`, and the one-axis mesh over all of it. The NCCL
    group is not bound to a card up front: a bound group builds every
    subgroup by ``ncclCommSplit``, which every rank of the parent must
    enter, and a lost rank never does (:func:`sub_mesh`)."""
    if device.startswith("cuda"):
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if device.startswith("cuda") else "gloo",
        init_method=f"file://{rendezvous}", rank=rank, world_size=world)
    return make_mesh((world,), ("parts",), device=device)


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "the production LM mesh is not ported yet: ROADMAP A8.3 (the LM "
        "half of the multi-device backend)")
