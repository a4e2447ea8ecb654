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
a one-axis ``('parts',)`` mesh. The production LM mesh waits for ROADMAP
A8.3 and raises naming it.
"""
from __future__ import annotations

import os

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


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "the production LM mesh is not ported yet: ROADMAP A8.3 (the LM "
        "half of the multi-device backend)")
