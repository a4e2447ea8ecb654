"""A one-rank gloo world inside the test process, for the tests that run
the port's ``shard_map`` backend on one CPU rank (the multi-rank worlds of
``tests/test_torch_mesh.py`` run in processes of their own)."""
import contextlib

import torch.distributed as dist


@contextlib.contextmanager
def one_rank_world(tmp_path):
    """Yield a one-device ``('parts',)`` CPU mesh over a fresh gloo group
    (rendezvous through a file in ``tmp_path``, no TCP port); the group is
    destroyed on the way out."""
    from repro_torch.launch.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield make_mesh((1,), ("parts",), device="cpu")
    finally:
        dist.destroy_process_group()
