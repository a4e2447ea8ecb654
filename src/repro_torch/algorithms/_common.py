"""Checks shared by the algorithm entry points."""
from __future__ import annotations


def check_options(mode: str = "subgraph", spmv_backend=None) -> None:
    """Raise for the options whose JAX route is not ported yet."""
    if mode != "subgraph":
        raise NotImplementedError(
            "mode='vertex' runs the staged dense route, which is not ported "
            "yet: ROADMAP A1 (the staged dense route)")
    if spmv_backend is not None:
        raise NotImplementedError(
            "spmv_backend selects a JAX execution path; the port picks its "
            "kernel by the tensors' device")
