"""Checks shared by the algorithm entry points."""
from __future__ import annotations


def check_options(spmv_backend=None) -> None:
    """Raise for the options that select a JAX execution path."""
    if spmv_backend is not None:
        raise NotImplementedError(
            "spmv_backend selects a JAX execution path; the port picks its "
            "kernel by the tensors' device")
