"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each with its
plain PyTorch version: K1 ``semiring_spmv`` and K3 ``megastep_semiring``."""
from repro_torch.kernels.megastep import (megastep_semiring,
                                          megastep_semiring_cuda,
                                          megastep_semiring_ref)
from repro_torch.kernels.ops import semiring_spmv
from repro_torch.kernels.ref import (semiring_spmv_frontier_ref,
                                     semiring_spmv_ref)
from repro_torch.kernels.semiring_spmv import semiring_spmv_cuda

__all__ = ["semiring_spmv", "semiring_spmv_ref", "semiring_spmv_cuda",
           "semiring_spmv_frontier_ref", "megastep_semiring",
           "megastep_semiring_ref", "megastep_semiring_cuda"]
