"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each with its
plain PyTorch version: K1 ``semiring_spmv``, K2 ``semiring_spmv_frontier``,
K3 ``megastep_semiring``, K4 ``resident_megastep``, K5 ``outbox_pack``,
K6 ``outbox_compact_plan``, K7 ``flash_attention`` and K8 ``mamba1_scan``.
K7's and K8's dispatchers stay in ``kernels.ops`` (a package attribute of
the same name would shadow their modules)."""
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_ref)
from repro_torch.kernels.mamba_scan import mamba1_scan_cuda, mamba1_scan_ref
from repro_torch.kernels.megastep import (megastep_semiring,
                                          megastep_semiring_cuda,
                                          megastep_semiring_ref,
                                          resident_megastep,
                                          resident_megastep_cuda,
                                          resident_megastep_ref)
from repro_torch.kernels.ops import (outbox_compact_plan, outbox_pack,
                                     semiring_spmv, semiring_spmv_frontier)
from repro_torch.kernels.outbox_compact import (outbox_compact_plan_cuda,
                                                outbox_pack_cuda)
from repro_torch.kernels.ref import (outbox_compact_plan_ref, outbox_pack_ref,
                                     semiring_spmv_frontier_ref,
                                     semiring_spmv_ref)
from repro_torch.kernels.semiring_spmv import (semiring_spmv_cuda,
                                               semiring_spmv_frontier_cuda)

__all__ = ["semiring_spmv", "semiring_spmv_ref", "semiring_spmv_cuda",
           "semiring_spmv_frontier", "semiring_spmv_frontier_ref",
           "semiring_spmv_frontier_cuda", "megastep_semiring",
           "megastep_semiring_ref", "megastep_semiring_cuda",
           "resident_megastep", "resident_megastep_ref",
           "resident_megastep_cuda", "outbox_pack",
           "outbox_pack_ref", "outbox_pack_cuda", "outbox_compact_plan",
           "outbox_compact_plan_ref", "outbox_compact_plan_cuda",
           "flash_attention_ref", "flash_attention_cuda", "mamba1_scan_ref",
           "mamba1_scan_cuda"]
