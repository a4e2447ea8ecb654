"""Sub-graph centric programs — the user-facing Compute abstraction.

The paper's ``Compute(Subgraph, Iterator<Message>)`` runs a shared-memory
algorithm over the sub-graph per superstep; here that is a local-fixpoint
sweep: a semiring relaxation iterated until the partition's state quiesces
(``max_local_iters=None``, the sub-graph centric model). The fused
superstep that executes it lives in ``kernels.megastep``; a program only
names its semiring and its initial state.

Programs are frozen dataclasses, as in the JAX package, and ``init`` takes
the whole (P, ...) graph block of tensors at once. Still to come (ROADMAP):
the staged ``superstep``/``messages`` methods, the bounded and vertex-
centric fixpoints, and ``resume`` from a previous fixpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class SemiringProgram:
    """Idempotent-semiring fixpoint programs: CC, SSSP, BFS, MaxVertex.

    The state carries the send set ``changed_v`` and the active frontier,
    both seeded with ``vmask`` on a cold start; the local fixpoint is a
    masked sweep gated on the frontier, bitwise identical to the unmasked
    one for idempotent ⊕."""
    semiring: str                       # min_plus | max_first
    init_fn: Optional[Callable] = None  # gb -> x0 (P, v_max)
    max_local_iters: Optional[int] = None
    fixpoint_unroll: int = 1            # sweeps fused per loop iteration

    @property
    def combine(self) -> str:
        return "min" if self.semiring == "min_plus" else "max"

    @property
    def megastep_kind(self) -> Optional[str]:
        """Fused-route eligibility: the fused superstep replays the
        run-to-local-fixpoint schedule, so only the sub-graph centric mode
        (max_local_iters=None) qualifies."""
        return "semiring" if self.max_local_iters is None else None

    def init(self, gb) -> dict:
        return {"x": self.init_fn(gb), "changed_v": gb["vmask"].clone(),
                "frontier": gb["vmask"].clone()}


@dataclasses.dataclass(frozen=True)
class PageRankProgram:
    """Classic PageRank (paper §5.3): one Jacobi iteration per superstep,
    fixed ``num_iters`` supersteps (the paper runs 30), pull formulation.
    Remote in-edges deliver contributions through the mailbox (⊕ = sum).
    Dangling vertices' mass is redistributed by the teleport distribution
    every iteration, so ranks sum to 1 on graphs with sinks."""
    n_global: int
    num_iters: int = 30
    damping: float = 0.85
    tol: Optional[float] = None         # early halt on the GLOBAL L1 delta
    init_fn: Optional[Callable] = None  # gb -> r0 (P, v_max)
    teleport_fn: Optional[Callable] = None  # gb -> (P, v_max) distribution;
                                            # uniform when None

    combine = "sum"

    @property
    def megastep_kind(self) -> Optional[str]:
        """Fused-route eligibility: only the fixed-iteration schedule. With
        ``tol`` the halt compares a global float sum against a threshold,
        and the fused route's association could flip that comparison on the
        margin."""
        return "pagerank" if self.tol is None else None

    def init(self, gb) -> dict:
        vmask = gb["vmask"]
        if self.init_fn is not None:
            r0 = torch.where(vmask, self.init_fn(gb), 0.0)
        else:
            r0 = torch.where(vmask, 1.0 / self.n_global, 0.0)
        return {"r": r0.to(torch.float32), "delta": INF}


# ---------------- init helpers ----------------

def init_max_vertex(gb):
    """MaxVertex / CC seed: each vertex starts at its own global id (paper's
    HCC: propagate the largest vertex id). Exact below 2^24 vertices."""
    return torch.where(gb["vmask"], gb["global_id"].to(torch.float32), -INF)


def make_sssp_init(source_part: int, source_local: int):
    def init(gb):
        x = torch.full(gb["vmask"].shape, INF, dtype=torch.float32,
                       device=gb["vmask"].device)
        x[:, source_local] = torch.where(gb["part_index"] == source_part,
                                         0.0, INF)
        return x
    return init


def make_bfs_init(source_part: int, source_local: int):
    return make_sssp_init(source_part, source_local)  # BFS = SSSP, unit wgt
