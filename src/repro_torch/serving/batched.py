"""Query-batched programs: Q concurrent graph queries in one BSP run.

The port of the JAX package's ``serving/batched.py``. The state and the
inbox gain a TRAILING query axis — (P, v_max, Q) instead of (P, v_max) —
and the partition sweep becomes the two-bin multi-vector sweep
(``kernels.ops.binned_ell_spmv_multi``) over all Q queries at once. Q
queries then share one graph block, one engine and one set of supersteps
(the most any query needs, not the sum): the fixed costs of a superstep
are paid once a batch instead of once a query. With the query axis
trailing, every mailbox slot and every neighbour gather moves one
contiguous Q-vector. Hosts and results still speak "Q first":
:func:`gather_query_results` returns (Q, n_global).

The per-request inputs (SSSP sources, reachability seed sets, PPR
teleport vectors) arrive as per-run graph-block entries (``qinit`` /
``qseed``, or ``qx0`` / ``qfrontier0`` for a resume) through
``GopherEngine.run_queries(extra=)``, never in a program's fields, so one
pooled engine serves every batch of its bucket size.

Like the engine's other programs these work on the whole (P, ...) batch of
partitions at once (the JAX package ``vmap``s them per partition); their
sweeps read the block's flat two-bin adjacency ``gb["adj"]``
(``kernels.flat.flat_binned_adjacency``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.gofs.formats import PAD, PartitionedGraph
from repro_torch.kernels import flat, ops

QUERY_INIT_KEY = "qinit"   # (P, v_max, Q) float32 initial semiring state
QUERY_SEED_KEY = "qseed"   # (P, v_max, Q) float32 PPR teleport vectors
QUERY_X0_KEY = "qx0"       # (P, v_max, Q) float32 previous fixpoint (resume)
QUERY_FRONTIER_KEY = "qfrontier0"  # (P, v_max, Q) bool dirty seed (resume)


def _remote_q(t: torch.Tensor, gb: dict):
    """``t[p, re_src[p, e], :]`` for every remote edge of a query-trailing
    (P, v_max, Q) tensor, and the edges' (P, r_max) validity."""
    P, _, Q = t.shape
    src = gb["re_src"]
    valid = src != PAD
    idx = torch.where(valid, src, 0).long()[..., None].expand(P, -1, Q)
    return torch.gather(t, 1, idx), valid


@dataclasses.dataclass(frozen=True)
class BatchedSemiringProgram:
    """Q-query idempotent-semiring fixpoint: multi-source SSSP / BFS /
    multi-seed reachability, one query a lane of ``gb[init_key]``.

    Each query's values and send masks are those of its own SemiringProgram
    run: the local fixpoint, the per-vertex changed flags and so the send
    masks factor over the query axis. The lanes share the halt vote and the
    sweeps — the batch sweeps while any lane's frontier is non-empty, so
    its supersteps and local_iters are not a scalar run's — and a quiesced
    lane sends nothing while the rest finish."""
    semiring: str                       # min_plus | max_first
    num_queries: int
    init_key: str = QUERY_INIT_KEY
    max_local_iters: Optional[int] = None
    fixpoint_unroll: int = 2            # sweeps fused a convergence check;
                                        # overshoot is a no-op for min/max
    # resume=True restarts all Q lanes from a previous fixpoint:
    # gb["qx0"] carries the prior states and gb["qfrontier0"] the dirty
    # seeds (algorithms.incremental.incremental_sssp_batched), the batched
    # mirror of SemiringProgram's resume, used for the landmark refresh
    resume: bool = False

    @property
    def combine(self) -> str:
        return "min" if self.semiring == "min_plus" else "max"

    @property
    def megastep_kind(self) -> Optional[str]:
        """Fused-route eligibility: the fused route replays the
        run-to-local-fixpoint schedule over the two-bin batched sweep."""
        return "batched_semiring" if self.max_local_iters is None else None

    def init(self, gb) -> dict:
        vm = gb["vmask"][..., None]
        if self.resume:
            seed = gb[QUERY_FRONTIER_KEY] & vm
            return {"x": gb[QUERY_X0_KEY], "changed_v": seed,
                    "frontier": seed.clone()}
        x0 = gb[self.init_key]                        # (P, v_max, Q)
        seed = vm.expand(x0.shape).clone()
        return {"x": x0, "changed_v": seed, "frontier": seed.clone()}

    def _sweep(self, x, gb):
        """One unmasked two-bin sweep (vertex-centric mode)."""
        y = ops.binned_sweep(x.reshape(-1, x.shape[-1]), None,
                             flat.binned_plan_of(gb["adj"]), self.semiring)
        return flat.combine_ew(self.combine, x, y.reshape(x.shape))

    def superstep(self, state, inbox, gb, step, reduce=None):
        x0 = state["x"]                               # (P, v_max, Q)
        vm = gb["vmask"][..., None]
        P, v_max, Q = x0.shape
        x = flat.combine_ew(self.combine, x0, inbox)
        improved = (x != x0) & vm
        f0 = state["frontier"] | improved
        if self.max_local_iters == 1:
            x2 = self._sweep(x, gb)
            liters = torch.ones(P, dtype=torch.int32, device=x.device)
            f_left = torch.zeros_like(f0)
        else:
            cap = (flat.MAX_LOCAL_ITERS if self.max_local_iters is None
                   else self.max_local_iters)
            flat.binned_plan_of(gb["adj"])
            xf, ff, liters = flat.local_fixpoint(
                x.reshape(-1, Q), f0.reshape(-1, Q), gb["adj"],
                vm.reshape(-1, 1), P, self.semiring, self.fixpoint_unroll,
                cap, sweep=flat.binned_sweep_frontier, operands=("plan",))
            x2, f_left = xf.reshape(x.shape), ff.reshape(x.shape)
        # no seed override at step 0: the engine primed the first inbox from
        # the init state's messages
        changed_v = (x2 != x0) & vm
        return ({"x": x2, "changed_v": changed_v, "frontier": f_left},
                changed_v.any(dim=1), liters)

    def messages(self, state, gb):
        xv, valid = _remote_q(state["x"], gb)
        vals = (xv + gb["re_wgt"][..., None] if self.semiring == "min_plus"
                else xv)
        sent, _ = _remote_q(state["changed_v"], gb)
        return vals, valid[..., None] & sent


@dataclasses.dataclass(frozen=True)
class BatchedPersonalizedPageRank:
    """Q personalized-PageRank queries a BSP run (pull Jacobi, a fixed
    ``num_iters`` supersteps): per query the arithmetic of PageRankProgram
    with a one-hot teleport. ``gb[seed_key]`` holds each query's teleport
    distribution (one-hot at the seed vertex, or any distribution)."""
    n_global: int
    num_queries: int
    num_iters: int = 30
    damping: float = 0.85
    seed_key: str = QUERY_SEED_KEY

    combine = "sum"
    megastep_kind = None                # runs on the staged route

    def init(self, gb) -> dict:
        seed = gb[self.seed_key]                      # (P, v_max, Q)
        return {"r": torch.where(gb["vmask"][..., None], seed, 0.0)}

    def _contrib(self, r, gb):
        deg = gb["out_degree"].to(torch.float32)[..., None]
        return torch.where(deg > 0, r / torch.clamp(deg, min=1.0), 0.0)

    def superstep(self, state, inbox, gb, step, reduce=None):
        """One Jacobi iteration of every query and partition. Each query's
        dangling mass is GLOBAL: summed per partition, then over the
        batch's partitions, then by ``reduce`` over the mesh's ranks (see
        ``core.programs``)."""
        vm = gb["vmask"][..., None]
        r = state["r"]                                # (P, v_max, Q)
        P, _, Q = r.shape
        # a unit-weight pull: PageRank pulls rank shares, not edge weights
        pull = ops.binned_sweep(
            self._contrib(r, gb).reshape(-1, Q), None,
            flat.binned_plan_of(gb["adj"], unit=True),
            "plus_times").reshape(r.shape)
        seed = gb[self.seed_key]
        dangling = torch.where(vm & (gb["out_degree"] == 0)[..., None], r,
                               0.0).sum(dim=1).sum(dim=0)        # (Q,)
        if reduce is not None:
            dangling = reduce(dangling)
        r_new = torch.where(
            vm, (1.0 - self.damping) * seed
            + self.damping * (pull + inbox + dangling * seed), 0.0)
        changed = torch.full((P, Q), step + 1 < self.num_iters,
                             device=r.device)
        return ({"r": r_new}, changed,
                torch.ones(P, dtype=torch.int32, device=r.device))

    def messages(self, state, gb):
        vals, valid = _remote_q(self._contrib(state["r"], gb), gb)
        return vals, valid[..., None].expand(vals.shape)


# ---------------- the host-side query arrays ----------------

def sssp_query_init(pg: PartitionedGraph,
                    sources: Sequence[int]) -> np.ndarray:
    """(P, v_max, Q) initial distances: 0 at each query's source, inf
    elsewhere. Also the BFS init on unit-weight graphs."""
    return reachability_query_init(pg, [[s] for s in sources])


def reachability_query_init(pg: PartitionedGraph,
                            seed_sets: Sequence[Sequence[int]]) -> np.ndarray:
    """Multi-seed reachability = BFS from a seed SET a query: every seed
    starts at 0; a vertex is reachable iff its result is finite."""
    x0 = np.full((pg.num_parts, pg.v_max, len(seed_sets)), np.inf,
                 np.float32)
    for q, seeds in enumerate(seed_sets):
        for s in seeds:
            x0[int(pg.part_of[s]), int(pg.local_of[s]), q] = 0.0
    return x0


def ppr_query_seed(pg: PartitionedGraph,
                   sources: Sequence[int]) -> np.ndarray:
    """(P, v_max, Q) one-hot teleport distributions for personalized PR."""
    seed = np.zeros((pg.num_parts, pg.v_max, len(sources)), np.float32)
    for q, s in enumerate(sources):
        seed[int(pg.part_of[s]), int(pg.local_of[s]), q] = 1.0
    return seed


def gather_query_results(pg: PartitionedGraph, xq) -> np.ndarray:
    """(P, v_max, Q) engine state -> (Q, n_global) in global vertex order."""
    xq = np.asarray(xq)
    out = np.zeros((xq.shape[2], pg.n_global), xq.dtype)
    for p in range(pg.num_parts):
        m = pg.vmask[p]
        out[:, pg.global_id[p][m]] = xq[p][m, :].T
    return out
