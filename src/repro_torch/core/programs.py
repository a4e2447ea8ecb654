"""Sub-graph centric programs — the user-facing Compute abstraction.

The paper's ``Compute(Subgraph, Iterator<Message>)`` runs a shared-memory
algorithm over the sub-graph per superstep; here that is a local-fixpoint
sweep: a semiring relaxation iterated until the partition's state quiesces.

``max_local_iters`` selects the execution model:
    None -> run to local fixpoint  (sub-graph centric, Gopher)
    1    -> one sweep per superstep (vertex centric, the Giraph baseline)
    k    -> bounded local work

The fused superstep of the sub-graph centric model lives in
``kernels.megastep``. Every other schedule runs the staged route, whose
engine calls the methods below on the whole (P, ...) batch at once (the
JAX package ``vmap``s them per partition):

    init(gb)                          -> state dict of (P, v_max) tensors
    superstep(state, inbox, gb, step, reduce)
                                      -> (state, changed (P,), liters (P,))
    messages(state, gb)               -> (vals (P, r_max), send (P, r_max))
    combine                           -> inbox ⊕: 'min' | 'max' | 'sum'

On the ``shard_map`` backend each rank calls them on its own rows, and
``reduce`` (a tensor -> its sum over every rank, an all_reduce over the
mesh; the identity on ``local``) makes a program's global sums global:
PageRank's dangling mass and ``tol`` delta.

The staged sweeps run over the flat (P·v_max,) state and the block's flat
adjacency ``gb["adj"]`` (``kernels.flat.flat_adjacency``): one kernel
launch per sweep for all P partitions. ``SemiringProgram(resume=True)``
starts from a previous fixpoint: the incremental algorithms
(``algorithms.incremental``) hand its state and dirty seed to
``GopherEngine.run(extra=)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.gofs.formats import PAD
from repro_torch.kernels import flat, ops

INF = float("inf")


def _identity(t):
    return t


def _at_remote_src(t: torch.Tensor, gb: dict):
    """``t[p, re_src[p, e]]`` for every remote edge (PAD edges read slot 0)
    and the edges' validity, both (P, r_max)."""
    src = gb["re_src"]
    valid = src != PAD
    return torch.gather(t, 1, torch.where(valid, src, 0).long()), valid


@dataclasses.dataclass(frozen=True)
class SemiringProgram:
    """Idempotent-semiring fixpoint programs: CC, SSSP, BFS, MaxVertex.

    The state carries the send set ``changed_v`` and the active frontier,
    both seeded with ``vmask`` on a cold start and with ``gb["frontier0"]``
    on an incremental resume; the local fixpoint is a masked sweep gated on
    the frontier, bitwise identical to the unmasked one for idempotent ⊕. A
    partition whose frontier is empty runs ZERO sweeps that superstep.

    ``resume=True`` starts from a previous fixpoint: ``gb["x0"]`` is the
    prior state and ``gb["frontier0"]`` the dirty seed set (see
    gofs.temporal / algorithms.incremental); both arrive via
    ``GopherEngine.run(extra=...)``."""
    semiring: str                       # min_plus | max_first
    init_fn: Optional[Callable] = None  # gb -> x0 (P, v_max); unused on resume
    max_local_iters: Optional[int] = None
    fixpoint_unroll: int = 1            # sweeps fused per loop iteration
    resume: bool = False                # start from gb["x0"] / gb["frontier0"]

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
        if self.resume:
            seed = gb["frontier0"] & gb["vmask"]
            return {"x": gb["x0"], "changed_v": seed, "frontier": seed}
        return {"x": self.init_fn(gb), "changed_v": gb["vmask"].clone(),
                "frontier": gb["vmask"].clone()}

    def _sweep(self, x, gb):
        """One unmasked sweep (kernel K1 on the card)."""
        adj = gb["adj"]
        y = ops.semiring_spmv(x.reshape(-1), adj["nbr"], adj["wgt"],
                              self.semiring)
        return flat.combine_ew(self.combine, x, y.reshape(x.shape))

    def superstep(self, state, inbox, gb, step, reduce=None):
        x0 = state["x"]
        vmask = gb["vmask"]
        x = flat.combine_ew(self.combine, x0, inbox)
        improved = (x != x0) & vmask        # vertices the mailbox moved
        # active set = carried frontier (the seed at step 0; leftover work
        # when a bounded fixpoint hit its cap) ∪ inbox improvements
        f0 = state["frontier"] | improved
        P = vmask.shape[0]
        if self.max_local_iters == 1:
            # vertex-centric baseline (Giraph): one full sweep, unmasked
            x2 = self._sweep(x, gb)
            liters = torch.ones(P, dtype=torch.int32, device=x.device)
            f_left = torch.zeros_like(vmask)
        else:
            # the masked local fixpoint, one kernel K2 launch per sweep
            cap = (flat.MAX_LOCAL_ITERS if self.max_local_iters is None
                   else self.max_local_iters)
            xf, ff, liters = flat.local_fixpoint(
                x.reshape(-1), f0.reshape(-1), gb["adj"], vmask.reshape(-1),
                P, self.semiring, self.fixpoint_unroll, cap,
                sweep=ops.semiring_spmv_frontier)
            x2, f_left = xf.reshape(x.shape), ff.reshape(x.shape)
        # the send set: vertices with news this superstep (the engine primed
        # the first inbox from init's send set, so the seed needs nothing)
        changed_v = (x2 != x0) & vmask
        return ({"x": x2, "changed_v": changed_v, "frontier": f_left},
                changed_v.any(dim=1), liters)

    def messages(self, state, gb):
        xv, valid = _at_remote_src(state["x"], gb)
        vals = xv + gb["re_wgt"] if self.semiring == "min_plus" else xv
        sent, _ = _at_remote_src(state["changed_v"], gb)
        return vals, valid & sent


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
        # delta is (P,), as the JAX package's vmapped init gives it, so a
        # snapshot's leaves have the same shapes in both packages
        delta = torch.full((vmask.shape[0],), INF, dtype=torch.float32,
                           device=vmask.device)
        return {"r": r0.to(torch.float32), "delta": delta}

    def _contrib(self, r, gb):
        deg = gb["out_degree"].to(torch.float32)
        return torch.where(deg > 0, r / torch.clamp(deg, min=1.0), 0.0)

    def superstep(self, state, inbox, gb, step, reduce=None):
        """One Jacobi iteration of every partition. The dangling mass and
        the ``tol`` delta are GLOBAL: summed per partition, then over the
        batch's partitions, then by ``reduce`` over the mesh's ranks (the
        JAX package's ``psum`` over the partition and mesh axes)."""
        reduce = reduce or _identity
        vmask = gb["vmask"]
        r = state["r"]
        P = vmask.shape[0]
        pull = flat.sweep_flat_dense(self._contrib(r, gb).reshape(-1),
                                     gb["adj"]).reshape(r.shape)
        tele = (self.teleport_fn(gb) if self.teleport_fn is not None
                else 1.0 / self.n_global)
        dangling = reduce(torch.where(vmask & (gb["out_degree"] == 0), r,
                                      0.0).sum(dim=1).sum())
        r_new = torch.where(
            vmask,
            (1.0 - self.damping) * tele
            + self.damping * (pull + inbox + dangling * tele), 0.0)
        delta = reduce((r_new - r).abs().sum(dim=1).sum())
        more = step + 1 < self.num_iters
        if self.tol is not None:
            changed = (delta > self.tol) & more
        else:
            changed = torch.tensor(more, device=r.device)
        return ({"r": r_new, "delta": delta.expand(P)}, changed.expand(P),
                torch.ones(P, dtype=torch.int32, device=r.device))

    def messages(self, state, gb):
        return _at_remote_src(self._contrib(state["r"], gb), gb)


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
