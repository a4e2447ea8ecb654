"""Gopher: the sub-graph centric BSP execution engine.

The port of the JAX package's ``core/engine.py``, with its two backends:

  paper                               here
  -----                               ----
  worker per machine                  'local': one partition of the
                                      (P, v_max) state, all P run as one
                                      batch on one device; 'shard_map': a
                                      process a rank, v = P / D partitions
                                      each, over ``torch.distributed``
  thread pool over sub-graphs         the local-fixpoint sweep over the
                                      flat (v·v_max,) state of a batch
  message flush at the barrier        the mailbox exchange between
                                      supersteps: a transpose on 'local',
                                      collectives over the mesh on
                                      'shard_map'
  manager sync/resume/terminate       one host read of the halt vote per
                                      superstep (an all_reduce first on
                                      'shard_map')

Five wire disciplines (``exchange=``):
  'megastep'  the whole superstep — mailbox delivery, inbox combine, masked
              local fixpoint — fused into one call of ``kernels.megastep``
              (kernel K3) over flat state; the route 'auto' takes for every
              program with a ``megastep_kind``. With a ``PhasedTierPlan``
              whose remaining band geometry fits the resident gate
              (``kernels.megastep.resident_enter_round``), the run switches
              to the RESIDENT narrow-phase mode: relaxation rounds of one
              delivery and one sweep each, kernel K4 on the card
  'dense'     the staged route: the program's superstep (its sweeps are
              kernels K1/K2), then the exchange — pack every pair's full
              cap-slot row, route by transpose, gather-combine the inbox.
              The parity oracle; 'auto' takes it for the other programs
              (vertex-centric and bounded fixpoints, PageRank with ``tol``)
  'compact'   the staged route with each pair row packed to the prefix of
              its active slots (kernel K5) and rebuilt at the receiver:
              bit-identical to 'dense', with a wire that tracks the frontier
  'tiered'    the staged route with a ``core.tiers.TierPlan``: hot pairs
              ship the dense row, warm/cold pairs a packed prefix truncated
              to their tier width (kernel K5 with the plan's limits),
              excluded pairs nothing. A pair that overflowed its width
              makes the run repeat on 'dense' (bit-identical results) and
              escalates the pair in ``engine.tier_plan``
  'phased'    the tiered route with a ``PhasedTierPlan``: one segment of
              the BSP loop per frontier band, each at its phase's tier
              table; a superstep whose pack overflowed routes dense
              instead, so no run repeats, and the spilling phase is
              escalated afterwards

A query-batched program (``serving.batched``, ``program.num_queries`` Q)
runs through :meth:`GopherEngine.run_queries` on every exchange but the
resident mode: its state is query-trailing (P, v_max, Q), its fused route
is ``kernels.megastep.megastep_semiring_batched`` (plain torch ops, no
kernel), its staged packs ship a Q-vector a slot (kernel K5's plan on
'compact', 'tiered' and 'phased'), and the run halts when no lane changed
anywhere; ``Telemetry.query_supersteps`` keeps each lane's last change.

Each BSP loop is a Python loop over supersteps; the telemetry stays on the
device until the run ends, and the halt vote (how many partitions changed,
stacked on the phased route with the demotion streak's count) is the only
value the host reads per superstep. The fixpoint inside a staged superstep
reads one "any frontier left" flag per sweep.

Two telemetries for one resident run. The JAX package takes its Pallas
kernel only on a TPU, so on a CPU it folds every resident round into the
telemetry. The port picks by the tensors' device: on a CUDA tensor the
resident rounds are ONE K4 launch, which reports totals only, so their
``changed_hist`` and ``count_hist`` entries stay zero, exactly as on the
TPU; on a CPU tensor every round is folded. ``supersteps``,
``local_iters``, ``messages_sent``, ``pair_slots`` and the state agree in
both cases. A resident start with nothing to send or sweep (a resume from
an empty seed) counts one empty superstep on both: the folded loop runs
it, and K4, which runs no round then, is counted as having entered one
(the JAX package's TPU path reports K4's 0 there).

A run with a ``training.checkpoint.Checkpointer`` (``run(checkpointer=,
checkpoint_every=)``) is the JAX package's checkpointed loop: the staged
loop stepped on the host, split at the network boundary, snapshotting
(state, inbox) at superstep barriers — the paper's synchronization points
are the recovery lines. Its fault sites (``resilience.faults``) fire on the
host between launches.

Gopher Scope (``obs``). An ENABLED ``obs.trace.Tracer`` (``tracer=``, or
the process default ``obs.set_tracer`` armed after the engine was built)
makes every loop above the JAX package's traced stepped driver: the same
loop, launching the same kernels, with the span tree

    run → plan ×K, init, prime, phase ×K → superstep →
          {sweep, pack, exchange, halt-vote}   (staged routes)
          {megastep, halt-vote}                (fused route)

the ``stage_builds``/``dispatches`` counters, the fault sites
``engine.superstep`` and ``exchange.route`` and ``Telemetry.part_seconds``.
A traced fused run never enters the resident mode (a trace wants a span a
superstep, and K4 hides its rounds inside one launch), so it launches K3
(or K1 for PageRank) once a superstep. A disabled tracer costs a no-op
context a span and reads nothing more from the device. Every run, traced
or not, folds its telemetry into a metrics registry (``metrics=``, or the
process default) from values already on the host.

The ``shard_map`` backend (SPMD, the paper's deployment: a worker a
machine) runs the staged routes — 'dense', 'compact', 'tiered', 'phased';
'auto' is 'dense' at D = 1 and 'tiered' above — with a
``torch.distributed`` ``DeviceMesh`` of one axis (``launch.mesh``). The
caller initialises the process group (gloo on the CPU, NCCL on the card,
where a rank owns one card); every rank builds the same engine from the
same host graph, uploads its rows [r·v, (r+1)·v) of the block and
launches the same kernels on them. The mailbox routes by
``messages.route_shard_map`` (one ``all_to_all_single``) or
``messages.route_tiered`` over the group; a superstep's counters and halt
vote are one all_reduce before its one host read; the phased route
all-reduces its overflow flag and reads it, so every rank routes the same
way; PageRank's global sums are all_reduces (``core.programs``). At the
end every rank all-gathers the state and the per-partition telemetry and
returns what the JAX package's single controller returns: the full (P, ...)
state and the same Telemetry. Checkpointed runs snapshot the gathered
arrays from rank 0 (``training.checkpoint``) and restore each rank's rows.

Gopher Sentinel (``analysis``). ``validate=True`` checks the tier plan
(``check_plan_static``) and the program's semiring laws
(``check_program``) when the engine is built, and runs the first run of
each configuration (program, backend, exchange, plan, Q, D, P, v_max, cap
and loop) under the collective recorder: every rank agrees on each
collective before it is issued, and the run's record is held to the
group, megastep, byte-budget and reference-kind rules
(``analysis.validated_run``). A validated run launches the same kernels
and returns the same state and Telemetry as an unvalidated one; later
runs of a validated configuration are plain runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import messages as msg
from repro_torch.core import wire as _wire
from repro_torch.core.blocks import _BINNED, graph_block
from repro_torch.core.tiers import DEMOTE_STREAK, PhasedTierPlan, TierPlan
from repro_torch.gofs.formats import PartitionedGraph
from repro_torch.kernels import flat, ops
from repro_torch.kernels import megastep as mega
from repro_torch.launch.mesh import check_group
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import skew as obs_skew
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience import faults as _faults

_EXCHANGES = ("auto", "compact", "dense", "tiered", "phased", "megastep")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``cuda`` needs a card: without one
    this raises instead of carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run the plain versions")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: use cuda or cpu")
    return device


@dataclasses.dataclass
class Telemetry:
    """What a run records (the JAX package's Telemetry fields of the
    local backend's routes)."""
    supersteps: int
    local_iters: np.ndarray        # (P,) cumulative sweep iterations
    changed_hist: np.ndarray       # (supersteps,) #partitions changed
    messages_sent: int
    # query-batched runs: (Q,) the superstep after which each query last
    # changed (0 for a query that never did); None on single-query runs
    query_supersteps: Optional[np.ndarray] = None
    # round-indexed (length supersteps + 1): round 0 is the inbox prime (the
    # initial state's messages), round s + 1 the exchange after superstep s.
    #   'dense'    PHYSICAL: the P²·cap buffer every round
    #   'tiered'   PHYSICAL: the tier schedule's routed slots every round
    #              (core.tiers.TierSchedule.round_slots)
    #   'phased'   PHYSICAL: the round's phase's routed slots, or P²·cap on
    #              a round that fell back to the dense route
    #   'compact'  MODELED payload: Σ packed counts per round
    #   'megastep' zeros: nothing is routed
    wire_hist: Optional[np.ndarray] = None
    wire_slots: int = 0            # Σ wire_hist
    bytes_on_wire: int = 0         # wire bytes under the route's model
    exchange: str = ""
    pair_slots: Optional[np.ndarray] = None    # (P, P) Σ active slot counts
    pair_rounds: int = 0                       # rounds pair_slots covers
                                               # (the aborted tiered
                                               # attempt's after a retry)
    pair_overflow: Optional[np.ndarray] = None # (P, P) #rounds overflowed
    spills: int = 0                            # Σ pair_overflow
    escalations: int = 0                       # pairs promoted after spills
    retried: bool = False                      # the tiered run was repeated
                                               # on the dense route
    count_hist: Optional[np.ndarray] = None    # (supersteps + 1,) Σ counts;
                                               # None on 'dense'
    # phased runs only
    phase_hist: Optional[np.ndarray] = None    # (supersteps + 1,) phase of
                                               # each round (round 0: 0)
    phase_switch_steps: Optional[np.ndarray] = None  # supersteps at which
                                               # the run entered a new phase
    phase_wire: Optional[np.ndarray] = None    # (K,) routed slots per phase
    phase_pair_slots: Optional[np.ndarray] = None    # (K, P, P) Σ counts
    dense_retry_steps: int = 0                 # rounds routed dense after
                                               # an in-phase overflow
    # Gopher Balance: wall-clock seconds attributed per partition by the
    # checkpointed and traced loops — the TIME channel of the skew report.
    # Injected straggler stalls land on their targeted partition; the rest
    # of each superstep's time (the card's work included: the clock stops
    # after the halt vote's host read) spreads evenly, since one process
    # cannot see per-partition splits of a batched launch. None on the
    # untraced loops, which keep no per-superstep host clock.
    part_seconds: Optional[np.ndarray] = None  # (P,) float64

    @staticmethod
    def model_bytes(slots: int, num_parts: int, rounds: int, cap: int,
                    compact: bool, num_queries: Optional[int] = None) -> int:
        """The dense/compact comm-volume model: per round the dense exchange
        ships every pair row — P² · cap · Q values at 4 B (Q = 1 for a
        single query) — while the compact exchange ships, per pair, a count
        header (4 B) plus count packed slots at 4·Q value bytes and a 4-byte
        slot id each. (The tiered and phased routes use TierSchedule's
        geometry instead.)"""
        q = num_queries or 1
        if not compact:
            return rounds * num_parts * num_parts * cap * q * 4
        return slots * (4 * q + 4) + rounds * num_parts * num_parts * 4

    def skew(self) -> dict:
        """Gopher Scope: the run's partition-imbalance report (straggler
        score off local_iters, wire skew off pair_slots, the time channel
        off part_seconds) — see ``obs.skew.skew_report``."""
        return obs_skew.skew_report(self)


class _Ranks:
    """Where this process sits on the engine's mesh: ``D`` ranks of ``v =
    P / D`` partitions each, this one ``me``, holding ``rows`` = [me·v,
    (me+1)·v). ``group`` is the mesh's process group on 'shard_map' (its
    collectives run at D = 1 too) and None on 'local', where D = 1 and
    :meth:`sum` and :meth:`gather` are the identity."""

    def __init__(self, num_parts: int, group=None):
        self.group = group
        self.D = 1 if group is None else dist.get_world_size(group)
        self.me = 0 if group is None else dist.get_rank(group)
        self.v = num_parts // self.D
        self.rows = slice(self.me * self.v, (self.me + 1) * self.v)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over every rank (an all_reduce)."""
        if self.group is None:
            return t
        t = t.clone()
        _wire.all_reduce(t, group=self.group)
        return t

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (its rows of a (P, ...) array) concatenated
        in rank order: the full array, on every rank."""
        if self.group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.D)]
        _wire.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)


def _stats(*vals) -> torch.Tensor:
    """One int64 vector of a superstep's counters (scalars, then any
    vector), what :meth:`_Ranks.sum` reduces in one all_reduce."""
    return torch.cat([v.to(torch.int64).reshape(-1) for v in vals])


class _Tally:
    """Device-side accumulators of one run's telemetry. The per-partition
    ones (``liters``, ``pairs``, ``over``, ``psec``) hold this process's
    ``p`` partitions (all P on 'local', a rank's v on 'shard_map', gathered
    by :meth:`gather` at the end); the histograms and totals hold the
    global values. ``pairs0`` is None where the route observes no per-pair
    counts ('dense'); ``cnt0`` is the prime's global Σ counts (Σ ``pairs0``
    when None); ``over0`` is the prime's overflow flags on the
    tiered/phased routes. With ``phases=K`` (the phased route) the per-pair
    counts and overflow flags are kept per phase, (p, K, P), beside each
    round's phase and the dense-retry count."""

    def __init__(self, p: int, max_s: int, nsent0, wire0, pairs0, device,
                 over0=None, phases: Optional[int] = None, dstep0=None,
                 queries: Optional[int] = None, cnt0=None):
        self.liters = torch.zeros(p, dtype=torch.int32, device=device)
        self.qsteps = (torch.zeros(queries, dtype=torch.int32, device=device)
                       if queries is not None else None)
        self.hist = torch.zeros(max_s, dtype=torch.int32, device=device)
        self.whist = torch.zeros(max_s + 1, dtype=torch.int64, device=device)
        self.whist[0] = wire0
        self.sent = torch.as_tensor(nsent0, device=device).to(
            torch.int64).clone()
        self.pairs = self.chist = self.over = None
        self.psec = None             # part_seconds, on a clocked loop
        self.phases = phases
        if pairs0 is not None:
            self.chist = torch.zeros(max_s + 1, dtype=torch.int32,
                                     device=device)
            self.chist[0] = pairs0.sum() if cnt0 is None else cnt0
            self.pairs = pairs0.clone()
        if over0 is not None:
            self.over = over0.clone()
        if phases is not None:
            self.pairs = torch.zeros((p, phases, pairs0.shape[1]),
                                     dtype=torch.int32, device=device)
            self.pairs[:, 0] = pairs0
            self.over = torch.zeros_like(self.pairs)
            self.over[:, 0] = over0
            self.phist = torch.zeros(max_s + 1, dtype=torch.int32,
                                     device=device)
            self.dsteps = torch.as_tensor(dstep0, device=device).to(
                torch.int64)
            self.seg_end = [0] * phases

    def fold(self, step: int, nchanged, liters, nsent, wire, pairs,
             over=None, phase: Optional[int] = None, dstep=None,
             changed_q=None, cnt=None) -> None:
        """One superstep: ``nchanged``, ``nsent``, ``wire`` and ``cnt`` (Σ
        ``pairs`` when None) global, ``liters``, ``pairs`` and ``over``
        this process's partitions'."""
        self.liters += liters
        if changed_q is not None:
            self.qsteps = torch.where(changed_q, step + 1, self.qsteps)
        self.hist[step] = nchanged
        self.whist[step + 1] = wire
        self.sent += nsent
        if self.pairs is not None:
            self.chist[step + 1] = pairs.sum() if cnt is None else cnt
        if phase is None:
            if self.pairs is not None:
                self.pairs += pairs
            if over is not None:
                self.over += over
        else:
            self.pairs[:, phase] += pairs
            self.over[:, phase] += over
            self.phist[step + 1] = phase
            self.dsteps += dstep

    def charge(self, dt: float, eff: Optional[dict], num_parts: int,
               lo: int) -> None:
        """One clocked superstep of ``dt`` seconds into ``psec``, which
        holds the partitions from ``lo`` on of ``num_parts``: the injected
        stalls ``eff`` reports (``faults.fire``'s effects, which every rank
        fires and sleeps) to their partition, the rest spread evenly over
        all ``num_parts``."""
        stalls = [(p, s) for p, s in (eff or {}).get("stalls", [])
                  if 0 <= p < num_parts]
        self.psec += max(dt - sum(s for _, s in stalls), 0.0) / num_parts
        for p, s in stalls:
            if lo <= p < lo + len(self.psec):
                self.psec[p - lo] += s

    def gather(self, ranks: _Ranks) -> None:
        """The per-partition accumulators of every rank, in place: the
        (P, ...) arrays the JAX package's ``out_specs`` reassemble."""
        if ranks.group is None:
            return
        self.liters = ranks.gather(self.liters)
        if self.pairs is not None:
            self.pairs = ranks.gather(self.pairs)
        if self.over is not None:
            self.over = ranks.gather(self.over)
        if self.psec is not None:
            self.psec = ranks.gather(torch.from_numpy(self.psec).to(
                self.liters.device)).cpu().numpy()

    def telemetry(self, steps: int, exchange: str, num_parts: int, cap: int,
                  plan=None, num_queries: Optional[int] = None,
                  rounds: Optional[int] = None,
                  num_devices: int = 1) -> Telemetry:
        """Close the (gathered) tally of a run of ``steps`` supersteps on
        route ``exchange``; ``plan`` is the tier plan the tiered/phased run
        routed with (its schedules over ``num_devices`` price the wire's
        bytes, a query batch's ``num_queries`` values a slot). ``rounds``
        is the exchanges this process ran, ``steps + 1`` (the supersteps
        and the inbox prime) unless a resumed run says otherwise: it
        prices the byte model and ``pair_rounds``; the histograms always
        cover ``steps + 1`` rounds, zero before a resume's restored
        step."""
        whist = self.whist[:steps + 1].cpu().numpy()
        rounds = steps + 1 if rounds is None else rounds
        wire = int(whist.sum())
        t = Telemetry(
            supersteps=steps,
            local_iters=self.liters.cpu().numpy(),
            changed_hist=self.hist[:steps].cpu().numpy(),
            messages_sent=int(self.sent),
            wire_hist=whist, wire_slots=wire, exchange=exchange,
            part_seconds=self.psec)
        if self.qsteps is not None:
            t.query_supersteps = self.qsteps.cpu().numpy()
        if self.chist is not None:
            t.count_hist = self.chist[:steps + 1].cpu().numpy()
        if self.phases is not None:
            K = self.phases
            phist = self.phist[:steps + 1].cpu().numpy()
            # each round's routed value slots (wire totals them, retried
            # rounds at dense geometry) plus each phase's index lanes for
            # its rounds (a slight overcount on retried rounds — dense
            # ships no ids)
            rounds_k = np.bincount(phist, minlength=K)
            scheds = [p.schedule(num_devices) for p in plan.phase_plans()]
            t.bytes_on_wire = int(
                wire * 4 * (num_queries or 1)
                + sum(scheds[k].round_index_slots() * int(rounds_k[k]) * 4
                      for k in range(K)))
            by_phase = np.transpose(self.pairs.cpu().numpy(), (1, 0, 2))
            over_k = np.transpose(self.over.cpu().numpy(), (1, 0, 2))
            t.phase_pair_slots = by_phase
            t.pair_slots = by_phase.sum(0)
            t.pair_overflow = over_k.sum(0)
            t.pair_rounds = rounds
            t.spills = int(over_k.sum())
            t.phase_hist = phist
            seg_end = np.asarray(self.seg_end)
            t.phase_switch_steps = np.unique(
                seg_end[:-1][seg_end[:-1] < steps])
            pw = np.zeros(K, np.int64)
            np.add.at(pw, phist, whist)       # round 0 (the prime) included
            t.phase_wire = pw
            t.dense_retry_steps = int(self.dsteps)
            return t
        if exchange == "megastep":
            t.bytes_on_wire = 0
        elif exchange == "tiered":
            t.bytes_on_wire = plan.schedule(num_devices).round_bytes(
                num_queries) * rounds
        else:
            t.bytes_on_wire = Telemetry.model_bytes(
                wire, num_parts, rounds, cap, exchange == "compact",
                num_queries)
        if self.pairs is not None:
            t.pair_slots = self.pairs.cpu().numpy()
            t.pair_rounds = rounds
        if self.over is not None:
            t.pair_overflow = self.over.cpu().numpy()
            t.spills = int(t.pair_overflow.sum())
        return t


def _mesh_ranks(num_parts: int, backend: str, mesh,
                device: torch.device) -> _Ranks:
    """An engine's :class:`_Ranks`, after checking its mesh: one axis, of
    the engine's device type, over the process group that device runs on
    (NCCL for ``cuda``, gloo for ``cpu``: no fallback), tiling the
    partitions."""
    if backend == "local":
        if mesh is not None:
            raise ValueError("a mesh needs backend='shard_map'")
        return _Ranks(num_parts)
    if mesh is None:
        raise ValueError("backend='shard_map' needs a mesh "
                         "(launch.mesh.make_mesh)")
    if mesh.ndim != 1:
        raise ValueError(f"the graph engine runs on a one-axis mesh, got "
                         f"{mesh.ndim} axes")
    if mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot run a "
                         f"{device.type} engine")
    group = mesh.get_group()
    check_group(group, device)
    if num_parts % mesh.size():
        raise ValueError(f"{num_parts} partitions do not tile a mesh of "
                         f"{mesh.size()} devices")
    return _Ranks(num_parts, group)


def _own_rows(gb: dict, ranks: _Ranks, num_parts: int) -> dict:
    """A passed device block cut to this rank's rows: a full one (as
    ``device_block`` uploads it) is cut here; one of ``v`` rows is taken
    as this rank's already (``device_block(rows=)``, the service's shared
    block on a mesh)."""
    n = gb["vmask"].shape[0]
    if n == num_parts:
        return {k: t[ranks.rows] for k, t in gb.items()}
    if n == ranks.v:
        return gb
    raise ValueError(f"a block of {n} partitions for a graph of "
                     f"{num_parts} on {ranks.D} ranks")


class GopherEngine:
    """Runs a program over a PartitionedGraph to global quiescence."""

    def __init__(self, pg: PartitionedGraph, program, backend: str = "local",
                 mesh=None, max_supersteps: int = 4096,
                 gb: Optional[dict] = None, exchange: str = "auto",
                 tier_plan=None, tracer=None, metrics=None,
                 validate: bool = False, device="cuda"):
        self.device = resolve_device(device)
        if backend not in ("local", "shard_map"):
            raise ValueError(f"unknown backend {backend!r}")
        if exchange not in _EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}")
        self.mesh = mesh
        self._ranks = _mesh_ranks(pg.num_parts, backend, mesh, self.device)
        if gb is not None and backend == "shard_map":
            gb = _own_rows(gb, self._ranks, pg.num_parts)
        # the exchange as asked for, before 'auto' and the plan
        # normalisation below: failover and migration rebuild engines
        # from it
        self.exchange_requested = exchange
        self.backend = backend
        if tier_plan is not None and not isinstance(
                tier_plan, (TierPlan, PhasedTierPlan)):
            raise TypeError(f"tier_plan must be a TierPlan or a "
                            f"PhasedTierPlan, got {type(tier_plan).__name__}")
        kind = getattr(program, "megastep_kind", None)
        if exchange == "auto":
            # 'local' + an eligible program -> the fused route; any other
            # program, or a one-device mesh -> the staged dense route (the
            # single-device transpose is the whole wire, so no compaction
            # pays); a mesh of several devices -> 'tiered', whose routed
            # buffers track the frontier
            if backend == "local":
                exchange = "megastep" if kind is not None else "dense"
            else:
                exchange = "dense" if self._ranks.D == 1 else "tiered"
        if exchange == "megastep" and backend != "local":
            raise ValueError(
                "the megastep exchange is a local-backend route (its flat "
                "state spans every partition); a mesh routes dense, "
                "compact, tiered or phased")
        if exchange == "megastep" and kind is None:
            raise ValueError(
                "program is not megastep-eligible (megastep_kind is None)")
        # Gopher Sentinel: validate=True checks the plan and the program's
        # semiring laws here, and records the first run of each
        # configuration (see analysis.validated_run)
        self.validate = validate
        self._sentinel_tr = None     # the recorder's view of the tracer
        self._validated: set = set()
        self.sentinel = None         # (CollectiveSummary, [Violation]) of
                                     # the last validated run
        if validate:
            from repro_torch.analysis import validate_config
            validate_config(program, exchange, tier_plan)
        # plan/mode normalisation, both directions: a PhasedTierPlan under
        # 'tiered' makes the run phased (a one-phase phased loop is the
        # tiered exchange plus the per-superstep dense retry), a plain
        # TierPlan under 'phased' wraps as a single phase
        if exchange == "tiered" and isinstance(tier_plan, PhasedTierPlan):
            exchange = "phased"
        if exchange == "tiered" and tier_plan is None:
            # the structural plan: every pair's width covers its most
            # possible slots, so it never overflows
            tier_plan = TierPlan.from_graph(pg)
        if exchange == "phased":
            if tier_plan is None:
                tier_plan = PhasedTierPlan.from_graph(pg)
            elif isinstance(tier_plan, TierPlan):
                tier_plan = PhasedTierPlan.from_tier_plan(tier_plan)
        # the megastep route keeps a plan too: a PhasedTierPlan's band
        # geometry gates the resident narrow-phase mode
        self.tier_plan = (tier_plan
                          if exchange in ("tiered", "phased", "megastep")
                          else None)
        self.pg = pg
        self.program = program
        # Q of a query-batched program (serving.batched), None otherwise:
        # its state is query-trailing (P, v_max, Q) and it runs through
        # run_queries. There is no resident mode for it (none in the JAX
        # package either): its fused route is megastep_semiring_batched
        self.num_queries = getattr(program, "num_queries", None)
        self.max_supersteps = max_supersteps
        self.exchange = exchange
        self._gb = gb                # cached device-side graph block; a
                                     # shared one lets many engines (the
                                     # service's pool) use one device copy
        self._mega_cm = None         # composed mailbox, built once per engine
        self._staged_gb = None       # block + flat adjacency, once per engine
        # Gopher Scope: None defers to the process defaults at run time, so
        # a tracer armed after the engine was built still applies
        self._tracer = tracer
        self._metrics = metrics

    @property
    def tracer(self) -> obs_trace.Tracer:
        if self._sentinel_tr is not None:
            return self._sentinel_tr
        return (self._tracer if self._tracer is not None
                else obs_trace.get_tracer())

    @property
    def metrics(self) -> obs_metrics.MetricsRegistry:
        return (self._metrics if self._metrics is not None
                else obs_metrics.default_registry())

    @functools.cached_property
    def _part_verts(self) -> tuple:
        """Each partition's live vertex count: what the ``engine.superstep``
        fault site spreads a straggler's stall over."""
        return tuple(int(x) for x in np.asarray(self.pg.vmask, bool).sum(1))

    def _graph_block(self) -> dict:
        """The device block, built once per engine unless one was passed.
        A query-batched program reads the binned adjacency, so its block
        carries it (``graph_block(binned=True)``); a passed block must
        too."""
        if self._gb is None:
            self._gb = graph_block(self.pg, self.device,
                                   binned=self.num_queries is not None,
                                   rows=self._ranks.rows)
        if self.num_queries is not None and not set(_BINNED) <= set(
                self._gb):
            raise ValueError(
                "a query-batched program reads the binned adjacency: pass "
                "a block uploaded by device_block(host_gb, device, "
                "binned=True)")
        return self._gb

    def _gb_for_run(self):
        """The graph block and its composed mailbox
        (``kernels.megastep.compose_mailbox``, with the two-bin adjacency
        for a query batch), both built once per engine and shared by every
        run."""
        gb = self._graph_block()
        if self._mega_cm is None:
            self._mega_cm = mega.compose_mailbox(
                gb, adjacency="full" if self.num_queries is None
                else "binned")
        return gb, self._mega_cm

    def _gb_for_staged(self) -> dict:
        """The graph block with the flat adjacency the staged sweeps read
        (``gb["adj"]``: ``kernels.flat.flat_adjacency``, or for a query
        batch ``flat_binned_adjacency``), built once per engine."""
        if self._staged_gb is None:
            gb = self._graph_block()
            self._staged_gb = {**gb, "adj": (
                flat.flat_adjacency(gb) if self.num_queries is None
                else flat.flat_binned_adjacency(gb))}
        return self._staged_gb

    def run(self, checkpointer=None, checkpoint_every: int = 0,
            resume: bool = False, extra: Optional[dict] = None,
            superstep_budget: Optional[int] = None):
        """Run to quiescence. Returns (state dict of (P, ...) numpy arrays,
        Telemetry).

        ``extra`` carries per-run (P, v_max) graph-block entries as numpy
        arrays — ``x0`` (float32) and ``frontier0`` (bool) for an
        incremental resume (``SemiringProgram(resume=True)``). They are
        copied onto the engine's device and layered over the cached block
        for this run only, so the cached block, its composed mailbox and the
        staged flat adjacency stay valid for the next run.

        With a ``training.checkpoint.Checkpointer`` and
        ``checkpoint_every=N`` the run snapshots (state, inbox) every N
        supersteps and, with ``resume=True``, restarts from the newest
        snapshot that passes its checksums (see :meth:`_run_checkpointed`).
        ``superstep_budget`` (checkpointed runs only) caps THIS call at that
        many supersteps and snapshots at the cut, so a supervisor (Gopher
        Balance's ``run_with_rebalance``) can interleave decisions between
        segments of one logical run and resume exactly where it stopped.

        With an enabled tracer (see the module docstring) the run records
        its span tree; a traced run does not take a checkpointer."""
        if self.num_queries is not None:
            raise ValueError("a query-batched program runs through "
                             "run_queries")
        if checkpointer is not None and checkpoint_every > 0:
            if self.tracer.enabled:
                raise ValueError("a traced run does not compose with "
                                 "checkpointing")
            return self._checked("checkpointed", lambda: (
                self._run_checkpointed(checkpointer, checkpoint_every,
                                       resume, extra=extra,
                                       superstep_budget=superstep_budget)))
        if superstep_budget is not None:
            raise ValueError("superstep_budget requires a checkpointed run")
        return self._checked("run", lambda: self._run(extra))

    def run_queries(self, extra: Optional[dict] = None):
        """Run a query-batched program (``program.num_queries`` = Q) to the
        quiescence of ALL its queries in ONE BSP run, on any exchange.

        ``extra`` carries the per-request inputs as (P, v_max, Q) numpy
        arrays (``qinit``, ``qseed``, or ``qx0``/``qfrontier0`` for a
        resume), layered over the cached block for this run only, so the
        block, its composed mailbox and the engine stay valid for the next
        batch. Returns (state of (P, v_max, Q) numpy arrays, query-trailing,
        and Telemetry); ``telemetry.query_supersteps[q]`` is the superstep
        after which query q last changed. Queries share the supersteps and
        the sweeps (the batch runs while any lane moves) but not their
        messages: a quiesced lane sends nothing."""
        if self.num_queries is None:
            raise ValueError("run_queries requires a query-batched program")
        return self._checked("run", lambda: self._run(extra))

    def _checked(self, loop: str, fn):
        """``fn()``, the run; on a validating engine the first run of each
        configuration goes through Gopher Sentinel's recorder
        (``analysis.validated_run``)."""
        if not self.validate:
            return fn()
        from repro_torch.analysis import validated_run
        return validated_run(self, loop, fn)

    def _run(self, extra: Optional[dict]):
        tr = self.tracer
        with tr.profile_ctx(self.device):
            with tr.span("run", exchange=self.exchange, backend=self.backend,
                         queries=self.num_queries or 0) as rs:
                if self.exchange == "megastep":
                    state, steps, tally = self._run_megastep(extra, tr)
                else:
                    state, steps, tally = self._run_batched(extra, tr=tr)
                if tr.enabled:
                    rs.set(supersteps=steps,
                           wire_slots=int(tally.whist[:steps + 1].sum()))
        state, t = self._finish(state, steps, tally, extra)
        self._record_run_metrics(t)
        return state, t

    # the dtypes of the per-run extra entries (x0/frontier0 of a resume,
    # the query arrays of a batch)
    _EXTRA_DTYPES = {"x0": np.float32, "frontier0": bool,
                     "qinit": np.float32, "qseed": np.float32,
                     "qx0": np.float32, "qfrontier0": bool}

    def _layer(self, gb: dict, extra: Optional[dict]) -> dict:
        """``gb`` with the run's ``extra`` entries over it (this rank's rows
        of each (P, ...) array on 'shard_map'), as tensors on the engine's
        device (copies: no run writes into the caller's arrays)."""
        if not extra:
            return gb
        out = dict(gb)
        for k, v in extra.items():
            v = np.asarray(v)[self._ranks.rows]
            dtype = self._EXTRA_DTYPES.get(k, v.dtype)
            out[k] = torch.tensor(v.astype(dtype, copy=False),
                                  device=self.device)
        return out

    def _finish(self, state, steps: int, tally: "_Tally",
                extra: Optional[dict]):
        """Close out a run. On the tiered route a pair whose active slots
        exceeded its tier width had messages TRUNCATED, so the results
        cannot be trusted: the repair is a rerun on the dense route
        (bit-identical by construction) plus an escalation of the
        overflowed pairs in ``self.tier_plan``, so the next run has the
        width this pair just showed it needs. A phased run never reruns —
        an overflowing superstep already routed dense — so it only
        escalates the phases that spilled. The rerun layers the aborted
        attempt's ``extra`` (a resume's ``x0`` and ``frontier0``) over the
        block as the attempt did, and runs untraced inside a
        ``dense-retry`` span.

        On 'shard_map' every rank gathers the state and the per-partition
        telemetry first, so each decides the same and returns the same."""
        P, cap, Q = self.pg.num_parts, self.pg.mailbox_cap, self.num_queries
        D = self._ranks.D
        tally.gather(self._ranks)
        t = tally.telemetry(steps, self.exchange, P, cap, self.tier_plan, Q,
                            num_devices=D)
        old = self.tier_plan
        if t.spills and self.exchange == "phased":
            over_k = np.transpose(tally.over.cpu().numpy(), (1, 0, 2))
            for k in range(old.num_phases):
                if over_k[k].any():
                    self.tier_plan = self.tier_plan.escalate_phase(
                        k, over_k[k] > 0)
            t.escalations = self.tier_plan.escalations_from(old)
        elif t.spills and self.exchange == "tiered":
            self.tier_plan = old.escalate(t.pair_overflow > 0)
            with self.tracer.span("dense-retry", spills=t.spills):
                state, steps2, tally2 = self._run_batched(extra,
                                                          mode="dense")
            tally2.gather(self._ranks)
            t2 = tally2.telemetry(steps2, "dense", P, cap, num_queries=Q)
            t2.exchange = "tiered"
            t2.retried = True
            t2.spills = t.spills
            t2.escalations = self.tier_plan.escalations_from(old)
            t2.pair_overflow = t.pair_overflow
            # the profile observation comes from the ABORTED tiered
            # attempt, and pair_rounds records ITS round count
            t2.pair_slots = t.pair_slots
            t2.pair_rounds = steps + 1
            # the aborted attempt's geometry crossed the wire too
            t2.wire_slots += t.wire_slots
            t2.bytes_on_wire += old.schedule(D).round_bytes(Q) * (steps + 1)
            t = t2
        return self._host_state(state), t

    def _host_state(self, state: dict) -> dict:
        """The run's state as (P, ...) numpy arrays (every rank's rows on
        'shard_map')."""
        return {k: self._ranks.gather(v).cpu().numpy()
                for k, v in state.items()}

    def _record_run_metrics(self, t: Telemetry) -> None:
        """Gopher Scope: fold a finished run's telemetry into the metrics
        registry, labeled {exchange, backend}. It reads only the host
        values the run already brought back, so it runs after every run,
        traced or not, at no device cost."""
        m = self.metrics
        lab = {"exchange": t.exchange or self.exchange,
               "backend": self.backend}
        m.counter("engine_runs_total", lab).inc()
        m.counter("engine_supersteps_total", lab).inc(t.supersteps)
        m.counter("engine_messages_sent_total", lab).inc(t.messages_sent)
        m.counter("engine_wire_slots_total", lab).inc(t.wire_slots)
        m.counter("engine_wire_bytes_total", lab).inc(t.bytes_on_wire)
        m.counter("engine_spills_total", lab).inc(t.spills)
        m.counter("engine_escalations_total", lab).inc(t.escalations)
        if t.retried:
            m.counter("engine_dense_retries_total", lab).inc()
        m.counter("engine_dense_retry_steps_total",
                  lab).inc(t.dense_retry_steps)
        m.histogram("engine_run_supersteps", lab).observe(t.supersteps)
        m.gauge("engine_partition_imbalance", lab).set(
            obs_skew.imbalance_score(t.local_iters))

    @contextlib.contextmanager
    def _superstep(self, tr: obs_trace.Tracer, tally: "_Tally", step: int,
                   clocked: bool = False):
        """A superstep's host-side frame: its ``superstep`` span and, on a
        clocked loop (the traced and checkpointed ones), the
        ``engine.superstep`` fault site before the work and the clock that
        ``tally.charge`` spreads into ``part_seconds`` after the halt
        vote's read. Yields the span."""
        clocked = clocked or tr.enabled
        with tr.span("superstep", step=step) as ss:
            if not clocked:
                yield ss
                return
            t0 = time.perf_counter()
            eff = _faults.fire("engine.superstep", step=step,
                               backend=self.backend,
                               part_verts=self._part_verts,
                               num_devices=self._ranks.D)
            yield ss
            tally.charge(time.perf_counter() - t0, eff, self.pg.num_parts,
                         self._ranks.rows.start)

    # ---------------- the staged route ----------------

    def make_exchange(self, gb: dict, phase: Optional[int] = None,
                      mode: Optional[str] = None):
        """The mailbox half of a superstep: ``exchange(state) -> (inbox,
        nsent, wire, extras)``. Split out so the BSP loop can PRIME the first
        inbox from the initial state: without it superstep 0 would see an
        empty inbox, which for PageRank drops all remote mass from the first
        iteration. ``mode`` overrides the engine's exchange (the tiered
        route's dense rerun); ``phase`` picks the phased plan's table.

        'dense'    every (src, dst) pair ships its full cap-slot row;
                   wire = P·P·cap a round, the routed buffer itself.
        'compact'  each pair row is packed to the prefix of its active
                   slots (kernel K5) and rebuilt at the receiver by a
                   gather, so the inbox is bit-identical to 'dense';
                   wire = Σ counts, the modeled count-prefixed payload.
        'tiered'   each pair row is packed and TRUNCATED to its tier width
                   (kernel K5 with the plan's limits, which flags the rows
                   that overflowed) and routed by ``messages.route_tiered``;
                   wire = the schedule's round slots, static per plan.
        'phased'   'tiered' at one phase's table, except that a superstep
                   whose pack overflowed anywhere routes the dense rows
                   instead: both routes are computed and one is selected
                   on the device, so the choice costs no host read.

        ``extras`` is {} on 'dense', {'pairs': (P, P) counts} on 'compact',
        plus {'over': (P, P) overflow flags} on 'tiered', plus {'dstep':
        0/1 dense-retry flag} on 'phased' — the per-pair observations the
        telemetry sums.

        A query batch (``num_queries`` Q) exchanges query-trailing values:
        every slot carries its Q-vector, (P, P, cap·Q) on the wire, and a
        slot is active when any lane sends (``messages.*_batched``).
        """
        pack, route = self.make_exchange_stages(gb, phase=phase, mode=mode)

        def exchange(state):
            payload, nsent, wire, extras = pack(state)
            inbox, rex = route(payload)
            if rex:
                wire = rex.get("wire", wire)
                extras = dict(extras, **{k: v for k, v in rex.items()
                                         if k != "wire"})
            return inbox, nsent, wire, extras

        return exchange

    def make_exchange_stages(self, gb: dict, phase: Optional[int] = None,
                             mode: Optional[str] = None):
        """The exchange split at its network boundary: ``pack(state) ->
        (payload, nsent, wire, extras)`` builds the messages and the
        payload that would cross the wire; ``route(payload) -> (inbox,
        route_extras)`` routes it to the receivers and combines their
        inboxes. ``route_extras`` is {} except on 'phased': {'wire': the
        round's routed slots, 'dstep': the 0/1 dense-retry flag}.

        ``nsent`` and ``wire`` are this process's counts (tensors): on
        'shard_map' a rank's, summed over the mesh by the loop's one
        all_reduce — 'dense' v·P·cap a rank, 'tiered' the schedule's
        ``device_round_slots()`` — as the JAX package counts them. The
        rows are a rank's v partitions; the routes move them over the
        mesh's group."""
        prog = self.program
        P, cap, v_max = self.pg.num_parts, self.pg.mailbox_cap, self.pg.v_max
        Q = self.num_queries
        ranks = self._ranks
        v = ranks.v
        combine = prog.combine
        mode = mode or self.exchange
        if mode not in ("dense", "compact", "tiered", "phased"):
            raise ValueError(f"the {mode!r} route has no staged exchange")
        dev = gb["ob_inv"].device
        gather = (msg.build_outbox_gather if Q is None
                  else msg.build_outbox_gather_batched)

        def phys(x):
            if ranks.group is None:
                return msg.route_local(x)
            return msg.route_shard_map(x, ranks.group)

        def finish(iv):
            if Q is None:
                return msg.combine_inbox_gather(
                    iv, gb["ib_lo"], gb["ib_hub_idx"], gb["ib_hub"], v_max,
                    combine)
            return msg.combine_inbox_gather_batched(
                iv, gb["ib_lo"], gb["ib_hub_idx"], gb["ib_hub"], v_max, cap,
                combine)

        if mode == "dense":
            wire = torch.tensor(v * P * cap, device=dev)

            def pack(state):
                vals, send = prog.messages(state, gb)
                slot_vals = gather(vals, send, gb["ob_inv"], P, cap, combine)
                return (slot_vals,), send.sum(), wire, {}

            def route(payload):
                (slot_vals,) = payload
                return finish(phys(slot_vals)), {}
            return pack, route

        if mode == "compact":
            build = (msg.build_outbox_compact if Q is None
                     else msg.build_outbox_compact_batched)
            unpack = (msg.unpack_slots if Q is None
                      else msg.unpack_slots_batched)

            def pack(state):
                vals, send = prog.messages(state, gb)
                pvals, pinv, counts = build(vals, send, gb["ob_inv"], P, cap,
                                            combine)
                # the packed prefixes and their slot maps travel; counts is
                # the header a real transport would read each length from
                return ((pvals, pinv), send.sum(), counts.sum(),
                        {"pairs": counts})

            def route(payload):
                pvals, pinv = payload
                return finish(unpack(phys(pvals), phys(pinv), combine)), {}
            return pack, route

        # tiered / phased
        plan = self.tier_plan
        if mode == "phased":
            if phase is None:
                raise ValueError("the phased exchange needs a phase index")
            plan = plan.phase_plans()[phase]
        if plan.num_parts != P or plan.cap != cap:
            raise ValueError("the tier plan was built for another graph "
                             "geometry")
        sched = plan.schedule(ranks.D)
        tables = msg.tiered_tables(sched, dev, ranks.me)
        limits = torch.from_numpy(
            plan.limits()[ranks.rows].reshape(-1)).to(dev)
        ident = flat.COMBINE_IDENTITY[combine]
        slots = sched.device_round_slots()
        wire = torch.tensor(slots, device=dev)
        R = v * P
        # a slot's values: one, or a query batch's Q-vector
        tail = () if Q is None else (Q,)

        def pack(state):
            vals, send = prog.messages(state, gb)
            slot_vals = gather(vals, send, gb["ob_inv"], P, cap,
                               combine).reshape(v, P, cap, *tail)
            act = msg.active_slots(send, gb["ob_inv"], P, cap)
            # the pack truncates each row to its tier width and flags the
            # rows whose active slots did not fit
            pvals, sids, _, counts, over = ops.outbox_pack(
                slot_vals.reshape(R, cap, *tail), act.reshape(R, cap), limits,
                ident)
            return ((slot_vals, pvals, sids, over), send.sum(), wire,
                    {"pairs": counts.reshape(v, P),
                     "over": over.reshape(v, P)})

        def tier_route(slot_vals, pvals, sids):
            return msg.route_tiered(slot_vals, pvals.reshape(v, P, cap, *tail),
                                    sids.reshape(v, P, cap), sched, combine,
                                    group=ranks.group, tables=tables)

        def route(payload):
            slot_vals, pvals, sids, over = payload
            if mode == "tiered":
                iv = tier_route(slot_vals, pvals, sids)
                return finish(iv.reshape(v, P, -1)), {}
            retry = (over > 0).any()
            if ranks.group is None:
                # on one device the dense route is a transpose, so both are
                # computed and the overflow flag selects on the device
                iv = torch.where(retry, msg.route_local(slot_vals),
                                 tier_route(slot_vals, pvals, sids))
            else:
                # over a mesh every rank must run the same collectives: the
                # flag is summed over the ranks and read, and ONE route runs
                retry = ranks.sum(retry.to(torch.int64)) > 0
                iv = (phys(slot_vals) if bool(retry)
                      else tier_route(slot_vals, pvals, sids))
            dstep = retry.int()
            return finish(iv.reshape(v, P, -1)), {
                "wire": wire + dstep * (R * cap - slots), "dstep": dstep}

        return pack, route

    def _run_batched(self, extra: Optional[dict], mode: Optional[str] = None,
                     tr: obs_trace.Tracer = obs_trace.NOOP):
        """The staged BSP loop: prime the inbox from the initial state, then
        sweep (the program's superstep) + pack + route until no partition
        changed. ``mode`` overrides the engine's exchange (the tiered
        route's dense rerun); ``extra`` layers over the cached block as in
        :meth:`run`.

        On the phased route (Gopher Phases) the loop runs as K SEGMENTS,
        one per phase of the PhasedTierPlan, each exchanging at its phase's
        tier table; the (state, inbox, halt vote) carry flows straight
        across segment boundaries. A segment ends when

          * the predicted boundary arrives: boundaries are in ROUND units
            (superstep s ships round s + 1), so the segment goes on while
            round step + 1 is below ``boundaries[k]``;
          * the DEMOTION trigger fires: the observed per-pair counts fit
            under the NEXT phase's limits for ``DEMOTE_STREAK`` supersteps
            in a row (the frontier contracted ahead of prediction);
          * the global halt vote lands (every later segment then runs no
            superstep).

        The superstep's counters [#partitions changed, nsent, wire, Σ
        counts, the demotion streak's violations (, the lanes changed)] are
        stacked into one vector — on 'shard_map' summed over the ranks by
        one all_reduce — so a superstep still reads the host once. An
        enabled ``tr`` records the spans, counters, fault sites and
        ``part_seconds`` of the module docstring, reading the superstep's
        counts for its span."""
        mode = mode or self.exchange
        phased = mode == "phased"
        prog = self.program
        ranks = self._ranks
        max_s = self.max_supersteps
        K = self.tier_plan.num_phases if phased else 1
        stages = []
        for k in range(K):
            # the plan span charges the block's and the stages' building
            # to the phase it belongs to
            with tr.span("plan", phase=k, exchange=mode,
                         backend=self.backend):
                if k == 0:
                    gb = self._layer(self._gb_for_staged(), extra)
                stages.append(self.make_exchange_stages(
                    gb, phase=k if phased else None, mode=mode))
        tr.count("stage_builds", K)

        with tr.span("init"):
            state = tr.sync(prog.init(gb))
        with tr.span("prime") as sp:
            pack, route = stages[0]
            payload, nsent0, wire0, ex0 = pack(state)
            inbox, rex0 = route(payload)
            tr.sync(inbox)
            pairs0 = ex0.get("pairs")
            nsent0, wire0, cnt0 = ranks.sum(_stats(
                nsent0, rex0.get("wire", wire0),
                nsent0.new_zeros(()) if pairs0 is None else pairs0.sum()))
            tally = _Tally(ranks.v, max_s, nsent0, wire0, pairs0,
                           self.device, over0=ex0.get("over"),
                           phases=K if phased else None,
                           dstep0=rex0.get("dstep"), queries=self.num_queries,
                           cnt0=cnt0)
            if tr.enabled:
                sp.set(wire=int(wire0), nsent=int(nsent0))
        tr.count("dispatches", 3)
        if tr.enabled:
            tally.psec = np.zeros(ranks.v, np.float64)

        step, done = 0, False
        for k in range(K):
            pack, route = stages[k]
            last = k == K - 1
            nlim = (None if last else torch.from_numpy(
                self.tier_plan.phase_plans()[k + 1].limits()[ranks.rows]
            ).to(self.device))
            bound = -1 if last else int(self.tier_plan.boundaries[k])
            streak = 0
            with tr.span("phase", index=k, boundary=bound):
                while (not done and step < max_s
                       and (last or (step + 1 < bound
                                     and streak < DEMOTE_STREAK))):
                    with self._superstep(tr, tally, step) as ss:
                        with tr.span("sweep"):
                            state, changed, liters = prog.superstep(
                                state, inbox, gb, step, reduce=ranks.sum)
                            tr.sync(changed)
                        with tr.span("pack"):
                            payload, nsent, wire, ex = pack(state)
                            tr.sync(payload)
                        if tr.enabled:
                            _faults.fire("exchange.route", step=step + 1,
                                         backend=self.backend)
                        with tr.span("exchange"):
                            inbox, rex = route(payload)
                            tr.sync(inbox)
                        with tr.span("halt-vote"):
                            nchanged, changed_q = _halt_vote(changed)
                            pairs = ex.get("pairs")
                            zero = nsent.new_zeros(())
                            stats = ranks.sum(_stats(
                                nchanged, nsent, rex.get("wire", wire),
                                zero if pairs is None else pairs.sum(),
                                zero if nlim is None else (pairs > nlim).sum(),
                                *(() if changed_q is None else (changed_q,))))
                            tally.fold(step, stats[0], liters, stats[1],
                                       stats[2], pairs, over=ex.get("over"),
                                       phase=k if phased else None,
                                       dstep=rex.get("dstep"),
                                       changed_q=(None if changed_q is None
                                                  else stats[5:] > 0),
                                       cnt=stats[3])
                            # the superstep's one host read: the halt vote,
                            # with the demotion streak's violations
                            nch, nviol = stats[[0, 4]].tolist()
                            if tr.enabled:
                                ss.set(changed=nch, wire=int(stats[2]),
                                       nsent=int(stats[1]))
                        tr.count("dispatches", 3)
                    step += 1
                    done = nch == 0
                    # a dense-retried superstep's counts are real demand,
                    # so they count like any other round
                    streak = streak + 1 if nviol == 0 else 0
            if phased:
                tally.seg_end[k] = step
        return state, step, tally

    # ---------------- the checkpointed route ----------------

    def _run_checkpointed(self, ck, every: int, resume: bool,
                          extra: Optional[dict] = None,
                          superstep_budget: Optional[int] = None):
        """Checkpointable BSP: the staged loop stepped on the host and split
        at the network boundary (the program's superstep, then ``pack``,
        then ``route``, from :meth:`make_exchange_stages`), snapshotting
        ``{"state", "inbox"}`` at superstep ``step`` every ``every``
        supersteps, at a budget's cut, at quiescence and at
        ``max_supersteps``. Megastep, tiered and phased engines run it on
        the compact staged loop, as the JAX package does: same results
        (bit-identical for idempotent ⊕), and the fused route carries no
        staged (state, inbox) pair to snapshot. The run reuses the engine's
        cached block; ``extra`` layers over it as in :meth:`run`.

        With ``resume`` the run restores the newest snapshot that passes
        checksum verification (``Checkpointer.latest_good_step``: a corrupt
        latest snapshot falls back to the previous good one; none is a cold
        start). The telemetry then covers this process's supersteps only:
        the histograms' slots before the restored step are zero, and the
        byte model counts the rounds run here (no prime).

        Fault sites fire on the host, between launches: ``exchange.route``
        before the prime's route and each superstep's, ``engine.superstep``
        before each sweep. ``Telemetry.part_seconds`` times each superstep
        from before its fault site to after the halt vote's one host read,
        charges injected stalls to their partition and spreads the rest
        evenly.

        On 'shard_map' a superstep's counters are one all_reduce before its
        host read, as in :meth:`_run_batched`; a snapshot holds the full
        (P, ...) arrays, gathered on every rank and written by rank 0
        (``Checkpointer.save(group=)``), and a resume restores each rank's
        own rows."""
        if self.exchange in ("megastep", "tiered", "phased"):
            prev = self.exchange
            self.exchange = "compact"
            try:
                return self._run_checkpointed(
                    ck, every, resume, extra,
                    superstep_budget=superstep_budget)
            finally:
                self.exchange = prev
        gb = self._layer(self._gb_for_staged(), extra)
        prog = self.program
        P = self.pg.num_parts
        ranks = self._ranks
        max_s = self.max_supersteps
        pack, route = self.make_exchange_stages(gb)
        compact = self.exchange == "compact"
        # no tracer rides this loop; a validated run's recorder reads its
        # stages' spans
        tr = (obs_trace.NOOP if self._sentinel_tr is None
              else self._sentinel_tr)

        good = ck.latest_good_step() if resume else None
        if good is not None:
            # the restore reads only the structure: its leaves' paths
            snap_like = {"state": prog.init(gb), "inbox": torch.empty(0)}
            snap, step = ck.restore(snap_like, step=good, device=self.device,
                                    rows=ranks.rows)
            state, inbox = snap["state"], snap["inbox"]
            step = int(step)
            pairs0 = (torch.zeros((ranks.v, P), dtype=torch.int32,
                                  device=self.device) if compact else None)
            tally = _Tally(ranks.v, max_s, 0, 0, pairs0, self.device)
            primed = False
        else:
            state = prog.init(gb)
            payload, nsent0, wire0, ex0 = pack(state)
            _faults.fire("exchange.route", step=0, backend=self.backend)
            inbox, rex0 = route(payload)
            pairs0 = ex0.get("pairs")
            nsent0, wire0, cnt0 = ranks.sum(_stats(
                nsent0, rex0.get("wire", wire0),
                nsent0.new_zeros(()) if pairs0 is None else pairs0.sum()))
            tally = _Tally(ranks.v, max_s, nsent0, wire0, pairs0, self.device,
                           cnt0=cnt0)
            step = 0
            primed = True

        # Gopher Balance's time channel
        tally.psec = np.zeros(ranks.v, np.float64)
        start = step
        budget = superstep_budget
        done = False
        while not done and step < max_s and (budget is None
                                             or step - start < budget):
            with self._superstep(tr, tally, step, clocked=True):
                with tr.span("sweep"):
                    state, changed, liters = prog.superstep(
                        state, inbox, gb, step, reduce=ranks.sum)
                with tr.span("pack"):
                    payload, nsent, wire, ex = pack(state)
                _faults.fire("exchange.route", step=step + 1,
                             backend=self.backend)
                with tr.span("exchange"):
                    inbox, rex = route(payload)
                with tr.span("halt-vote"):
                    nchanged, _ = _halt_vote(changed)
                    pairs = ex.get("pairs")
                    stats = ranks.sum(_stats(
                        nchanged, nsent, rex.get("wire", wire),
                        nsent.new_zeros(()) if pairs is None
                        else pairs.sum()))
                    tally.fold(step, stats[0], liters, stats[1], stats[2],
                               pairs, cnt=stats[3])
                    nch = int(stats[0])      # the superstep's one host read
            step += 1
            done = nch == 0
            cut = budget is not None and step - start >= budget
            if done or cut or (step - start) % every == 0 or step >= max_s:
                with tr.span("checkpoint"):
                    ck.save({"state": {k: ranks.gather(v)
                                       for k, v in state.items()},
                             "inbox": ranks.gather(inbox)}, step,
                            group=ranks.group)
        # after a resume the wire counters cover only THIS process's
        # exchanges, so the byte model counts the same rounds (no prime
        # ran, and the supersteps before the resume shipped elsewhere)
        rounds = step - start + (1 if primed else 0)
        tally.gather(ranks)
        t = tally.telemetry(step, self.exchange, P, self.pg.mailbox_cap,
                            rounds=rounds)
        self._record_run_metrics(t)
        return self._host_state(state), t

    # ---------------- the fused route ----------------

    def _run_megastep(self, extra: Optional[dict],
                      tr: obs_trace.Tracer = obs_trace.NOOP):
        """The BSP loop with the whole superstep fused into one call of
        ``kernels.megastep`` (K3; K1 for PageRank; plain torch ops for a
        query batch). Delivery happens at the TOP of each superstep from
        the previous round's send set, so the initial state's messages need
        no separate prime. Telemetry mirrors the JAX fused route:
        ``pairs``/``count_hist`` are the logical frontier observation and
        ``wire_*`` are zero — nothing ships through buffers.

        With a PhasedTierPlan whose band suffix fits the resident gate
        (scalar semiring programs), the rest of an untraced run is in
        RESIDENT mode from superstep ``enter`` on: relaxation rounds of one
        delivery and one sweep each, which reach the same bitwise fixpoint.
        On a CUDA tensor they are ONE launch of K4, whose telemetry is
        totals only (no per-round histogram entries), as on the TPU; on a
        CPU tensor every round is folded (see the module docstring). A
        traced run stays on K3 to the end."""
        prog = self.program
        kind = prog.megastep_kind
        max_s = self.max_supersteps
        with tr.span("plan", phase=0, exchange="megastep",
                     backend=self.backend):
            gb, cm = self._gb_for_run()
            gb = self._layer(gb, extra)
        tr.count("stage_builds", 1)
        P, v_max, Q = cm["num_parts"], cm["v_max"], self.num_queries
        tail = () if Q is None else (Q,)

        with tr.span("init"):
            state0 = prog.init(gb)
            if kind == "pagerank":
                r = state0["r"].reshape(-1)
                deg = gb["out_degree"].to(torch.float32).reshape(-1)
                telep = (prog.teleport_fn(gb).reshape(-1)
                         if prog.teleport_fn is not None
                         else 1.0 / prog.n_global)
                ones = torch.ones(P, dtype=torch.int32, device=self.device)
                delta = torch.tensor(float("inf"), device=self.device)
                pairs0, nsent0 = mega.round_stats(None, cm)
            else:
                x, ch, fr = (state0[k].reshape((-1,) + tail).contiguous()
                             for k in ("x", "changed_v", "frontier"))
                pairs0, nsent0 = mega.round_stats(ch, cm)
            tally = _Tally(P, max_s, nsent0, 0, pairs0, self.device,
                           queries=Q)
            tr.sync(pairs0)
        with tr.span("prime") as sp:
            # no routed prime on the fused route: round 0's sends are
            # delivered by the first superstep, so the span records only
            # the logical observation
            if tr.enabled:
                sp.set(wire=0, nsent=int(nsent0))
        tr.count("dispatches", 2)
        if tr.enabled:
            tally.psec = np.zeros(P, np.float64)

        def loop(step: int, stop: int, launch, vote):
            """Supersteps from ``step`` until the halt vote or ``stop``:
            ``launch(step)`` runs one (returning its (P,) local iterations),
            ``vote()`` observes its round: (#partitions changed, the (Q,)
            lanes changed or None, pairs, nsent)."""
            done = False
            while not done and step < stop:
                with self._superstep(tr, tally, step) as ss:
                    with tr.span("megastep"):
                        li = tr.sync(launch(step))
                    with tr.span("halt-vote"):
                        nchanged, changed_q, pairs, nsent = vote()
                        tally.fold(step, nchanged, li, nsent, 0, pairs,
                                   changed_q=changed_q)
                        nch = int(nchanged)  # the superstep's one host read
                        if tr.enabled:
                            ss.set(changed=nch, wire=0, nsent=int(nsent))
                    tr.count("dispatches", 1)
                step += 1
                done = nch == 0
            return step, done

        with tr.span("phase", index=0, boundary=-1):
            if kind == "pagerank":
                changed = True

                def launch(step):
                    nonlocal r, delta, changed
                    r, delta, changed = mega.megastep_pagerank(
                        r, cm, deg, telep, prog.n_global, prog.damping,
                        prog.num_iters, step)
                    return ones

                def vote():
                    # PageRank sends unconditionally: every round's
                    # observation is the full slot occupancy, the final
                    # round's included
                    return ((P if changed else 0, None)
                            + mega.round_stats(None, cm))

                step, _ = loop(0, max_s, launch, vote)
                return ({"r": r.reshape(P, v_max),
                         "delta": delta.expand(P)}, step, tally)

            mk = (mega.megastep_semiring if Q is None
                  else mega.megastep_semiring_batched)

            def launch(step):
                nonlocal x, ch, fr
                x, ch, fr, li = mk(x, ch, fr, cm, prog.semiring,
                                   unroll=prog.fixpoint_unroll)
                return li

            def vote():
                nchanged, changed_q = _halt_vote(
                    ch.reshape((P, v_max) + tail).any(dim=1))
                return (nchanged, changed_q) + mega.round_stats(ch, cm)

            # the resident gate: the earliest superstep from which every
            # remaining phase band's predicted round geometry fits (None
            # without a PhasedTierPlan, for a query batch, on a traced run,
            # or when no suffix fits)
            enter = None
            if (isinstance(self.tier_plan, PhasedTierPlan) and Q is None
                    and not tr.enabled):
                rb = [p.schedule(1).round_bytes(None)
                      for p in self.tier_plan.phase_plans()]
                enter = mega.resident_enter_round(rb,
                                                  self.tier_plan.boundaries)
            step, done = loop(0, max_s if enter is None
                              else min(enter, max_s), launch, vote)
            if not done and step < max_s:
                if x.is_cuda:
                    # one K4 launch for the rest of the run; telemetry is
                    # totals for these rounds
                    x, ch, fr, it, li = mega.resident_megastep(
                        x, ch, fr, cm, prog.semiring, max_s - step)
                    pairs, nsent = mega.round_stats(ch, cm)
                    tally.liters += li
                    tally.sent += nsent
                    tally.pairs += pairs
                    # an entered resident stretch is at least one
                    # superstep, as the folded loop's first round is
                    step += max(int(it), 1)
                else:
                    def launch(step):
                        nonlocal x, ch, fr
                        x, ch, fr, ap = mega.resident_step_semiring(
                            x, ch, fr, cm, prog.semiring)
                        return ap.int()
                    step, _ = loop(step, max_s, launch, vote)
        state = {k: v.reshape((P, v_max) + tail) for k, v in
                 zip(("x", "changed_v", "frontier"), (x, ch, fr))}
        return state, step, tally


def _halt_vote(changed):
    """A superstep's halt vote from its per-partition ``changed``: (P,) for
    a single query, (P, Q) for a batch. Returns (how many partitions
    changed, the (Q,) lanes that changed anywhere or None)."""
    if changed.dim() == 1:
        return changed.sum(), None
    return changed.any(dim=1).sum(), changed.any(dim=0)
