"""Gopher: the sub-graph centric BSP execution engine, on one device.

The port of the JAX package's ``core/engine.py`` for the ``local`` backend:

  paper                               here
  -----                               ----
  worker per machine                  one partition of the (P, v_max)
                                      state; all P run as one batch
  thread pool over sub-graphs         the local-fixpoint sweep over the
                                      flat (P·v_max,) state
  message flush at the barrier        the mailbox exchange between
                                      supersteps
  manager sync/resume/terminate       one host read of the halt vote per
                                      superstep

Three wire disciplines (``exchange=``):
  'megastep'  the whole superstep — mailbox delivery, inbox combine, masked
              local fixpoint — fused into one call of ``kernels.megastep``
              (kernel K3) over flat state; the route 'auto' takes for every
              program with a ``megastep_kind``
  'dense'     the staged route: the program's superstep (its sweeps are
              kernels K1/K2), then the exchange — pack every pair's full
              cap-slot row, route by transpose, gather-combine the inbox.
              The parity oracle; 'auto' takes it for the other programs
              (vertex-centric and bounded fixpoints, PageRank with ``tol``)
  'compact'   the staged route with each pair row packed to the prefix of
              its active slots (kernel K5) and rebuilt at the receiver:
              bit-identical to 'dense', with a wire that tracks the frontier

Each BSP loop is a Python loop over supersteps; the telemetry stays on the
device until the run ends, and the halt vote (how many partitions changed)
is the only value the host reads per superstep. The fixpoint inside a
staged superstep reads one "any frontier left" flag per sweep.

Everything else of the JAX engine raises ``NotImplementedError`` naming the
ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import messages as msg
from repro_torch.core.blocks import graph_block
from repro_torch.gofs.formats import PartitionedGraph
from repro_torch.kernels import flat
from repro_torch.kernels import megastep as mega

_EXCHANGES = ("auto", "compact", "dense", "tiered", "phased", "megastep")
_NOT_YET = {
    "tiered": "ROADMAP A3 (tiers, phased and resident)",
    "phased": "ROADMAP A3 (tiers, phased and resident)",
}


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
    megastep, dense and compact routes)."""
    supersteps: int
    local_iters: np.ndarray        # (P,) cumulative sweep iterations
    changed_hist: np.ndarray       # (supersteps,) #partitions changed
    messages_sent: int
    # round-indexed (length supersteps + 1): round 0 is the inbox prime (the
    # initial state's messages), round s + 1 the exchange after superstep s.
    #   'dense'    PHYSICAL: the P²·cap buffer every round
    #   'compact'  MODELED payload: Σ packed counts per round
    #   'megastep' zeros: nothing is routed
    wire_hist: Optional[np.ndarray] = None
    wire_slots: int = 0            # Σ wire_hist
    bytes_on_wire: int = 0         # model_bytes (0 on 'megastep')
    exchange: str = ""
    pair_slots: Optional[np.ndarray] = None    # (P, P) Σ active slot counts
    pair_rounds: int = 0                       # rounds pair_slots covers
    count_hist: Optional[np.ndarray] = None    # (supersteps + 1,) Σ counts;
                                               # None on 'dense'

    @staticmethod
    def model_bytes(slots: int, num_parts: int, rounds: int, cap: int,
                    compact: bool) -> int:
        """The dense/compact comm-volume model of a single-query run: per
        round the dense exchange ships every pair row — P² · cap values at
        4 B — while the compact exchange ships, per pair, a count header
        (4 B) plus count packed slots at 8 B (value and slot id) each."""
        if not compact:
            return rounds * num_parts * num_parts * cap * 4
        return slots * 8 + rounds * num_parts * num_parts * 4


class _Tally:
    """Device-side accumulators of one run's telemetry. ``pairs0`` is None
    where the route observes no per-pair counts ('dense')."""

    def __init__(self, P: int, max_s: int, nsent0, wire0, pairs0, device):
        self.liters = torch.zeros(P, dtype=torch.int32, device=device)
        self.hist = torch.zeros(max_s, dtype=torch.int32, device=device)
        self.whist = torch.zeros(max_s + 1, dtype=torch.int64, device=device)
        self.whist[0] = wire0
        self.sent = torch.as_tensor(nsent0, device=device).to(torch.int64)
        self.pairs = self.chist = None
        if pairs0 is not None:
            self.chist = torch.zeros(max_s + 1, dtype=torch.int32,
                                     device=device)
            self.chist[0] = pairs0.sum()
            self.pairs = pairs0.clone()

    def fold(self, step: int, nchanged, liters, nsent, wire, pairs) -> None:
        self.liters += liters
        self.hist[step] = nchanged
        self.whist[step + 1] = wire
        self.sent += nsent
        if self.pairs is not None:
            self.chist[step + 1] = pairs.sum()
            self.pairs += pairs

    def telemetry(self, steps: int, exchange: str, num_parts: int,
                  cap: int) -> Telemetry:
        rounds = steps + 1
        whist = self.whist[:rounds].cpu().numpy()
        wire = int(whist.sum())
        if exchange == "megastep":
            nbytes = 0
        else:
            nbytes = Telemetry.model_bytes(wire, num_parts, rounds, cap,
                                           exchange == "compact")
        t = Telemetry(
            supersteps=steps,
            local_iters=self.liters.cpu().numpy(),
            changed_hist=self.hist[:steps].cpu().numpy(),
            messages_sent=int(self.sent),
            wire_hist=whist, wire_slots=wire, bytes_on_wire=nbytes,
            exchange=exchange)
        if self.pairs is not None:
            t.pair_slots = self.pairs.cpu().numpy()
            t.pair_rounds = rounds
            t.count_hist = self.chist[:rounds].cpu().numpy()
        return t


class GopherEngine:
    """Runs a program over a PartitionedGraph to global quiescence."""

    def __init__(self, pg: PartitionedGraph, program, backend: str = "local",
                 mesh=None, max_supersteps: int = 4096,
                 gb: Optional[dict] = None, exchange: str = "auto",
                 tier_plan=None, tracer=None, metrics=None,
                 validate: bool = False, device="cuda"):
        self.device = resolve_device(device)
        if backend != "local" or mesh is not None:
            raise NotImplementedError(
                "only the 'local' backend is ported (ROADMAP A8: the "
                "multi-device backend)")
        if exchange not in _EXCHANGES:
            raise ValueError(f"unknown exchange {exchange!r}")
        kind = getattr(program, "megastep_kind", None)
        if exchange == "auto":
            # 'local' + an eligible program -> the fused route; any other
            # program -> the staged dense route (the single-device
            # transpose is the whole wire, so no compaction pays)
            exchange = "megastep" if kind is not None else "dense"
        if exchange in _NOT_YET:
            raise NotImplementedError(
                f"exchange {exchange!r} is not ported yet: {_NOT_YET[exchange]}")
        if exchange == "megastep" and kind is None:
            raise ValueError(
                "program is not megastep-eligible (megastep_kind is None)")
        if tier_plan is not None:
            raise NotImplementedError(
                "tier plans are not ported yet: ROADMAP A3 (tiers, phased "
                "and resident)")
        if tracer is not None or metrics is not None:
            raise NotImplementedError(
                "tracing and metrics are not ported yet: ROADMAP A7 "
                "(observability)")
        if validate:
            raise NotImplementedError(
                "static validation is not ported yet: ROADMAP A9 (sentinel)")
        self.pg = pg
        self.program = program
        self.max_supersteps = max_supersteps
        self.exchange = exchange
        self._gb = gb                # cached device-side graph block
        self._mega_cm = None         # composed mailbox, built once per engine
        self._staged_gb = None       # block + flat adjacency, once per engine

    def _graph_block(self) -> dict:
        if self._gb is None:
            self._gb = graph_block(self.pg, self.device)
        return self._gb

    def _gb_for_run(self):
        """The graph block and its composed mailbox
        (``kernels.megastep.compose_mailbox``), both built once per engine
        and shared by every run."""
        gb = self._graph_block()
        if self._mega_cm is None:
            self._mega_cm = mega.compose_mailbox(gb)
        return gb, self._mega_cm

    def _gb_for_staged(self) -> dict:
        """The graph block with the flat adjacency the staged sweeps read
        (``gb["adj"]``, ``kernels.flat.flat_adjacency``), built once
        per engine."""
        if self._staged_gb is None:
            gb = self._graph_block()
            self._staged_gb = {**gb, "adj": flat.flat_adjacency(gb)}
        return self._staged_gb

    def run(self, checkpointer=None, checkpoint_every: int = 0,
            resume: bool = False, extra: Optional[dict] = None,
            superstep_budget: Optional[int] = None):
        """Run to quiescence. Returns (state dict of (P, ...) numpy arrays,
        Telemetry)."""
        if checkpointer is not None or checkpoint_every or resume \
                or superstep_budget is not None:
            raise NotImplementedError(
                "checkpointed runs are not ported yet: ROADMAP A6 "
                "(checkpointing and resilience)")
        if extra:
            raise NotImplementedError(
                "run(extra=) is not ported yet: ROADMAP A4 (incremental "
                "analytics)")
        if self.exchange == "megastep":
            state, steps, tally = self._run_megastep(*self._gb_for_run())
        else:
            state, steps, tally = self._run_batched(self._gb_for_staged())
        state = {k: v.cpu().numpy() for k, v in state.items()}
        return state, tally.telemetry(steps, self.exchange,
                                      self.pg.num_parts, self.pg.mailbox_cap)

    def run_queries(self, extra: Optional[dict] = None):
        raise NotImplementedError(
            "query-batched runs are not ported yet: ROADMAP A5 (serving)")

    # ---------------- the staged route ----------------

    def make_superstep(self, gb: dict):
        """One staged BSP superstep over all P partitions: ``sstep(state,
        inbox, step) -> (state, inbox, changed (P,), liters (P,), nsent,
        wire, extras)`` — the program's superstep, then the exchange of its
        new state (see :meth:`make_exchange`)."""
        prog = self.program
        exchange = self.make_exchange(gb)

        def sstep(state, inbox, step):
            state, changed, liters = prog.superstep(state, inbox, gb, step)
            inbox, nsent, wire, extras = exchange(state)
            return state, inbox, changed, liters, nsent, wire, extras

        return sstep

    def make_exchange(self, gb: dict):
        """The mailbox half of a superstep: ``exchange(state) -> (inbox,
        nsent, wire, extras)``. Split out so the BSP loop can PRIME the first
        inbox from the initial state: without it superstep 0 would see an
        empty inbox, which for PageRank drops all remote mass from the first
        iteration.

        'dense'    every (src, dst) pair ships its full cap-slot row;
                   wire = P·P·cap a round, the routed buffer itself.
        'compact'  each pair row is packed to the prefix of its active
                   slots (kernel K5) and rebuilt at the receiver by a
                   gather, so the inbox is bit-identical to 'dense';
                   wire = Σ counts, the modeled count-prefixed payload.

        ``extras`` is {} on 'dense' and {'pairs': (P, P) counts} on
        'compact', the per-pair observation ``Telemetry.pair_slots`` sums.
        """
        pack, route = self.make_exchange_stages(gb)

        def exchange(state):
            payload, nsent, wire, extras = pack(state)
            return (route(payload), nsent, wire, extras)

        return exchange

    def make_exchange_stages(self, gb: dict):
        """The exchange split at its network boundary: ``pack(state) ->
        (payload, nsent, wire, extras)`` builds the messages and the
        payload that would cross the wire; ``route(payload) -> inbox``
        transposes it to the receivers and combines their inboxes."""
        prog = self.program
        P, cap, v_max = self.pg.num_parts, self.pg.mailbox_cap, self.pg.v_max
        combine = prog.combine
        mode = self.exchange
        if mode not in ("dense", "compact"):
            raise ValueError(f"the {mode!r} route has no staged exchange")

        def finish(iv):
            return msg.combine_inbox_gather(iv, gb["ib_lo"], gb["ib_hub_idx"],
                                            gb["ib_hub"], v_max, combine)

        if mode == "dense":
            def pack(state):
                vals, send = prog.messages(state, gb)
                slot_vals = msg.build_outbox_gather(vals, send, gb["ob_inv"],
                                                    P, cap, combine)
                return (slot_vals,), send.sum(), P * P * cap, {}

            def route(payload):
                (slot_vals,) = payload
                return finish(msg.route_local(slot_vals))
        else:
            def pack(state):
                vals, send = prog.messages(state, gb)
                pvals, pinv, counts = msg.build_outbox_compact(
                    vals, send, gb["ob_inv"], P, cap, combine)
                # the packed prefixes and their slot maps travel; counts is
                # the header a real transport would read each length from
                return ((pvals, pinv), send.sum(), counts.sum(),
                        {"pairs": counts})

            def route(payload):
                pvals, pinv = payload
                return finish(msg.unpack_slots(msg.route_local(pvals),
                                               msg.route_local(pinv), combine))

        return pack, route

    def _run_batched(self, gb: dict):
        """The staged BSP loop: prime the inbox from the initial state, then
        superstep + exchange until no partition changed."""
        prog = self.program
        P = self.pg.num_parts
        max_s = self.max_supersteps
        sstep = self.make_superstep(gb)
        state = prog.init(gb)
        inbox, nsent0, wire0, ex0 = self.make_exchange(gb)(state)
        tally = _Tally(P, max_s, nsent0, wire0, ex0.get("pairs"), self.device)
        step, done = 0, False
        while not done and step < max_s:
            state, inbox, changed, liters, nsent, wire, ex = sstep(
                state, inbox, step)
            nchanged = changed.sum()
            tally.fold(step, nchanged, liters, nsent, wire, ex.get("pairs"))
            step += 1
            done = int(nchanged) == 0    # the superstep's one host read
        return state, step, tally

    # ---------------- the fused route ----------------

    def _run_megastep(self, gb: dict, cm: dict):
        """The BSP loop with the whole superstep fused into one call of
        ``kernels.megastep``. Delivery happens at the TOP of each superstep
        from the previous round's send set, so the initial state's messages
        need no separate prime. Telemetry mirrors the JAX fused route:
        ``pairs``/``count_hist`` are the logical frontier observation and
        ``wire_*`` are zero — nothing ships through buffers."""
        prog = self.program
        P, v_max = cm["num_parts"], cm["v_max"]
        max_s = self.max_supersteps
        state0 = prog.init(gb)

        if prog.megastep_kind == "pagerank":
            r = state0["r"].reshape(-1)
            deg = gb["out_degree"].to(torch.float32).reshape(-1)
            tele = (prog.teleport_fn(gb).reshape(-1)
                    if prog.teleport_fn is not None else 1.0 / prog.n_global)
            pairs0, nsent0 = mega.round_stats(None, cm)
            tally = _Tally(P, max_s, nsent0, 0, pairs0, self.device)
            ones = torch.ones(P, dtype=torch.int32, device=self.device)
            delta = torch.tensor(float("inf"), device=self.device)
            step, changed = 0, True
            while changed and step < max_s:
                r, delta, changed = mega.megastep_pagerank(
                    r, cm, deg, tele, prog.n_global, prog.damping,
                    prog.num_iters, step)
                # PageRank sends unconditionally: every round's observation
                # is the full slot occupancy, the final round included
                pairs, nsent = mega.round_stats(None, cm)
                tally.fold(step, P if changed else 0, ones, nsent, 0, pairs)
                step += 1
            state = {"r": r.reshape(P, v_max), "delta": delta.expand(P)}
            return state, step, tally

        x = state0["x"].reshape(-1).contiguous()
        ch = state0["changed_v"].reshape(-1).contiguous()
        fr = state0["frontier"].reshape(-1).contiguous()
        pairs0, nsent0 = mega.round_stats(ch, cm)
        tally = _Tally(P, max_s, nsent0, 0, pairs0, self.device)
        step, done = 0, False
        while not done and step < max_s:
            x, ch, fr, li = mega.megastep_semiring(
                x, ch, fr, cm, prog.semiring, unroll=prog.fixpoint_unroll)
            pairs, nsent = mega.round_stats(ch, cm)
            nchanged = ch.reshape(P, v_max).any(dim=1).sum()
            tally.fold(step, nchanged, li, nsent, 0, pairs)
            step += 1
            done = int(nchanged) == 0    # the superstep's one host read
        state = {"x": x.reshape(P, v_max), "changed_v": ch.reshape(P, v_max),
                 "frontier": fr.reshape(P, v_max)}
        return state, step, tally
