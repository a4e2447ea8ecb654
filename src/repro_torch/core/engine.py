"""Gopher: the sub-graph centric BSP execution engine, on one device.

The port of the JAX package's ``core/engine.py`` for the ``local`` backend
and the fused ``megastep`` exchange — the route ``exchange='auto'`` takes
for every program with a ``megastep_kind``:

  paper                               here
  -----                               ----
  worker per machine                  one partition of the flat (P·v_max,)
                                      state; all P run as one batch
  thread pool over sub-graphs         the masked local-fixpoint sweep inside
                                      one superstep launch (kernel K3)
  message flush at the barrier        the composed mailbox gather at the top
                                      of the next superstep
  manager sync/resume/terminate       one host read of the halt vote per
                                      superstep

The BSP loop is a Python loop over supersteps. Each superstep is one call
of ``kernels.megastep``'s fused superstep; the telemetry stays on the device
until the run ends, and the halt vote (how many partitions changed) is the
only value the host reads per superstep. PageRank runs a fixed number of
supersteps, so its loop reads nothing from the device until the end.

Everything else of the JAX engine raises ``NotImplementedError`` naming the
ROADMAP item that brings it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.blocks import graph_block
from repro_torch.gofs.formats import PartitionedGraph
from repro_torch.kernels import megastep as mega

_EXCHANGES = ("auto", "compact", "dense", "tiered", "phased", "megastep")
_NOT_YET = {
    "dense": "ROADMAP A1 (the staged dense route)",
    "compact": "ROADMAP A2 (the compact exchange)",
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
    """What a megastep run records (the JAX package's Telemetry fields of
    the fused route)."""
    supersteps: int
    local_iters: np.ndarray        # (P,) cumulative sweep iterations
    changed_hist: np.ndarray       # (supersteps,) #partitions changed
    messages_sent: int
    # round-indexed (length supersteps + 1): round 0 is the initial state's
    # messages, round s + 1 the send set of superstep s
    wire_hist: Optional[np.ndarray] = None     # zeros: nothing is routed
    wire_slots: int = 0
    bytes_on_wire: int = 0
    exchange: str = ""
    pair_slots: Optional[np.ndarray] = None    # (P, P) Σ active slot counts
    pair_rounds: int = 0                       # rounds pair_slots covers
    count_hist: Optional[np.ndarray] = None    # (supersteps + 1,) Σ counts


class _Tally:
    """Device-side accumulators of one run's telemetry."""

    def __init__(self, P: int, max_s: int, pairs0, nsent0, device):
        self.liters = torch.zeros(P, dtype=torch.int32, device=device)
        self.hist = torch.zeros(max_s, dtype=torch.int32, device=device)
        self.chist = torch.zeros(max_s + 1, dtype=torch.int32, device=device)
        self.chist[0] = pairs0.sum()
        self.sent = nsent0.to(torch.int64)
        self.pairs = pairs0.clone()

    def fold(self, step: int, pairs, nsent, liters, nchanged) -> None:
        self.liters += liters
        self.hist[step] = nchanged
        self.chist[step + 1] = pairs.sum()
        self.sent += nsent
        self.pairs += pairs

    def telemetry(self, steps: int) -> Telemetry:
        return Telemetry(
            supersteps=steps,
            local_iters=self.liters.cpu().numpy(),
            changed_hist=self.hist[:steps].cpu().numpy(),
            messages_sent=int(self.sent),
            wire_hist=np.zeros(steps + 1, np.int32),
            exchange="megastep",
            pair_slots=self.pairs.cpu().numpy(),
            pair_rounds=steps + 1,
            count_hist=self.chist[:steps + 1].cpu().numpy())


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
            # 'local' + an eligible program -> the fused route; the rest
            # resolves to the staged dense route in the JAX engine
            exchange = "megastep" if kind is not None else "dense"
        if exchange in _NOT_YET:
            raise NotImplementedError(
                f"exchange {exchange!r} is not ported yet: {_NOT_YET[exchange]}")
        if kind is None:
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

    def run(self, checkpointer=None, checkpoint_every: int = 0,
            resume: bool = False, extra: Optional[dict] = None,
            superstep_budget: Optional[int] = None):
        """Run to quiescence. Returns (state dict of (P, v_max) numpy
        arrays, Telemetry)."""
        if checkpointer is not None or checkpoint_every or resume \
                or superstep_budget is not None:
            raise NotImplementedError(
                "checkpointed runs are not ported yet: ROADMAP A6 "
                "(checkpointing and resilience)")
        if extra:
            raise NotImplementedError(
                "run(extra=) is not ported yet: ROADMAP A4 (incremental "
                "analytics)")
        gb, cm = self._gb_for_run()
        state, steps, tally = self._run_megastep(gb, cm)
        state = {k: v.cpu().numpy() for k, v in state.items()}
        return state, tally.telemetry(steps)

    def run_queries(self, extra: Optional[dict] = None):
        raise NotImplementedError(
            "query-batched runs are not ported yet: ROADMAP A5 (serving)")

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
            tally = _Tally(P, max_s, pairs0, nsent0, self.device)
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
                tally.fold(step, pairs, nsent, ones, P if changed else 0)
                step += 1
            state = {"r": r.reshape(P, v_max), "delta": delta.expand(P)}
            return state, step, tally

        x = state0["x"].reshape(-1).contiguous()
        ch = state0["changed_v"].reshape(-1).contiguous()
        fr = state0["frontier"].reshape(-1).contiguous()
        pairs0, nsent0 = mega.round_stats(ch, cm)
        tally = _Tally(P, max_s, pairs0, nsent0, self.device)
        step, done = 0, False
        while not done and step < max_s:
            x, ch, fr, li = mega.megastep_semiring(
                x, ch, fr, cm, prog.semiring, unroll=prog.fixpoint_unroll)
            pairs, nsent = mega.round_stats(ch, cm)
            nchanged = ch.reshape(P, v_max).any(dim=1).sum()
            tally.fold(step, pairs, nsent, li, nchanged)
            step += 1
            done = int(nchanged) == 0    # the superstep's one host read
        state = {"x": x.reshape(P, v_max), "changed_v": ch.reshape(P, v_max),
                 "frontier": fr.reshape(P, v_max)}
        return state, step, tally
