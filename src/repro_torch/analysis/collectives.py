"""Gopher Sentinel Pass 1, for torch: the collective recorder.

The JAX package's Pass 1 walks the jaxpr of each compiled BSP loop. The
port has no jaxpr: its collectives are direct ``torch.distributed`` calls
made from host code, once per superstep, every one of them through
``core.wire``. So the port's Pass 1 is a **recorder** at those calls plus
a **cross-rank agreement** check, and it is DYNAMIC: it covers the
branches the validated run takes, where the JAX walk covers every branch
of the loop statically. The invariants it checks:

1. **cross-rank agreement** (``COLLECTIVE_MISMATCH``, the port's
   ``COND_COLLECTIVE_MISMATCH``). While a :class:`Recorder` is on a mesh
   group, every rank all-gathers a fixed-size int64 fingerprint on a collective's own
   group before the collective runs: the site (file:line of the caller of
   the ``wire`` function and of its caller), the kind, the reduce op, the group's ranks, the
   shape, numel and dtype, and the collective's sequence number on that
   group. At the end of the run every rank posts an ``end`` fingerprint on
   the engine's group, so a rank that left the loop early meets a peer's
   collective in the fingerprint exchange instead of a hang. On any
   disagreement every rank of the group raises :class:`SentinelError`
   naming each rank's site, kind and shape. A branch on an all-reduced
   value — the phased overflow flag, the halt vote — agrees by
   construction and passes: the runtime form of the JAX walk's
   "replicated predicate" exemption. The recorder makes no group of its
   own (torch names a subgroup by its ranks and each member's count of
   groups made, so an extra group would shift every later name): it
   fingerprints on the group the collective uses. Barriers and tier shifts
   (``batch_isend_irecv``) are recorded and fingerprinted like the rest;
   ``new_group`` is recorded as a group made.
2. **group binding** (``UNBOUND_GROUP``, the port's ``UNBOUND_AXIS``).
   Every collective's group must lie inside the engine's mesh group: the
   group itself, or one ``launch.mesh`` / ``models.sharding`` made from
   its ranks. A collective on ``WORLD``, or on a group that spans a lost
   rank, inside a shrunk ``sub_mesh`` would hang the survivors; it is
   refused before it is issued.
3. **tier plans** (:func:`check_plan_static`): every field a concrete
   hashable host value, hash stable under copy, the geometry
   self-consistent. A ``torch.Tensor`` IS hashable (by identity), so a
   tensor field is caught explicitly, as an ndarray is. The JAX package's
   ``PLAN_TRACER_LEAK`` has no torch analog: nothing traces a plan here.

After a run, :func:`check_run` holds what was recorded to three more
rules: a local ``megastep`` run records nothing
(``MEGASTEP_COLLECTIVE``); a tiered or phased run's wire collectives stay
within the tier schedule's per-kind byte budgets (``WIRE_BYTE_BUDGET``,
the JAX CLI's HLO budget rule); and a mesh run's superstep kinds, mapped
through :data:`REF_KIND`, are a subset of the JAX loop's
(``KIND_NOT_IN_REFERENCE``), with per-kind counts that differ from the
reference's only as a warning.

Phases. Each recorded collective carries the phase of the run it fell in
— ``init`` (the prime), ``superstep`` or ``end`` (the run-end gathers,
which the JAX single controller has no counterpart for) — and the stage
(the innermost span: ``sweep``, ``pack``, ``exchange``, ``halt-vote``,
``checkpoint``, ...). They come from the spans the engine already opens
for the tracer: a validated run wraps the engine's tracer in
:meth:`Recorder.tracer`, which passes every call through and tells the
recorder which span it is in.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.analysis.report import (ERROR, WARNING, SentinelError,
                                         Violation)
from repro_torch.core import wire

#: the JAX primitives Pass 1 sees, mapped to the port's calls
REF_KIND = {
    "psum": "all_reduce", "pmax": "all_reduce", "pmin": "all_reduce",
    "psum_invariant": "all_reduce",
    "all_to_all": "all_to_all_single", "ppermute": "all_to_all_single",
    "all_gather": "all_gather",
}
#: the port's kinds folded onto :data:`REF_KIND`'s values (the others are
#: their own): a tier shift (one ``batch_isend_irecv`` round) is the
#: port's ``ppermute``
PORT_CLASS = {"batch_isend_irecv": "all_to_all_single",
              "all_gather_into_tensor": "all_gather"}
#: the JAX CLI's byte-budget kinds: the hot tier's uniform block is an
#: ``all_to_all_single`` ('all-to-all'); the shifts, which the JAX package
#: routes by ``ppermute``, fold onto 'collective-permute'
BUDGET_KIND = {"all_to_all_single": "all-to-all",
               "batch_isend_irecv": "collective-permute"}

#: what the JAX package's ``verify_collectives`` counts in each mesh loop,
#: on a real 4-device ``jax.sharding.Mesh`` (``AbstractMesh`` fails under
#: jax 0.9.0): ``road_grid(10, 10, drop_frac=0.05, seed=1, weighted=True)``
#: in 8 parts (``bfs_grow_partition(seed=0)``), the sentinel CLI's plans
#: (``launch.sentinel._plan``); 'semiring' is CC, SSSP and BFS alike
REFERENCE_COUNTS = {
    ("semiring", "dense"): {"all_to_all": 2, "psum": 2},
    ("semiring", "compact"): {"all_to_all": 4, "psum": 2},
    ("semiring", "tiered"): {"ppermute": 18, "psum": 2},
    ("semiring", "phased"): {"psum": 6, "ppermute": 27, "all_to_all": 3},
    ("pagerank", "dense"): {"all_to_all": 2, "psum": 4},
    ("pagerank", "compact"): {"all_to_all": 4, "psum": 4},
    ("pagerank", "tiered"): {"ppermute": 18, "psum": 4},
    ("pagerank", "phased"): {"psum": 10, "ppermute": 27, "all_to_all": 3},
}
#: the same runs' kind sets per exchange (every program alike)
REFERENCE_KINDS = {
    ex: frozenset(k for (_, e), c in REFERENCE_COUNTS.items() if e == ex
                  for k in c)
    for ex in ("dense", "compact", "tiered", "phased")}

# the fingerprint: fixed size, int64
KINDS = ("end", "abort", "all_reduce", "all_gather",
         "all_gather_into_tensor", "all_to_all_single", "broadcast",
         "barrier", "batch_isend_irecv")
_MAGIC = 0x5E47
_FP_HEAD = 13                        # fields before the site's bytes
FP_LEN = 32
_SITE_BYTES = (FP_LEN - _FP_HEAD) * 8
_REDUCE_OPS = (("sum", dist.ReduceOp.SUM), ("max", dist.ReduceOp.MAX),
               ("min", dist.ReduceOp.MIN), ("product", dist.ReduceOp.PRODUCT))
_SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _op_name(op) -> str:
    if op is None:
        return ""
    for name, o in _REDUCE_OPS:
        if op == o:
            return name
    return str(op)


def _where(frame) -> str:
    path = os.path.abspath(frame.f_code.co_filename)
    path = (path[len(_SRC) + 1:] if path.startswith(_SRC + os.sep)
            else os.path.basename(path))
    return f"{path}:{frame.f_lineno}"


def _site(frame) -> str:
    """file:line of ``frame`` (the caller of a ``core.wire`` function) and
    of its caller, as ``a.py:1 < b.py:2``: the helpers that forward a
    collective (``_Ranks.sum``, ``models.sharding.reduce``) name their
    caller too. Paths from the port's ``src`` root; other files by
    name."""
    up = frame.f_back
    return _where(frame) + ("" if up is None else f" < {_where(up)}")


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One recorded collective."""
    kind: str                      # core.wire's function name
    op: str                        # reduce op ('sum', 'max', ...) or ''
    ranks: tuple                   # the group's global ranks
    shape: tuple                   # the first tensor's shape
    dtype: str
    nbytes: int                    # bytes this rank sends
    source: str                    # the wire call's caller and its caller
    phase: str                     # 'init' | 'superstep' | 'end'
    stage: str                     # the innermost span ('' outside one)
    step: int                      # the superstep (-1 outside one)
    route: str = ""                # 'dense-retry' inside a tiered rerun

    def to_json(self) -> dict:
        return {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in dataclasses.asdict(self).items()}


def _counts(ops) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for o in ops:
        out[o.kind] = out.get(o.kind, 0) + 1
    return out


def fold(counts: dict, table: dict) -> Dict[str, int]:
    """``counts`` by kind summed onto ``table``'s classes."""
    out: Dict[str, int] = {}
    for k, n in counts.items():
        c = table.get(k, k)
        out[c] = out.get(c, 0) + n
    return out


@dataclasses.dataclass
class CollectiveSummary:
    """Pass 1's record of one run: every collective in order, the groups
    made, the run's supersteps and the fingerprint gathers the agreement
    check issued (one a collective and the run's end)."""
    ops: List[CollectiveOp]
    groups: List[tuple]
    supersteps: int
    fingerprints: int = 0

    def per_superstep(self) -> List[Dict[str, int]]:
        """The collectives of each superstep, by kind."""
        out = [dict() for _ in range(self.supersteps)]
        for o in self.ops:
            if o.phase == "superstep" and 0 <= o.step < len(out):
                out[o.step][o.kind] = out[o.step].get(o.kind, 0) + 1
        return out

    @property
    def counts(self) -> Dict[str, int]:
        """The collectives of one superstep by kind (the most any
        superstep issued: a phased run's dense-retried superstep issues
        other ones than its tiered supersteps)."""
        out: Dict[str, int] = {}
        for step in self.per_superstep():
            for k, n in step.items():
                out[k] = max(out.get(k, 0), n)
        return out

    @property
    def init_counts(self) -> Dict[str, int]:
        return _counts(o for o in self.ops if o.phase == "init")

    @property
    def end_counts(self) -> Dict[str, int]:
        """The run-end gathers (and a checkpointed run's snapshots)."""
        return _counts(o for o in self.ops if o.phase == "end")

    def superstep_kinds(self) -> frozenset:
        return frozenset(o.kind for o in self.ops if o.phase == "superstep")

    def static_counts(self) -> Dict[str, int]:
        """The prime's collectives plus one superstep's, folded onto
        :data:`REF_KIND`'s classes: the form of the JAX walk's count, which
        covers the loop's prime and its body once."""
        c = dict(self.init_counts)
        for k, n in self.counts.items():
            c[k] = c.get(k, 0) + n
        return fold(c, PORT_CLASS)

    def stage_counts(self) -> Dict[str, Dict[str, int]]:
        """The collectives by stage: the prime's under 'init', each
        superstep stage's at their most in one superstep, a checkpointed
        run's snapshots under 'checkpoint' and the run's end under
        'end'."""
        out: Dict[str, Dict[str, int]] = {"init": self.init_counts}
        per: Dict[tuple, int] = {}
        for o in self.ops:
            if o.phase == "superstep":
                key = (o.stage, o.step, o.kind)
                per[key] = per.get(key, 0) + 1
        for (stage, _, kind), n in per.items():
            d = out.setdefault(stage, {})
            d[kind] = max(d.get(kind, 0), n)
        for name, pick in (("checkpoint", lambda o: o.stage == "checkpoint"),
                           ("end", lambda o: o.stage != "checkpoint")):
            out[name] = _counts(o for o in self.ops
                                if o.phase == "end" and pick(o))
        return out

    def to_json(self) -> dict:
        return {"supersteps": self.supersteps, "counts": self.counts,
                "fingerprints": self.fingerprints,
                "init_counts": self.init_counts,
                "end_counts": self.end_counts,
                "per_superstep": self.per_superstep(),
                "groups_made": [list(g) for g in self.groups]}


class _PhaseSpan:
    __slots__ = ("rec", "name", "inner")

    def __init__(self, rec, name, inner):
        self.rec, self.name, self.inner = rec, name, inner

    def __enter__(self):
        self.rec._push(self.name)
        return self.inner.__enter__()

    def __exit__(self, *exc):
        try:
            return self.inner.__exit__(*exc)
        finally:
            self.rec._pop()


class _PhaseTracer:
    """A tracer that passes every call to ``inner`` and tells the recorder
    which span the run is in: the validated run behaves as it would under
    ``inner`` alone."""

    def __init__(self, inner, rec: "Recorder"):
        self._inner = inner
        self._rec = rec

    @property
    def enabled(self) -> bool:
        return self._inner.enabled

    def span(self, name: str, **args):
        return _PhaseSpan(self._rec, name, self._inner.span(name, **args))

    def __getattr__(self, name):
        return getattr(self._inner, name)


class Recorder:
    """Records every collective this thread issues through ``core.wire``
    while it is entered (a context manager; one a thread, as
    ``models.sharding``'s state is).

    ``group`` is the engine's mesh group: every recorded collective's group
    must lie inside its ranks (``UNBOUND_GROUP``), each collective is
    agreed on first (one extra all_gather of FP_LEN int64 on the
    collective's own group), and the run's ``end`` fingerprint is posted
    on ``group`` on exit. Without a group (a local run) the recorder only
    records."""

    def __init__(self, group=None):
        self.group = group
        self.agree = group is not None
        self.ops: List[CollectiveOp] = []
        self.groups: List[tuple] = []
        self.fingerprints = 0          # fingerprint gathers issued
        self._bound = (None if group is None
                       else frozenset(self._ranks_of(group)))
        self._stack: List[str] = []
        self._steps = 0
        self._seen_step = False
        self._seq: Dict[tuple, int] = {}
        self._bound_mismatch = False
        self._prev = None

    # ---------------- context ----------------
    def __enter__(self):
        self._prev = wire.set_recorder(self)
        return self

    def __exit__(self, et, e, tb):
        wire.set_recorder(self._prev)
        if self.agree and not self._bound_mismatch:
            # the run's end: a rank that left early meets a peer's
            # collective here (or every rank agrees that the run ended)
            try:
                self._agree("abort" if et is not None else "end", "", (),
                            (), "", self.group,
                            f"end of the validated run ({et.__name__})"
                            if et is not None else "end of the validated run")
            except SentinelError:
                if et is None:
                    raise
        return False

    def tracer(self, inner) -> _PhaseTracer:
        """``inner`` (the engine's tracer) wrapped to report spans here."""
        return _PhaseTracer(inner, self)

    def _push(self, name: str) -> None:
        if name == "superstep":
            self._steps += 1
            self._seen_step = True
        elif name == "dense-retry":
            self._seen_step = False
        self._stack.append(name)

    def _pop(self) -> None:
        self._stack.pop()

    def summary(self) -> CollectiveSummary:
        return CollectiveSummary(list(self.ops), list(self.groups),
                                 self._steps, self.fingerprints)

    # ---------------- the wire's hooks ----------------
    def _ranks_of(self, group) -> tuple:
        return tuple(dist.get_process_group_ranks(
            dist.group.WORLD if group is None else group))

    def _unbound(self, ranks, source: str, what: str):
        if self._bound is not None and not set(ranks) <= self._bound:
            raise SentinelError([Violation(
                pass_name="collectives", code="UNBOUND_GROUP",
                where=source,
                detail=(f"{what} on ranks {list(ranks)}, which are not all "
                        f"in the engine's mesh {sorted(self._bound)}: a "
                        "rank outside the mesh (a lost rank after a "
                        "shrink) never enters it, so the mesh's ranks "
                        "would wait on it for ever. Use the mesh's group "
                        "or one made from its ranks"),
                severity=ERROR)])

    def collective(self, kind: str, tensors, group, frame, op=None) -> None:
        """Called by ``core.wire`` just before it issues a collective."""
        source = _site(frame)
        ranks = self._ranks_of(group)
        self._unbound(ranks, source,
                      f"{kind}" + (" on WORLD" if group is None else ""))
        t = tensors[0] if tensors else None
        in_step = "superstep" in self._stack
        o = CollectiveOp(
            kind=kind, op=_op_name(op), ranks=ranks,
            shape=tuple(t.shape) if t is not None else (),
            dtype=str(t.dtype).replace("torch.", "") if t is not None else "",
            nbytes=sum(x.numel() * x.element_size() for x in tensors),
            source=source,
            phase=("superstep" if in_step
                   else "end" if self._seen_step else "init"),
            stage=self._stack[-1] if self._stack else "",
            step=self._steps - 1 if in_step else -1,
            route="dense-retry" if "dense-retry" in self._stack else "")
        self.ops.append(o)
        if self.agree:
            self._agree(kind, o.op, o.shape, ranks, o.dtype, group, source,
                        numel=sum(x.numel() for x in tensors))

    def group_made(self, ranks, frame) -> None:
        """Called by ``core.wire.new_group`` before the group is made."""
        ranks = tuple(int(r) for r in ranks)
        source = _site(frame)
        self._unbound(ranks, source, "new_group")
        self.groups.append(ranks)

    # ---------------- agreement ----------------
    def _agree(self, kind, op, shape, ranks, dtype, group, source,
               numel: int = 0) -> None:
        key = tuple(ranks) or tuple(self._ranks_of(group))
        seq = self._seq.get(key, 0)
        self._seq[key] = seq + 1
        fp = encode(kind, op, shape, key, dtype, numel, seq, source)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        mine = torch.tensor(fp, dtype=torch.int64, device=dev)
        n = dist.get_world_size(group)
        bufs = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(bufs, mine, group=group)
        self.fingerprints += 1
        rows = torch.stack(bufs).cpu().numpy()
        if (rows == rows[:1]).all():
            return
        if group is self.group or set(key) == self._bound:
            self._bound_mismatch = True
        members = dist.get_process_group_ranks(
            dist.group.WORLD if group is None else group)
        lines = [f"rank {r}: {decode(row)}" for r, row in zip(members, rows)]
        raise SentinelError([Violation(
            pass_name="collectives", code="COLLECTIVE_MISMATCH",
            where=source,
            detail=("the ranks of a group are about to issue different "
                    "collectives, which would deadlock the mesh (a "
                    "decision that picks a collective did not agree on "
                    "every rank): " + "; ".join(lines)),
            severity=ERROR)])


def encode(kind, op, shape, ranks, dtype, numel, seq, source) -> list:
    """The FP_LEN int64 fingerprint of one collective (or of a run's end)."""
    site = source.encode()[-_SITE_BYTES:]
    shp = list(shape[:4]) + [-1] * (4 - min(len(shape), 4))
    head = [_MAGIC, KINDS.index(kind),
            [n for n, _ in _REDUCE_OPS].index(op) + 1 if op else 0,
            zlib.crc32(dtype.encode()), int(numel),
            zlib.crc32(np.asarray(ranks, np.int64).tobytes()),
            len(shape), *shp, seq, len(site)]
    body = np.frombuffer(site.ljust(_SITE_BYTES, b"\0"), np.int64)
    return head + body.tolist()


def decode(row) -> str:
    """A fingerprint as a sentence: site, kind, shape, sequence."""
    row = [int(x) for x in row]
    n = row[_FP_HEAD - 1]
    site = np.asarray(row[_FP_HEAD:], np.int64).tobytes()[:n].decode(
        errors="replace")
    kind = KINDS[row[1]] if 0 <= row[1] < len(KINDS) else f"?{row[1]}"
    shape = tuple(row[7:7 + min(row[6], 4)])
    return (f"{kind} of shape {shape} ({row[4]} elements, #{row[11]} on "
            f"its group) at {site}")


# ---------------- plan staticness ----------------

def _static_field_ok(value) -> bool:
    if isinstance(value, (int, float, str, bytes, bool, type(None))):
        return True
    if isinstance(value, tuple):
        return all(_static_field_ok(v) for v in value)
    return False


def check_plan_static(plan, where: str = "tier_plan") -> List[Violation]:
    """Verify a TierPlan/PhasedTierPlan is a host constant fit to key a
    configuration: every field a concrete hashable host value (no tensors,
    no NumPy arrays), hash() stable under copy, and the tier-table
    geometry self-consistent. A ``torch.Tensor`` hashes by identity, so
    it would pass a hash test and key every run apart: it is caught here
    as an array is."""
    out: List[Violation] = []
    if plan is None:
        return out
    name = type(plan).__name__
    for f in dataclasses.fields(plan):
        v = getattr(plan, f.name)
        if isinstance(v, (np.ndarray, torch.Tensor)):
            out.append(Violation(
                pass_name="collectives", code="PLAN_UNHASHABLE_FIELD",
                where=f"{where}.{f.name}",
                detail=(f"{name}.{f.name} is a {type(v).__name__} — arrays "
                        "are unhashable (a tensor hashes by identity), so "
                        "this plan cannot key a configuration: every run "
                        "would count as new. Store tables as bytes/tuples "
                        "(see TierPlan.tier_bytes)."),
                severity=ERROR))
            continue
        if not _static_field_ok(v):
            out.append(Violation(
                pass_name="collectives", code="PLAN_NON_STATIC_FIELD",
                where=f"{where}.{f.name}",
                detail=(f"{name}.{f.name} has non-static type "
                        f"{type(v).__name__}; plan fields must be concrete "
                        "hashable host values (int/bytes/str/tuple)"),
                severity=ERROR))
    if out:
        return out

    try:
        h1 = hash(plan)
        h2 = hash(dataclasses.replace(plan))
        if h1 != h2 or plan != dataclasses.replace(plan):
            raise ValueError("hash/eq not stable under copy")
    except Exception as e:
        out.append(Violation(
            pass_name="collectives", code="PLAN_UNHASHABLE",
            where=where,
            detail=(f"{name} is not stably hashable ({e}); a validated "
                    "engine keys its configurations on the plan"),
            severity=ERROR))
        return out

    P = plan.num_parts
    tables = (plan.phase_tier_bytes if hasattr(plan, "phase_tier_bytes")
              else (plan.tier_bytes,))
    for k, tb in enumerate(tables):
        if len(tb) != P * P:
            out.append(Violation(
                pass_name="collectives", code="PLAN_BAD_GEOMETRY",
                where=f"{where}.phase[{k}]" if len(tables) > 1 else where,
                detail=(f"tier table has {len(tb)} bytes, expected "
                        f"P*P = {P * P}"),
                severity=ERROR))
    if hasattr(plan, "boundaries"):
        b = plan.boundaries
        if len(b) != len(tables):
            out.append(Violation(
                pass_name="collectives", code="PLAN_BAD_GEOMETRY",
                where=f"{where}.boundaries",
                detail=(f"{len(tables)} phases but {len(b)} boundaries"),
                severity=ERROR))
        elif any(int(b[i]) >= int(b[i + 1]) for i in range(len(b) - 1)):
            out.append(Violation(
                pass_name="collectives", code="PLAN_BAD_GEOMETRY",
                where=f"{where}.boundaries",
                detail=f"phase boundaries must be strictly increasing: {b}",
                severity=ERROR))
    return out


# ---------------- after the run ----------------

def byte_budgets(plan, num_parts: int, cap: int, D: int,
                 Q: Optional[int]) -> Dict[str, int]:
    """The per-kind, per-rank byte ceilings of one exchange round of a
    tiered or phased run over ``D`` ranks: the most any of the plan's
    phases allows (``TierSchedule.kind_byte_budgets``), and 'dense' the
    dense round, v·P·cap values, that a phased run's retried superstep and
    a tiered run's rerun ship by ``all_to_all_single``."""
    from repro_torch.core.tiers import PhasedTierPlan
    plans = (plan.phase_plans() if isinstance(plan, PhasedTierPlan)
             else (plan,))
    out: Dict[str, int] = {}
    for p in plans:
        for k, b in p.schedule(D).kind_byte_budgets(Q).items():
            out[k] = max(out.get(k, 0), b)
    out["dense"] = (num_parts // D) * num_parts * cap * 4 * (Q or 1)
    return out


def program_family(program) -> str:
    """'pagerank' for a sum-combine program, else 'semiring'."""
    return "pagerank" if getattr(program, "combine", None) == "sum" \
        else "semiring"


def check_run(summary: CollectiveSummary, exchange: str, backend: str,
              plan=None, num_parts: int = 0, cap: int = 0, D: int = 1,
              Q: Optional[int] = None, where: str = "run",
              reference: Optional[dict] = None) -> List[Violation]:
    """The rules on a finished run's record: ``MEGASTEP_COLLECTIVE``,
    ``WIRE_BYTE_BUDGET`` (tiered/phased, ``plan`` the plan the run routed
    with) and, on a mesh, ``KIND_NOT_IN_REFERENCE`` against
    :data:`REFERENCE_KINDS`; with ``reference`` (the JAX loop's counts by
    primitive) the folded counts must match it, else a
    ``COUNT_DIFFERS_FROM_REFERENCE`` warning."""
    out: List[Violation] = []
    if exchange == "megastep" and summary.ops:
        out.append(Violation(
            pass_name="collectives", code="MEGASTEP_COLLECTIVE",
            where=f"{where} ({summary.ops[0].source})",
            detail=(f"the fused megastep run issued collectives "
                    f"{_counts(summary.ops)}: the single-launch route must "
                    "never touch the wire"),
            severity=ERROR))
    if exchange in ("tiered", "phased") and plan is not None:
        budgets = byte_budgets(plan, num_parts, cap, D, Q)
        for o in summary.ops:
            kind = BUDGET_KIND.get(o.kind)
            if kind is None:
                continue
            limit = budgets[kind]
            if kind == "all-to-all" and (exchange == "phased"
                                         or o.route == "dense-retry"):
                limit = max(limit, budgets["dense"])
            if o.nbytes > limit:
                out.append(Violation(
                    pass_name="collectives", code="WIRE_BYTE_BUDGET",
                    where=f"{where} ({o.source})",
                    detail=(f"{o.kind} of {o.nbytes} bytes in the "
                            f"{o.phase} phase (superstep {o.step}) exceeds "
                            f"the tier schedule's {kind} budget of {limit} "
                            "bytes a rank: the run ships traffic the "
                            "plan's wire geometry never predicted"),
                    severity=ERROR))
    if backend == "shard_map" and exchange in REFERENCE_KINDS:
        ref = {REF_KIND[k] for k in REFERENCE_KINDS[exchange]}
        got = set(fold(dict.fromkeys(summary.superstep_kinds(), 1),
                       PORT_CLASS))
        if not got <= ref:
            out.append(Violation(
                pass_name="collectives", code="KIND_NOT_IN_REFERENCE",
                where=where,
                detail=(f"the {exchange} loop's supersteps issue "
                        f"{sorted(got - ref)}, which the JAX package's "
                        f"{exchange} loop never does (its kinds, mapped: "
                        f"{sorted(ref)})"),
                severity=ERROR))
        if reference is not None:
            want = fold(reference, REF_KIND)
            have = summary.static_counts()
            if want != have:
                out.append(Violation(
                    pass_name="collectives",
                    code="COUNT_DIFFERS_FROM_REFERENCE", where=where,
                    detail=(f"per-kind counts (prime + one superstep) "
                            f"{have} != the JAX loop's {want} (kind sets "
                            "agree; a shift is one batch_isend_irecv "
                            "where JAX issues a ppermute per array)"),
                    severity=WARNING))
    return out


@contextlib.contextmanager
def recording(engine):
    """Record one of ``engine``'s runs: a :class:`Recorder` on the
    engine's mesh group (none on 'local'), and the engine's tracer wrapped
    so the recorder sees its spans. Yields the recorder."""
    rec = Recorder(engine._ranks.group)
    inner = engine.tracer
    engine._sentinel_tr = rec.tracer(inner)
    try:
        with rec:
            yield rec
    finally:
        engine._sentinel_tr = None
