"""Gopher Sentinel Pass 2: the semiring law checker.

The port of the JAX package's ``analysis/semiring.py``: the same
:class:`SemiringSpec` registry, the same probes and the same codes, so
both packages report a program violation for violation. The exchange
stack's correctness claims lean on algebra the code never states in one
place:

- **⊕ idempotence** (``a ⊕ a = a``) is what makes the tiered/phased
  dense-retry *unconditionally exact*: an overflowing superstep re-delivers
  every message through the dense route, so values already folded in by the
  partial tiered delivery get folded in twice — harmless iff ⊕ is
  idempotent. ``min`` (SSSP/BFS) and ``max`` (CC) are; ``sum`` (PageRank)
  is NOT, which is why the engine never retries a sum-combine superstep and
  why PageRank parity across exchange modes is allclose-only.
- **⊗ right-distributivity over ⊕** and **identity annihilation**
  (``extend(0̄, w) = 0̄``) are what let the local-fixpoint sweep reorder
  relaxations and pad ELL rows with the identity without changing fixpoints.
- **bitwise exactness**: ``min``/``max`` over float32 are order-independent
  bit-for-bit (the cross-mode bit-identical gates rely on this); float
  ``+`` is only associative to rounding, so ``plus_times`` programs get an
  ``allclose``-only exactness class.

Each registered semiring's *declared* properties are probed over a small
adversarial domain (identities, ±, zero) at validate time, so a semiring
whose declaration overclaims fails loudly with the law and the
counterexample.

Where the identities live in the port. The mailbox pads absent messages
with ``kernels.flat.COMBINE_IDENTITY``; the serving sweeps with
``kernels.ops._IDENT``; the plain sweeps (``kernels/ref.py``) give an
all-PAD row the identity inline, so :func:`check_semiring` runs one all-PAD
row through ``semiring_spmv_ref`` and reads it back. The CUDA kernels take
theirs as literals: ``csrc/semiring_spmv.cu`` in K1's and K2's
accumulators (``SR == kMinPlus ? INFINITY : ...``) and
``csrc/megastep.cu``'s ``ident<MINP>()`` (K3, K4); K5 receives the
identity as an argument. There is no ``_IDENT`` table to import for them:
Pass 3 (``analysis.kernel_lint``, ``IDENTITY_MISMATCH``) reads those
literals out of the sources and holds them to this registry.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Tuple

from repro_torch.analysis.report import ERROR, INFO, Violation

BITWISE = "bitwise"
ALLCLOSE = "allclose"


@dataclasses.dataclass(frozen=True)
class SemiringSpec:
    """One ⊕/⊗ pair as the execution path uses it: ``plus`` folds messages
    (inbox combine, outbox pack reduce), ``extend(value, weight)`` relaxes
    along an edge. ``plus_identity`` must equal the pad value routed for
    absent messages (kernels.flat.COMBINE_IDENTITY). The ``declares_*`` flags
    are the contract the probes check."""
    name: str
    combine: str                       # engine-side name: 'min'|'max'|'sum'
    plus: Callable[[float, float], float]
    extend: Callable[[float, float], float]
    plus_identity: float
    declares_idempotent: bool
    exactness: str                     # BITWISE | ALLCLOSE
    # probe domains — small but adversarial (identities, signs, zero)
    values: Tuple[float, ...]
    weights: Tuple[float, ...]


def _min(a, b):
    return a if a <= b else b


def _max(a, b):
    return a if a >= b else b


REGISTRY: Dict[str, SemiringSpec] = {
    "min_plus": SemiringSpec(
        name="min_plus", combine="min",
        plus=_min, extend=lambda v, w: v + w,
        plus_identity=math.inf, declares_idempotent=True,
        exactness=BITWISE,
        values=(math.inf, 0.0, 1.0, 2.5, 7.0, -3.0),
        weights=(0.0, 1.0, 2.5, 7.0)),
    "max_first": SemiringSpec(
        name="max_first", combine="max",
        plus=_max, extend=lambda v, w: v,   # left projection: labels hop
        plus_identity=-math.inf, declares_idempotent=True,
        exactness=BITWISE,
        values=(-math.inf, -3.0, 0.0, 1.0, 7.0, 512.0),
        weights=(0.0, 1.0, 2.5)),
    "plus_times": SemiringSpec(
        name="plus_times", combine="sum",
        plus=lambda a, b: a + b, extend=lambda v, w: v * w,
        plus_identity=0.0, declares_idempotent=False,
        exactness=ALLCLOSE,
        values=(0.0, 1.0, 2.5, -3.0, 0.5),
        weights=(0.0, 1.0, 0.5, 2.0)),
}

COMBINE_TO_SEMIRING = {s.combine: s.name for s in REGISTRY.values()}


def _eq(spec: SemiringSpec, a: float, b: float) -> bool:
    if a == b:
        return True
    if math.isnan(a) and math.isnan(b):
        return True
    if spec.exactness == ALLCLOSE:
        return abs(a - b) <= 1e-6 * max(1.0, abs(a), abs(b))
    return False


def _law(spec, code, law, lhs_desc, rhs_desc, lhs, rhs, binding, out):
    if not _eq(spec, lhs, rhs):
        out.append(Violation(
            pass_name="semiring", code=code,
            where=f"semiring '{spec.name}'",
            detail=(f"{law} fails: {lhs_desc} = {lhs!r} but {rhs_desc} = "
                    f"{rhs!r} at {binding} (exactness={spec.exactness}) — "
                    "the sweep/exchange path assumes this law; fix the "
                    "operator or its declaration in analysis.semiring"
                    ".REGISTRY"),
            severity=ERROR))
        return False
    return True


def probe_laws(spec: SemiringSpec) -> List[Violation]:
    """Exhaustively probe the algebraic laws the engine relies on over the
    spec's value/weight domain. Every failure names the law AND the
    counterexample binding."""
    out: List[Violation] = []
    V, W = spec.values, spec.weights
    p, x = spec.plus, spec.extend
    e = spec.plus_identity

    for a, b in itertools.product(V, repeat=2):
        _law(spec, "PLUS_NOT_COMMUTATIVE", "⊕ commutativity",
             f"({a} ⊕ {b})", f"({b} ⊕ {a})", p(a, b), p(b, a),
             f"a={a}, b={b}", out)
    for a, b, c in itertools.product(V, repeat=3):
        _law(spec, "PLUS_NOT_ASSOCIATIVE", "⊕ associativity",
             f"(({a} ⊕ {b}) ⊕ {c})", f"({a} ⊕ ({b} ⊕ {c}))",
             p(p(a, b), c), p(a, p(b, c)), f"a={a}, b={b}, c={c}", out)
    for a in V:
        _law(spec, "PLUS_IDENTITY_WRONG", "⊕ identity",
             f"({a} ⊕ 0̄)", f"{a}", p(a, e), a, f"a={a}, 0̄={e}", out)
    if spec.declares_idempotent:
        for a in V:
            ok = _law(spec, "PLUS_NOT_IDEMPOTENT", "⊕ idempotence",
                      f"({a} ⊕ {a})", f"{a}", p(a, a), a, f"a={a}", out)
            if not ok:
                # idempotence is THE dense-retry precondition — say so once
                out[-1] = dataclasses.replace(out[-1], detail=(
                    out[-1].detail + " [idempotent ⊕ is required for the "
                    "tiered/phased dense-retry exactness claim: retried "
                    "supersteps re-fold already-delivered messages]"))
                break
    for b, c in itertools.product(V, repeat=2):
        for w in W:
            _law(spec, "EXTEND_NOT_DISTRIBUTIVE",
                 "⊗ right-distributivity over ⊕",
                 f"extend({b} ⊕ {c}, {w})",
                 f"extend({b},{w}) ⊕ extend({c},{w})",
                 x(p(b, c), w), p(x(b, w), x(c, w)),
                 f"b={b}, c={c}, w={w}", out)
    for w in W:
        _law(spec, "IDENTITY_NOT_ANNIHILATING", "0̄ annihilation under ⊗",
             f"extend(0̄, {w})", "0̄", x(e, w), e, f"0̄={e}, w={w}", out)
    return out


def _plain_identity(name: str):
    """What ``kernels.ref.semiring_spmv_ref`` gives a row of PAD lanes
    under ``name`` (None for a semiring it does not know)."""
    import torch

    from repro_torch.gofs.formats import PAD
    from repro_torch.kernels.ref import SEMIRINGS, semiring_spmv_ref
    if name not in SEMIRINGS:
        return None
    y = semiring_spmv_ref(torch.zeros(1), torch.full((1, 2), PAD,
                                                     dtype=torch.int32),
                          torch.ones(1, 2), name)
    return float(y[0])


def check_semiring(name: str) -> List[Violation]:
    """Pass 2 for one registered semiring: probe its laws and cross-check
    its ⊕ identity against the pad value the mailbox routes
    (``kernels.flat.COMBINE_IDENTITY``), the serving sweeps' table
    (``kernels.ops._IDENT``) and the plain sweep's all-PAD row
    (``kernels.ref.semiring_spmv_ref``)."""
    if name not in REGISTRY:
        return [Violation(
            pass_name="semiring", code="UNKNOWN_SEMIRING",
            where=f"semiring '{name}'",
            detail=(f"no SemiringSpec registered for '{name}' (known: "
                    f"{sorted(REGISTRY)}); register one in analysis."
                    "semiring.REGISTRY so its laws can be checked"),
            severity=ERROR)]
    spec = REGISTRY[name]
    out = probe_laws(spec)

    from repro_torch.kernels.flat import COMBINE_IDENTITY
    routed = float(COMBINE_IDENTITY[spec.combine])
    if routed != spec.plus_identity:
        out.append(Violation(
            pass_name="semiring", code="IDENTITY_MISMATCH",
            where=f"semiring '{name}'",
            detail=(f"kernels.flat.COMBINE_IDENTITY['{spec.combine}'] = "
                    f"{routed} but the semiring's ⊕ identity is "
                    f"{spec.plus_identity}: absent-message pad slots would "
                    "perturb folded values"),
            severity=ERROR))
    from repro_torch.kernels.ops import _IDENT
    if name in _IDENT and float(_IDENT[name]) != spec.plus_identity:
        out.append(Violation(
            pass_name="semiring", code="IDENTITY_MISMATCH",
            where=f"semiring '{name}'",
            detail=(f"kernels.ops._IDENT['{name}'] = {_IDENT[name]} "
                    f"disagrees with the ⊕ identity {spec.plus_identity}"),
            severity=ERROR))
    plain = _plain_identity(name)
    if plain is not None and plain != spec.plus_identity:
        out.append(Violation(
            pass_name="semiring", code="IDENTITY_MISMATCH",
            where=f"semiring '{name}'",
            detail=(f"kernels.ref.semiring_spmv_ref gives an all-PAD row "
                    f"{plain}, not the ⊕ identity {spec.plus_identity}"),
            severity=ERROR))
    return out


def check_program(program, exchange: str = "auto") -> List[Violation]:
    """Pass 2 for one engine program: resolve its semiring (SemiringProgram
    declares one; PageRank-style programs are resolved via their ``combine``
    op), probe the laws, and — when the program rides an exchange mode with
    a dense-retry path (tiered/phased/auto) — record the exactness class
    the retry actually delivers."""
    name = getattr(program, "semiring", None)
    if name is None:
        combine = getattr(program, "combine", None)
        name = COMBINE_TO_SEMIRING.get(combine)
        if name is None:
            return [Violation(
                pass_name="semiring", code="UNKNOWN_SEMIRING",
                where=type(program).__name__,
                detail=("program declares neither .semiring nor a known "
                        f".combine (got {combine!r}); cannot check laws"),
                severity=ERROR)]
    out = check_semiring(name)
    spec = REGISTRY.get(name)
    if (spec is not None and not spec.declares_idempotent
            and exchange in ("tiered", "phased", "auto", "megastep")):
        out.append(Violation(
            pass_name="semiring", code="ALLCLOSE_ONLY",
            where=f"{type(program).__name__} (semiring '{name}')",
            detail=(f"⊕ = '{spec.combine}' is not idempotent, so the "
                    f"{exchange} path cannot re-deliver or re-associate "
                    "messages exactly — cross-mode parity for this "
                    "program is allclose-only, not bit-identical (the "
                    "engine never retries sum-combine supersteps, and the "
                    "fused megastep route re-associates the ⊕ reduction; "
                    "this is informational)"),
            severity=INFO))
    return out
