"""Gopher Sentinel — checks over the engine's riskiest constructs.

The port of the JAX package's ``analysis``, three passes (see each
module's docstring for the invariants):

- :mod:`repro_torch.analysis.collectives` — Pass 1, the collective
  recorder: cross-rank agreement before every collective, group binding,
  static tier plans, and the megastep, byte-budget and reference-kind
  rules on a finished run. The JAX walk is static over a jaxpr; this pass
  is DYNAMIC: it covers the branches the validated run takes.
- :mod:`repro_torch.analysis.semiring` — Pass 2, the semiring law checker,
  violation for violation the JAX package's.
- :mod:`repro_torch.analysis.kernel_lint` — Pass 3, the CUDA-source
  linter: grid divisibility, guarded stores, ±inf-safe selects, PAD
  lanes, ``__restrict__`` aliasing, identity literals.

``GopherEngine(..., validate=True)`` runs Pass 2 and the plan check when
it is built and Pass 1 on the first run of each configuration (a later run
of a configuration that passed is a plain run); ``python -m
repro_torch.launch.sentinel`` runs the whole matrix plus Pass 3.
"""
import tempfile

from repro_torch.analysis.collectives import (
    BUDGET_KIND,
    PORT_CLASS,
    REF_KIND,
    REFERENCE_COUNTS,
    REFERENCE_KINDS,
    CollectiveOp,
    CollectiveSummary,
    Recorder,
    check_plan_static,
    check_run,
    recording,
)
from repro_torch.analysis.kernel_lint import (
    lint_cuda_source,
    lint_kernel_file,
    lint_kernels,
    lint_source,
    lint_wrapper_source,
)
from repro_torch.analysis.report import (
    ERROR,
    INFO,
    WARNING,
    SentinelError,
    Violation,
    assert_clean,
    errors,
    split_severity,
)
from repro_torch.analysis.semiring import (
    REGISTRY,
    SemiringSpec,
    check_program,
    check_semiring,
    probe_laws,
)

__all__ = [
    "ERROR", "INFO", "WARNING", "BUDGET_KIND", "PORT_CLASS", "REF_KIND",
    "REFERENCE_COUNTS", "REFERENCE_KINDS", "REGISTRY",
    "CollectiveOp", "CollectiveSummary", "Recorder", "SemiringSpec",
    "SentinelError", "Violation",
    "assert_clean", "check_plan_static", "check_program", "check_run",
    "check_semiring", "errors", "lint_cuda_source", "lint_kernel_file",
    "lint_kernels", "lint_source", "lint_wrapper_source", "probe_laws",
    "recording", "split_severity", "validate_config", "validate_engine",
    "validate_service", "validate_stage_fns", "validated_run",
]


def validate_config(program, exchange: str, tier_plan=None):
    """What ``GopherEngine(validate=True)`` checks when it is built: the
    tier plan's staticness (before the engine uses the plan) and the
    program's semiring laws on ``exchange``. Raises
    :class:`SentinelError` on error-severity findings; returns every
    finding."""
    violations = list(check_plan_static(tier_plan))
    violations += check_program(program, exchange)
    assert_clean(violations)
    return violations


def _config_key(engine, loop: str) -> tuple:
    """A run's configuration: the loop ('run' or 'checkpointed'), program,
    backend, exchange, plan, Q, D, P, v_max and cap — the JAX package's
    compiled-loop cache key."""
    prog = engine.program
    try:
        hash(prog)
    except TypeError:
        prog = id(prog)
    pg = engine.pg
    return (loop, prog, engine.backend, engine.exchange, engine.tier_plan,
            engine.num_queries, engine._ranks.D, pg.num_parts, pg.v_max,
            pg.mailbox_cap)


def _record(engine, loop: str, fn):
    """Run ``fn`` (one of ``engine``'s runs) under the recorder and hold
    its record to :func:`check_run`. Returns (fn's result, the
    CollectiveSummary, [Violation]); raises :class:`SentinelError` on an
    error, on every rank alike."""
    plan = engine.tier_plan            # the plan this run routes with
    exchange = engine.exchange
    if loop == "checkpointed" and exchange in ("megastep", "tiered",
                                               "phased"):
        exchange = "compact"           # the loop _run_checkpointed takes
    with recording(engine) as rec:
        out = fn()
    summary = rec.summary()
    pg = engine.pg
    where = (f"{type(engine.program).__name__}/{exchange}/"
             f"{engine.backend}/D={engine._ranks.D}")
    vs = check_run(summary, exchange, engine.backend, plan=plan,
                   num_parts=pg.num_parts, cap=pg.mailbox_cap,
                   D=engine._ranks.D, Q=engine.num_queries, where=where)
    engine.sentinel = (summary, vs)
    assert_clean(vs)
    return out, summary, vs


def validated_run(engine, loop: str, fn):
    """``fn()`` — one run of a validating engine — under Pass 1 if its
    configuration has not passed yet (see :func:`_config_key`), else as it
    is. The run's result is exactly an unvalidated run's."""
    key = _config_key(engine, loop)
    if key in engine._validated:
        return fn()
    out, _, _ = _record(engine, loop, fn)
    engine._validated.add(key)
    return out


def validate_engine(engine, extra=None):
    """Passes 1–2 for one engine configuration: the plan and the
    program's laws, then ONE run of the engine (``run_queries(extra)`` for
    a query batch, else ``run(extra=extra)``) under the recorder with
    cross-rank agreement (every rank of a mesh calls this). Raises
    :class:`SentinelError` naming every offending site, field or law;
    returns (CollectiveSummary, [Violation]) with the warnings and infos
    when clean."""
    violations = validate_config(engine.program, engine.exchange,
                                 engine.tier_plan)
    _, summary, vs = _record(engine, "run", lambda: engine._run(extra))
    return summary, violations + vs


def validate_stage_fns(engine, extra=None):
    """Pass 1 over the STAGED STEPPED DRIVER: the loop checkpointed and
    recovered runs take (``GopherEngine._run_checkpointed``; megastep,
    tiered and phased engines take it on 'compact', as the JAX package
    does), run once under the recorder with one snapshot at its end into a
    temporary directory. Raises :class:`SentinelError` on error-severity
    findings; returns ({stage: {kind: count}}, [Violation]): the prime's
    collectives under 'init', each superstep stage's ('sweep', 'pack',
    'exchange', 'halt-vote') at their most, the snapshot's under
    'checkpoint' and the run's end under 'end'."""
    from repro_torch.training.checkpoint import Checkpointer
    violations = validate_config(engine.program, engine.exchange,
                                 engine.tier_plan)
    with tempfile.TemporaryDirectory(prefix="sentinel_ck_") as d:
        ck = Checkpointer(d)
        _, summary, vs = _record(engine, "checkpointed", lambda: (
            engine._run_checkpointed(ck, engine.max_supersteps + 1, False,
                                     extra=extra)))
    return summary.stage_counts(), violations + vs


def validate_service(svc, graphs=None, families=("reach",), qs=(1,)):
    """Sentinel over a GraphQueryService's pooled batched loops: for every
    (graph, family, Q-bucket) the engine ``drain()`` would dispatch
    (``svc._engine``) is validated on the real query arrays the service
    builds for Q lanes (``svc._query_arrays``): plan, laws, and one
    recorded batch with cross-rank agreement. The port serves a batch
    through ``run_queries`` only (no checkpointed replay), so there is no
    staged stepped driver of a query batch to validate besides. Raises
    :class:`SentinelError` on any error-severity finding; returns
    {(graph, family, Q): [Violation]}."""
    out = {}
    for name in (sorted(svc.graphs) if graphs is None else graphs):
        pg = svc.graphs[name]
        for family in families:
            for Q in qs:
                extra, _ = svc._query_arrays(pg, family, [(0,)] * Q)
                eng = svc._engine(name, family, Q)
                _, vs = validate_engine(eng, extra=extra)
                out[(name, family, Q)] = vs
    return out
