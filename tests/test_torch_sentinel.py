"""The port's Gopher Sentinel (``repro_torch.analysis``) on the CPU, in
process, against the JAX package's ``repro.analysis``:

  * Pass 2 violation for violation the JAX package's, for every
    registered semiring and for CC/SSSP/BFS/PageRank on every exchange;
  * the seeded negatives of the JAX package's tests in torch form (a tensor
    or an array in a plan field, bad geometry, ``validate=True`` refusing
    a bad plan, overclaimed idempotence, a wrong identity, PageRank
    ``ALLCLOSE_ONLY``) and the run rules (megastep collective, byte
    budget);
  * Pass 3 clean on the repo's CUDA sources and wrappers, and one seeded
    CUDA-source negative per rule, each caught with its file:line and
    kernel name;
  * ``validate=True`` on the local backend: bit-equal state and equal
    Telemetry on every route, nothing recorded, one check a
    configuration;
  * the ``Violation`` JSON round trip between the packages.
The mesh half (agreement, group binding, the reference's kinds) is in
``tests/test_torch_sentinel_mesh.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro import analysis as jan  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro_torch import analysis as tan  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.analysis import kernel_lint  # noqa: E402
from repro_torch.analysis.collectives import (CollectiveOp,  # noqa: E402
                                              CollectiveSummary)
from repro_torch.core import (GopherEngine, PhasedTierPlan,  # noqa: E402
                              SemiringProgram, Telemetry, TierPlan,
                              init_max_vertex, make_bfs_init)
from repro_torch.gofs import bfs_grow_partition, road_grid  # noqa: E402
from repro_torch.gofs.formats import partition_graph  # noqa: E402

EXCHANGES = ("auto", "dense", "compact", "tiered", "phased", "megastep")


@pytest.fixture(scope="module")
def pg8():
    g = road_grid(10, 10, drop_frac=0.05, seed=1, weighted=True)
    return partition_graph(g, bfs_grow_partition(g, 8, seed=0), 8)


def _keys(vs):
    return [(v.code, v.where, v.severity) for v in vs]


def _programs(core, pg):
    sp, sl = int(pg.part_of[0]), int(pg.local_of[0])
    return {
        "cc": core.SemiringProgram(semiring="max_first",
                                   init_fn=core.init_max_vertex),
        "sssp": core.SemiringProgram(semiring="min_plus",
                                     init_fn=core.make_sssp_init(sp, sl)),
        "bfs": core.SemiringProgram(semiring="min_plus",
                                    init_fn=core.make_bfs_init(sp, sl)),
        "pagerank": core.PageRankProgram(n_global=pg.n_global, num_iters=5),
    }


def test_semiring_pass_matches_jax(pg8):
    """Every registered semiring and every program × exchange: the same
    (code, where, severity) list as the JAX package, PageRank's
    ALLCLOSE_ONLY info included."""
    assert set(tan.REGISTRY) == set(jan.REGISTRY)
    for name in list(jan.REGISTRY) + ["no_such_semiring"]:
        assert _keys(tan.check_semiring(name)) == \
            _keys(jan.check_semiring(name)), name
    jprogs, tprogs = _programs(jcore, pg8), _programs(tcore, pg8)
    seen_info = 0
    for algo in tprogs:
        for ex in EXCHANGES:
            got = _keys(tan.check_program(tprogs[algo], ex))
            want = _keys(jan.check_program(jprogs[algo], ex))
            assert got == want, (algo, ex, got, want)
            seen_info += sum(c == "ALLCLOSE_ONLY" for c, _, _ in got)
    assert seen_info == 4             # PageRank on tiered/phased/auto/megastep
    for spec in jan.REGISTRY.values():
        pspec = tan.REGISTRY[spec.name]
        assert _keys(tan.probe_laws(pspec)) == _keys(jan.probe_laws(spec))


def test_plan_negatives_and_the_validate_hook(pg8):
    """A tensor or an array in a plan field (PLAN_UNHASHABLE_FIELD: a
    tensor hashes by identity, so it is caught explicitly), a non-static
    field, bad geometry and bad boundaries, each as the JAX package
    reports it; GopherEngine(validate=True) refuses the bad plan when it
    is built, naming the field, and never raises NotImplementedError."""
    base = TierPlan(num_parts=2, cap=4, warm_cap=2, tier_bytes=bytes(4))
    jbase = jcore.TierPlan(num_parts=2, cap=4, warm_cap=2,
                           tier_bytes=bytes(4))
    for field, value in (("tier_bytes", np.zeros(4, np.uint8)),
                         ("tier_bytes", [0, 0, 0, 0])):
        bad, jbad = dataclasses.replace(base), dataclasses.replace(jbase)
        object.__setattr__(bad, field, value)
        object.__setattr__(jbad, field, value)
        assert _keys(tan.check_plan_static(bad)) == \
            _keys(jan.check_plan_static(jbad))
    bad = dataclasses.replace(base)
    object.__setattr__(bad, "tier_bytes", torch.zeros(4, dtype=torch.uint8))
    errs = tan.errors(tan.check_plan_static(bad))
    assert [(v.code, v.where) for v in errs] == [
        ("PLAN_UNHASHABLE_FIELD", "tier_plan.tier_bytes")]
    assert "Tensor" in errs[0].detail
    geo = TierPlan(num_parts=3, cap=4, warm_cap=2, tier_bytes=bytes(4))
    jgeo = jcore.TierPlan(num_parts=3, cap=4, warm_cap=2, tier_bytes=bytes(4))
    assert _keys(tan.check_plan_static(geo)) == \
        _keys(jan.check_plan_static(jgeo)) == [
            ("PLAN_BAD_GEOMETRY", "tier_plan", "error")]
    ph = PhasedTierPlan(num_parts=2, cap=4, warm_cap=2,
                        phase_tier_bytes=(bytes(4), bytes(4)),
                        boundaries=(5, 3))
    jph = jcore.PhasedTierPlan(num_parts=2, cap=4, warm_cap=2,
                               phase_tier_bytes=(bytes(4), bytes(4)),
                               boundaries=(5, 3))
    assert _keys(tan.check_plan_static(ph)) == \
        _keys(jan.check_plan_static(jph)) == [
            ("PLAN_BAD_GEOMETRY", "tier_plan.boundaries", "error")]
    assert tan.check_plan_static(base) == []

    plan = TierPlan.from_graph(pg8)
    for bad_value in (np.frombuffer(plan.tier_bytes, np.uint8).copy(),
                      torch.frombuffer(bytearray(plan.tier_bytes),
                                       dtype=torch.uint8)):
        bad = dataclasses.replace(plan)
        object.__setattr__(bad, "tier_bytes", bad_value)
        with pytest.raises(tan.SentinelError) as ei:
            GopherEngine(pg8, SemiringProgram("max_first", init_max_vertex),
                         exchange="tiered", tier_plan=bad, validate=True,
                         device="cpu")
        assert "tier_plan.tier_bytes" in str(ei.value)
        assert [v.code for v in ei.value.violations] == [
            "PLAN_UNHASHABLE_FIELD"]


def test_semiring_negatives(monkeypatch, pg8):
    """Overclaimed idempotence (with the dense-retry consequence), a wrong
    ⊕ identity in the spec and in the mailbox's table, and an unknown
    program: the JAX package's codes."""
    bad = dataclasses.replace(tan.REGISTRY["plus_times"], name="bad_sum",
                              declares_idempotent=True)
    errs = tan.errors(tan.probe_laws(bad))
    v = next(v for v in errs if v.code == "PLUS_NOT_IDEMPOTENT")
    assert "a=" in v.detail and "dense-retry" in v.detail
    jbad = dataclasses.replace(jan.REGISTRY["plus_times"], name="bad_sum",
                               declares_idempotent=True)
    assert _keys(errs) == _keys(jan.errors(jan.probe_laws(jbad)))
    wrong = dataclasses.replace(tan.REGISTRY["min_plus"], plus_identity=0.0)
    codes = {v.code for v in tan.errors(tan.probe_laws(wrong))}
    assert {"PLUS_IDENTITY_WRONG", "IDENTITY_NOT_ANNIHILATING"} <= codes
    from repro_torch.kernels import flat, ops
    monkeypatch.setitem(flat.COMBINE_IDENTITY, "min", 0.0)
    monkeypatch.setitem(ops._IDENT, "min_plus", 0.0)
    vs = tan.check_semiring("min_plus")
    assert [v.code for v in vs] == ["IDENTITY_MISMATCH"] * 2
    assert "COMBINE_IDENTITY" in vs[0].detail and "_IDENT" in vs[1].detail
    with pytest.raises(tan.SentinelError, match="IDENTITY_MISMATCH"):
        GopherEngine(pg8, SemiringProgram("min_plus", make_bfs_init(0, 0)),
                     validate=True, device="cpu")
    monkeypatch.undo()

    class Custom:
        combine = "xor"
    assert [v.code for v in tan.check_program(Custom())] == \
        [v.code for v in jan.check_program(Custom())] == ["UNKNOWN_SEMIRING"]


def test_run_rules_on_a_record(pg8):
    """A megastep run that records a collective (MEGASTEP_COLLECTIVE), a
    tiered shift past its schedule's byte budget and a dense block past a
    tiered run's all-to-all budget (WIRE_BYTE_BUDGET; the phased loop's
    dense retry may ship the dense round), and a superstep kind the JAX
    loop never issues (KIND_NOT_IN_REFERENCE), each named with its
    file:line."""
    plan = TierPlan.from_graph(pg8)
    P, cap = pg8.num_parts, pg8.mailbox_cap
    budgets = tan.collectives.byte_budgets(plan, P, cap, 4, None)

    def op(kind, nbytes, phase="superstep", route=""):
        return CollectiveOp(kind=kind, op="", ranks=(0, 1, 2, 3),
                            shape=(nbytes // 4,), dtype="float32",
                            nbytes=nbytes, source="core/messages.py:99",
                            phase=phase, stage="exchange", step=0,
                            route=route)
    rec = CollectiveSummary([op("all_reduce", 8)], [], 1)
    vs = tan.check_run(rec, "megastep", "local", where="cc/megastep")
    assert _keys(vs) == [("MEGASTEP_COLLECTIVE",
                          "cc/megastep (core/messages.py:99)", "error")]
    shift = op("batch_isend_irecv", budgets["collective-permute"] + 4)
    dense = op("all_to_all_single", budgets["dense"])
    vs = tan.check_run(CollectiveSummary([shift, dense], [], 1), "tiered",
                       "shard_map", plan, P, cap, 4, None, where="t")
    assert [v.code for v in vs] == ["WIRE_BYTE_BUDGET"] * 2
    assert all("core/messages.py:99" in v.where for v in vs)
    # the same dense round is within a phased run's budget, and within a
    # tiered run's inside its dense rerun
    ph = PhasedTierPlan.from_tier_plan(plan)
    assert tan.check_run(CollectiveSummary([dense], [], 1), "phased",
                         "shard_map", ph, P, cap, 4, None) == []
    rerun = op("all_to_all_single", budgets["dense"], route="dense-retry")
    assert tan.check_run(CollectiveSummary([rerun], [], 1), "tiered",
                         "shard_map", plan, P, cap, 4, None) == []
    vs = tan.check_run(CollectiveSummary([op("broadcast", 8)], [], 1),
                       "dense", "shard_map", where="d")
    assert [v.code for v in vs] == ["KIND_NOT_IN_REFERENCE"]
    # the run-end gathers stay out of the kind comparison
    assert tan.check_run(CollectiveSummary(
        [op("all_gather", 8, phase="end")], [], 1), "dense",
        "shard_map") == []


def test_kernel_lint_clean_on_the_repo():
    """The repo's CUDA sources (the eight kernels' and the barrier probe's)
    and their wrappers report no error and no warning; what the pass
    cannot prove stays visible as INFO."""
    vs = tan.lint_kernels()
    assert [str(v) for v in vs if v.severity != "info"] == []
    assert {v.code for v in vs} <= {"GRID_UNRESOLVED", "IO_ALIAS"}
    files = {v.where.split(":")[0] for v in vs}
    assert "semiring_spmv.cu" not in files    # every grid there is proven


_HEAD = ("#include <cuda_runtime.h>\n#include <stdint.h>\nnamespace {\n"
         "constexpr int kPad = -1;\n"
         "enum Semiring { kMinPlus = 0, kMaxFirst = 1, kPlusTimes = 2 };\n")
_SEEDS = {
    "CUDA_UNGUARDED_STORE": ("store.cu (kernel bad_store)", """
__global__ void bad_store(const float* __restrict__ x,
                          float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  y[i] = x[i] * 2.0f;  // here
}
}
"""),
    "CUDA_GRID_DIVISIBILITY": ("grid.cu (launcher go)", """
__global__ void fill(float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = 0.f;
}
}
extern "C" int go(void* y, int n) {
  const int blocks = n / 256;
  fill<<<blocks, 256>>>((float*)y, n);  // here
  return 0;
}
"""),
    "CUDA_MASK_MULTIPLY": ("mask.cu (kernel bad_mask)", """
__global__ void bad_mask(const float* __restrict__ x,
                         const uint8_t* __restrict__ m,
                         float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  y[i] = v * (float)i;
  y[i] = v * m[i];  // here
}
}
"""),
    "PAD_LANE_UNCHECKED": ("pad.cu (kernel bad_pad)", """
__global__ void bad_pad(const float* __restrict__ x,
                        const int* __restrict__ nbr, float* __restrict__ y,
                        int rows, int d) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float acc = INFINITY;
  for (int j = 0; j < d; ++j) {
    const int s = __ldg(nbr + row * d + j);
    acc = fminf(acc, __ldg(x + s));  // here
  }
  y[row] = acc;
}
}
"""),
    "IDENTITY_MISMATCH": ("ident.cu (kernel bad_ident)", """
template <int SR>
__global__ void bad_ident(float* __restrict__ y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  y[i] = SR == kMinPlus ? -INFINITY : -INFINITY;  // here
}
}
"""),
    "PARSE_ERROR": ("parse.cu", "__global__ void k(int* y) {  // here\n"),
}


def test_kernel_lint_seeded_negatives():
    """One seeded CUDA source per rule, each caught alone with its
    file:line and kernel name; the same faults cut into the repo's own K1/
    K2 and K3/K4 sources (a guard, a ceil-div, a PAD test, an identity
    literal) are caught at their line; a wrapper passing one tensor as the
    input and the output of the restrict-qualified K1 is an IO_ALIAS."""
    for code, (where, body) in _SEEDS.items():
        name, _, kernel = where.partition(" ")
        src = _HEAD + body
        line = next(i for i, t in enumerate(src.splitlines(), 1)
                    if "// here" in t)
        where = f"{name}:{line}" + (f" {kernel}" if kernel else "")
        vs = [v for v in tan.lint_cuda_source(src, name)
              if v.severity != "info"]
        assert _keys(vs) == [(code, where, "warning" if code ==
                              "PAD_LANE_UNCHECKED" else "error")], (code, vs)
    csrc = kernel_lint._csrc()
    spmv = open(f"{csrc}/semiring_spmv.cu").read()
    mega = open(f"{csrc}/megastep.cu").read()
    cuts = [
        (spmv, "  if (row >= rows) return;\n  const int* nr",
         "  const int* nr", "CUDA_UNGUARDED_STORE", "semiring_spmv.cu:71"),
        (spmv, "(rows + kThreads - 1) / kThreads", "rows / kThreads",
         "CUDA_GRID_DIVISIBILITY", "semiring_spmv.cu:131"),
        (spmv, "    if (s == kPad) continue;\n    const float g",
         "    const float g", "PAD_LANE_UNCHECKED", "semiring_spmv.cu:61"),
        (spmv, "SR == kMinPlus ? INFINITY : (SR", "SR == kMinPlus ? 0.0f : (SR",
         "IDENTITY_MISMATCH", "semiring_spmv.cu:58"),
        (mega, "return MINP ? INFINITY : -INFINITY;",
         "return MINP ? -INFINITY : -INFINITY;", "IDENTITY_MISMATCH",
         "megastep.cu:149"),
        (mega, "for (int v = gtid; v < n; v += stride) {\n    const float x",
         "for (int v = gtid; ; v += stride) {\n    const float x",
         "CUDA_UNGUARDED_STORE", "megastep.cu:723"),
    ]
    for src, old, new, code, at in cuts:
        assert old in src, old
        cut = src.replace(old, new, 1)
        vs = [v for v in tan.lint_cuda_source(cut, at.split(":")[0])
              if v.severity != "info"]
        assert vs and {v.code for v in vs} == {code}, (code, vs)
        assert vs[0].where.startswith(at + " ("), (vs[0].where, at)
    wrapper = ("def k1(x, nbr, wgt, lib):\n"
               "    return lib.semiring_spmv_launch(\n"
               "        x.data_ptr(), nbr.data_ptr(), wgt.data_ptr(),\n"
               "        x.data_ptr(), 8, 4, 0, 0, None)\n")
    vs = tan.lint_wrapper_source(wrapper, "alias.py")
    assert _keys(vs) == [("IO_ALIAS", "alias.py:2 (wrapper k1)", "error")]
    assert "['x']" in vs[0].detail


def test_validated_local_runs_are_plain_runs(pg8):
    """validate=True on the local backend, every route (the fused megastep
    CC, SSSP and PageRank, the staged dense/compact/tiered/phased CC, a
    checkpointed compact CC): bit-equal state and equal Telemetry, nothing
    recorded, and the configuration is checked once (a later run is a
    plain run)."""
    progs = _programs(tcore, pg8)
    cases = [("cc", "megastep"), ("sssp", "megastep"),
             ("pagerank", "megastep")]
    cases += [("cc", ex) for ex in ("dense", "compact", "tiered", "phased")]
    for algo, ex in cases:
        kw = {"max_supersteps": 64} if algo == "pagerank" else {}
        plain = GopherEngine(pg8, progs[algo], exchange=ex, device="cpu",
                             **kw)
        checked = GopherEngine(pg8, progs[algo], exchange=ex, device="cpu",
                               validate=True, **kw)
        (s0, t0), (s1, t1) = plain.run(), checked.run()
        for k in s0:
            assert np.array_equal(s0[k], s1[k]), (algo, ex, k)
        for f in Telemetry.__dataclass_fields__:
            a, b = getattr(t0, f), getattr(t1, f)
            assert (a is None and b is None) or np.array_equal(
                np.asarray(a), np.asarray(b)), (algo, ex, f)
        summary, vs = checked.sentinel
        assert summary.ops == [] and tan.errors(vs) == []
        assert summary.supersteps == t1.supersteps
        assert len(checked._validated) == 1
        checked.sentinel = None
        checked.run()
        assert checked.sentinel is None          # a plain run
    import tempfile

    from repro_torch.training.checkpoint import Checkpointer
    with tempfile.TemporaryDirectory() as d:
        eng = GopherEngine(pg8, progs["cc"], exchange="megastep",
                           device="cpu", validate=True)
        s1, t1 = eng.run(checkpointer=Checkpointer(d), checkpoint_every=2)
    s0, t0 = GopherEngine(pg8, progs["cc"], exchange="compact",
                          device="cpu").run()
    assert np.array_equal(s0["x"], s1["x"]) and t0.supersteps == \
        t1.supersteps
    stages, vs = tan.validate_stage_fns(GopherEngine(
        pg8, progs["sssp"], exchange="tiered", device="cpu"))
    assert tan.errors(vs) == [] and all(not c for c in stages.values())


def test_a_migrated_engine_keeps_validating():
    """Gopher Balance's migration rebuilds the engine validating as the
    old one was (as the JAX package's rebuild does; a failover's likewise):
    the resumed checkpointed loop is recorded, clean, and bit-equal to the
    same migration unvalidated."""
    import tempfile

    from repro_torch.resilience import balance
    from repro_torch.training.checkpoint import Checkpointer
    g = road_grid(6, 12, drop_frac=0.0, seed=0, weighted=True)
    strips = (np.arange(6 * 12) % 12) // 2
    pg = partition_graph(g, np.asarray([0, 1, 2, 0, 3, 3], np.int32)[strips],
                         4)
    plan = balance.plan_migration(pg, src=0, budget=12)
    assert plan is not None
    outs = []
    for validate in (False, True):
        eng = GopherEngine(pg, SemiringProgram("max_first", init_max_vertex),
                           exchange="compact", validate=validate,
                           device="cpu")
        with tempfile.TemporaryDirectory() as d:
            ck = Checkpointer(d)
            eng.run(checkpointer=ck, checkpoint_every=1, superstep_budget=1)
            eng2, _, _ = balance.migrate_and_resume(eng, ck, plan)
            assert eng2.validate is validate
            outs.append(eng2.run(checkpointer=ck, checkpoint_every=1,
                                 resume=True))
            assert (eng2.sentinel is not None) is validate
    assert np.array_equal(outs[0][0]["x"], outs[1][0]["x"])
    assert outs[0][1].supersteps == outs[1][1].supersteps


def test_violation_json_round_trip():
    """A Violation written by either package reads back in the other, and
    both format and raise alike."""
    for sev in ("error", "warning", "info"):
        pv = tan.Violation("collectives", "COLLECTIVE_MISMATCH",
                           "core/engine.py:267", "ranks disagree", sev)
        jv = jan.Violation(**pv.to_json())
        assert jv.to_json() == pv.to_json() and str(jv) == str(pv)
        assert tan.Violation(**jv.to_json()) == pv
        assert tan.split_severity([pv])[0] == ([pv] if sev == "error"
                                               else [])
    with pytest.raises(tan.SentinelError) as a:
        tan.assert_clean([pv, dataclasses.replace(pv, severity="error")])
    with pytest.raises(jan.SentinelError) as b:
        jan.assert_clean([jv, dataclasses.replace(jv, severity="error")])
    assert str(a.value) == str(b.value)
