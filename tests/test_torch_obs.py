"""The port's Gopher Scope (tracer and metrics registry) against the JAX
package's, on the CPU.

The registry gives the JAX package's snapshot for one sequence of
operations, and each package's ``validate_metrics`` accepts the other's;
the tracer nests, exports, degenerates to the shared no-op span when
disabled and reports unbalanced spans as the JAX tracer does; a traced
SSSP on each of ``tests/test_obs.py``'s exchanges equals the port's
untraced run (state and every ``Telemetry`` field but ``part_seconds``)
and the JAX package's traced run (state, the round histograms, the span
tree's (name, depth) multiset and the dispatch counters). The graph is
``tests/test_obs.py``'s 14 x 14 road grid in 4 partitions.
"""
import collections
import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

from repro.core import GopherEngine as JEngine  # noqa: E402
from repro.core import PhasedTierPlan as JPhased  # noqa: E402
from repro.core import SemiringProgram as JSemiring  # noqa: E402
from repro.core import TierPlan as JTierPlan  # noqa: E402
from repro.core import make_sssp_init as j_sssp_init  # noqa: E402
from repro.gofs import bfs_grow_partition, road_grid  # noqa: E402
from repro.gofs.formats import partition_graph  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs import validate_chrome_trace as j_validate_trace  # noqa: E402
from repro.obs import validate_metrics as j_validate_metrics  # noqa: E402

from repro_torch.core import (GopherEngine, PhasedTierPlan,  # noqa: E402
                              SemiringProgram, TierPlan, make_sssp_init)
from repro_torch.gofs.formats import partitioned_graph_from_fields  # noqa: E402
from repro_torch.obs import (NOOP, MetricsRegistry, Tracer,  # noqa: E402
                             get_tracer, set_tracer, validate_chrome_trace,
                             validate_metrics)
from repro_torch.obs.trace import _NOOP_SPAN  # noqa: E402

MODES = ("dense", "compact", "tiered", "phased", "megastep", "auto")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker process: the suite runs several at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def road():
    g = road_grid(14, 14, drop_frac=0.05, seed=1, weighted=True)
    jpg = partition_graph(g, bfs_grow_partition(g, 4, seed=0), 4)
    return jpg, partitioned_graph_from_fields(dataclasses.asdict(jpg))


def _sssp(pg, jax_pkg: bool):
    loc = (int(pg.part_of[0]), int(pg.local_of[0]))
    return (JSemiring("min_plus", j_sssp_init(*loc)) if jax_pkg
            else SemiringProgram("min_plus", make_sssp_init(*loc)))


def _plan(pg, exchange, jax_pkg: bool):
    tier, phased = ((JTierPlan, JPhased) if jax_pkg
                    else (TierPlan, PhasedTierPlan))
    return {"tiered": tier.from_graph,
            "phased": phased.from_graph}.get(exchange, lambda _: None)(pg)


def same_telemetry(a, b, skip=("part_seconds",)):
    """Every Telemetry field of ``a`` and ``b`` equal but ``skip``."""
    for f in dataclasses.fields(a):
        if f.name in skip:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), f.name


def span_tree(tracer) -> collections.Counter:
    return collections.Counter((s.name, s.depth) for s in tracer.spans)


def test_registry_matches_jax():
    """One sequence of counter, gauge and histogram operations (labels in
    two orders, a histogram past its window) gives the JAX package's
    snapshot; each package's validate_metrics accepts the other's
    snapshot and rejects the same garbage; the handles are shared."""
    def drive(reg):
        c = reg.counter("reqs_total", labels={"route": "a", "z": 1})
        c.inc()
        c.inc(2.5)
        assert reg.counter("reqs_total", labels={"z": 1, "route": "a"}) is c
        reg.counter("reqs_total").inc(0)
        reg.gauge("depth").set(7)
        reg.gauge("depth", labels={"q": "x"}).set(-3.25)
        h = reg.histogram("lat", labels={"k": "v"})
        for v in np.random.default_rng(0).exponential(2.0, 11):
            h.observe(v)
        reg.histogram("empty")
        return reg.snapshot()

    jsnap = drive(JRegistry(histogram_window=4))
    tsnap = drive(MetricsRegistry(histogram_window=4))
    assert tsnap == jsnap
    assert json.loads(MetricsRegistry().to_json()) == JRegistry().snapshot()
    validate_metrics(jsnap)
    j_validate_metrics(tsnap)
    for bad in ({}, {"format": "x"}, dict(tsnap, counters={"c": -1.0}),
                dict(tsnap, histograms={"h": {"count": 1}})):
        with pytest.raises(AssertionError):
            validate_metrics(bad)
        with pytest.raises(AssertionError):
            j_validate_metrics(bad)
    reg = MetricsRegistry()
    reg.counter("a").inc()
    reg.clear()
    assert reg.snapshot() == JRegistry().snapshot()


def test_tracer_nesting_noop_and_unbalanced(tmp_path):
    """Spans nest run -> phase -> superstep -> sweep with the JAX tracer's
    depths, export a Chrome trace both packages validate and a JSONL line
    a span; a disabled tracer hands back the shared no-op span and records
    nothing; an open span shows as unbalanced; sync is the identity on CPU
    tensors; the process default is NOOP until set."""
    trees = []
    for tr in (Tracer(enabled=True, boundary_sync=True), JTracer()):
        with tr.span("run", kind="test") as run:
            with tr.span("phase", phase=0):
                with tr.span("superstep", step=0):
                    with tr.span("sweep"):
                        pass
            run.set(supersteps=1)
        tr.count("dispatches", 3)
        assert tr.balanced
        trees.append(({s.name: s.depth for s in tr.spans}, tr.counts))
    tr = Tracer(enabled=True, boundary_sync=True)
    with tr.span("run", kind="test") as run:
        with tr.span("phase", phase=0):
            with tr.span("superstep", step=0):
                with tr.span("sweep"):
                    x = torch.ones(3)
                    assert tr.sync(x) is x
                    assert tr.sync({"a": (x,)})["a"][0] is x
        run.set(supersteps=1)
    assert trees[0] == trees[1] == (
        {"run": 0, "phase": 1, "superstep": 2, "sweep": 3},
        {"dispatches": 3})
    trace = tr.chrome_trace()
    validate_chrome_trace(trace)
    j_validate_trace(trace)
    assert next(e for e in trace["traceEvents"]
                if e["name"] == "run")["args"]["supersteps"] == 1
    p = tr.write_chrome_trace(str(tmp_path / "t.json"))
    with open(p) as f:
        validate_chrome_trace(json.load(f))
    assert len(tr.jsonl().splitlines()) == len(tr.spans)

    off = Tracer(enabled=False)
    s = off.span("run", big=1)
    assert s is _NOOP_SPAN
    with s as inner:
        inner.set(x=2)
    off.count("dispatches")
    assert off.spans == [] and off.counts == {} and off.balanced
    assert off.profile_ctx("cpu").__enter__() is None

    tr = Tracer(enabled=True)
    span = tr.span("run")
    span.__enter__()
    assert not tr.balanced and tr.open_spans() == ["run"]
    span.__exit__(None, None, None)
    assert tr.balanced

    assert get_tracer() is NOOP
    try:
        assert set_tracer(tr) is tr and get_tracer() is tr
    finally:
        set_tracer(None)
    assert get_tracer() is NOOP


@pytest.mark.parametrize("exchange", MODES)
def test_traced_sssp_matches_untraced_and_jax(road, exchange):
    """Tracing observes, never perturbs: the port's traced SSSP equals its
    untraced run in state and every Telemetry field but part_seconds, and
    the JAX package's traced run in state, the round histograms, the span
    tree and the counters; part_seconds covers every partition."""
    jpg, tpg = road
    jtr = JTracer()
    js, jt = JEngine(jpg, _sssp(jpg, True), exchange=exchange,
                     tier_plan=_plan(jpg, exchange, True), tracer=jtr).run()
    ts0, tt0 = GopherEngine(tpg, _sssp(tpg, False), exchange=exchange,
                            tier_plan=_plan(tpg, exchange, False),
                            device="cpu").run()
    tr = Tracer()
    ts, tt = GopherEngine(tpg, _sssp(tpg, False), exchange=exchange,
                          tier_plan=_plan(tpg, exchange, False), tracer=tr,
                          device="cpu").run()
    assert sorted(ts) == sorted(ts0)
    for k in ts:
        assert np.array_equal(ts[k], ts0[k]), k
    same_telemetry(tt0, tt)
    assert tt0.part_seconds is None
    assert tt.part_seconds.shape == (tpg.num_parts,)
    assert np.all(tt.part_seconds >= 0)

    assert np.array_equal(np.asarray(js["x"]), ts["x"])
    assert jt.supersteps == tt.supersteps and jt.exchange == tt.exchange
    for f in ("wire_hist", "local_iters", "count_hist", "pair_slots",
              "changed_hist"):
        a, b = getattr(jt, f), getattr(tt, f)
        assert (a is None and b is None) or np.array_equal(
            np.asarray(a), np.asarray(b)), f
    assert span_tree(tr) == span_tree(jtr)
    assert tr.counts == jtr.counts
    assert tr.balanced
    trace = tr.chrome_trace()
    validate_chrome_trace(trace)
    j_validate_trace(trace)
    names = [s.name for s in tr.spans]
    assert names.count("superstep") == tt.supersteps
    stage = "megastep" if tt.exchange == "megastep" else "sweep"
    assert names.count(stage) == tt.supersteps
