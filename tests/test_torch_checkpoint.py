"""The port's ``Checkpointer`` and checkpointed runs against the JAX
package's, on the CPU through the plain kernels.

The checkpointer round-trips float32, int32, bool and bfloat16 leaves with
``extra`` in the JAX package's layout (same paths and CRC32s), ignores a
step without its COMMIT marker, and falls back past a bit-flipped snapshot.
Snapshots written by either package restore in the other and resume to a
bit-equal end. ``GopherEngine.run(checkpointer=)`` on 'dense', 'compact'
and 'megastep' is bit-equal to the JAX package's checkpointed run in state
and telemetry, on the engine's one cached block, and so are its
``superstep_budget`` segments and a resume's telemetry; checkpointed
PageRank is within rtol 1e-5. The graph is ``tests/test_resilience.py``'s
random graph (100 vertices, 8 partitions).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import GopherEngine as JEngine  # noqa: E402
from repro.core import PageRankProgram as JPageRank  # noqa: E402
from repro.core import SemiringProgram as JSemiring  # noqa: E402
from repro.core import init_max_vertex as j_init_max  # noqa: E402
from repro.gofs.formats import partition_graph  # noqa: E402
from repro.gofs.generators import random_graph  # noqa: E402
from repro.gofs.partition import bfs_grow_partition  # noqa: E402
from repro.training.checkpoint import Checkpointer as JCheckpointer  # noqa: E402

from repro_torch.core import (GopherEngine, PageRankProgram,  # noqa: E402
                              SemiringProgram, init_max_vertex)
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.gofs.formats import partitioned_graph_from_fields  # noqa: E402
from repro_torch.training import checkpoint as ckmod  # noqa: E402
from repro_torch.training.checkpoint import Checkpointer  # noqa: E402

TELEMETRY = ("supersteps", "local_iters", "changed_hist", "messages_sent",
             "count_hist", "wire_slots", "bytes_on_wire", "wire_hist",
             "pair_slots", "pair_rounds", "exchange")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per worker process: the suite runs several at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def graph():
    """(JAX pg, port pg)."""
    g = random_graph(100, avg_degree=4.0, seed=3, weighted=True)
    jpg = partition_graph(g, bfs_grow_partition(g, 8, seed=0), 8)
    return jpg, partitioned_graph_from_fields(dataclasses.asdict(jpg))


def _cc(pkg):
    return (JSemiring("max_first", j_init_max) if pkg == "jax"
            else SemiringProgram("max_first", init_max_vertex))


def _same_telemetry(jt, tt):
    for f in TELEMETRY:
        a, b = getattr(jt, f), getattr(tt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.array_equal(np.asarray(a), np.asarray(b)), f


def _same_state(js, ts):
    assert sorted(js) == sorted(ts)
    for k in js:
        assert np.array_equal(np.asarray(js[k]), ts[k]), k


def _bf16(seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (3, 5)).astype(np.float32)).to(torch.bfloat16)


def test_checkpointer_round_trip_in_the_jax_layout(tmp_path):
    """Every leaf kind and ``extra`` round-trip, onto ``cuda`` unless the
    caller asks for the CPU; the files, their order of writing aside, are
    the JAX package's: the same npz keys, manifest paths
    and CRC32s for the same tree."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((4, 7)).astype(np.float32)
    i32 = rng.integers(-9, 9, (4, 7)).astype(np.int32)
    mask = rng.random((4, 7)) < 0.5
    bf = _bf16(1)
    tree = {"state": {"x": torch.from_numpy(f32), "mask": torch.from_numpy(mask)},
            "inbox": i32, "seq": [torch.from_numpy(f32[:2]), (bf,)]}
    ck = Checkpointer(str(tmp_path / "t"))
    ck.save(tree, 5, extra={"note": "round trip", "k": 3})
    got, step = ck.restore(tree, device="cpu")
    assert step == 5 and ck.latest_step() == 5 and ck.verify_step(5)
    assert ck.extra() == {"note": "round trip", "k": 3}
    assert torch.equal(got["state"]["x"], tree["state"]["x"])
    assert got["state"]["mask"].dtype == torch.bool
    assert torch.equal(got["state"]["mask"], tree["state"]["mask"])
    assert got["inbox"].dtype == torch.int32
    assert np.array_equal(got["inbox"].numpy(), i32)
    assert isinstance(got["seq"], list) and isinstance(got["seq"][1], tuple)
    assert got["seq"][1][0].dtype == torch.bfloat16
    assert torch.equal(got["seq"][1][0], bf)
    # restore, like every entry point of the port, defaults to the card
    if torch.cuda.is_available():
        assert ck.restore(tree)[0]["inbox"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ck.restore(tree)
    sdir = tmp_path / "t" / "step_5"
    assert sorted(os.listdir(sdir)) == ["COMMIT", "host_0.npz",
                                        "manifest.json"]
    man = json.loads((sdir / "manifest.json").read_text())
    assert (man["step"], man["process_index"], man["process_count"]) == \
        (5, 0, 1)
    # the JAX package's checkpointer on the same tree
    jtree = {"state": {"x": jnp.asarray(f32), "mask": jnp.asarray(mask)},
             "inbox": jnp.asarray(i32),
             "seq": [jnp.asarray(f32[:2]),
                     (jnp.asarray(bf.float().numpy(), jnp.bfloat16),)]}
    JCheckpointer(str(tmp_path / "j")).save(jtree, 5,
                                            extra={"note": "round trip",
                                                   "k": 3})
    jman = json.loads((tmp_path / "j" / "step_5" / "manifest.json")
                      .read_text())
    assert man == jman
    assert man["paths"] == ["['inbox']", "['seq'][0]", "['seq'][1][0]",
                            "['state']['mask']", "['state']['x']"]
    assert man["checksums"]["['seq'][1][0]::dtype"] == \
        jman["checksums"]["['seq'][1][0]::dtype"]


def test_async_save_and_the_commit_marker(tmp_path, monkeypatch):
    """``async_save`` copies to the host in ``save`` (later changes to the
    tensor are not in the snapshot) and writes on a thread; a step without
    its COMMIT marker is ignored, and a failed write re-raises in
    ``wait``."""
    ck = Checkpointer(str(tmp_path), async_save=True)
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    ck.save({"x": x}, 1)
    x += 100.0                                  # after the device-to-host copy
    ck.wait()
    assert set(ck.last_save_s) == {"device_to_host", "crc", "write"}
    got, _ = ck.restore({"x": x}, device="cpu")
    assert torch.equal(got["x"], torch.arange(12, dtype=torch.float32)
                       .reshape(3, 4))
    ck.save({"x": x}, 2)
    ck.wait()
    os.remove(tmp_path / "step_2" / "COMMIT")  # a write cut before its commit
    os.makedirs(tmp_path / "step_9")           # a step that never wrote
    assert ck.latest_step() == 1 and ck.latest_good_step() == 1
    assert ck.restore({"x": x}, device="cpu")[1] == 1

    def no_space(*args, **kwargs):
        raise OSError("no space left on device")
    monkeypatch.setattr(ckmod.np, "savez", no_space)
    ck.save({"x": x}, 3)
    with pytest.raises(OSError, match="no space"):
        ck.wait()
    assert ck.latest_step() == 1


def test_crc_fallback_past_a_bit_flipped_snapshot(tmp_path, graph):
    """Bit-rot in the newest snapshot: ``verify_step`` fails it,
    ``latest_good_step`` falls back one, and the resumed run ends
    bit-equal to the JAX package's uninterrupted run."""
    jpg, tpg = graph
    ref, _ = JEngine(jpg, _cc("jax"), exchange="dense").run()
    ck = Checkpointer(str(tmp_path))
    GopherEngine(tpg, _cc("torch"), exchange="compact", max_supersteps=3,
                 device="cpu").run(checkpointer=ck, checkpoint_every=1)
    latest = ck.latest_step()
    with open(tmp_path / f"step_{latest}" / "host_0.npz", "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef")
    assert not ck.verify_step(latest)
    good = ck.latest_good_step()
    assert good == latest - 1
    state, tele = GopherEngine(tpg, _cc("torch"), exchange="compact",
                               device="cpu").run(checkpointer=ck,
                                                 checkpoint_every=1,
                                                 resume=True)
    _same_state(ref, state)
    assert tele.changed_hist[:good].sum() == 0      # slots before the resume


def test_snapshots_cross_between_packages(tmp_path, graph):
    """The JAX package writes, the port restores and resumes a compact CC
    run to the JAX package's end; then the port writes and the JAX package
    resumes. A bfloat16 leaf crosses each way."""
    jpg, tpg = graph
    ref, jref = JEngine(jpg, _cc("jax"), exchange="compact").run(
        checkpointer=JCheckpointer(str(tmp_path / "ref")),
        checkpoint_every=1)
    # JAX -> port
    d = str(tmp_path / "j2t")
    JEngine(jpg, _cc("jax"), exchange="compact").run(
        checkpointer=JCheckpointer(d), checkpoint_every=1,
        superstep_budget=2)
    state, tele = GopherEngine(tpg, _cc("torch"), exchange="compact",
                               device="cpu").run(
        checkpointer=Checkpointer(d), checkpoint_every=1, resume=True)
    _same_state(ref, state)
    assert tele.supersteps == jref.supersteps
    # port -> JAX
    d = str(tmp_path / "t2j")
    GopherEngine(tpg, _cc("torch"), exchange="compact", device="cpu").run(
        checkpointer=Checkpointer(d), checkpoint_every=1, superstep_budget=3)
    jstate, jtele = JEngine(jpg, _cc("jax"), exchange="compact").run(
        checkpointer=JCheckpointer(d), checkpoint_every=1, resume=True)
    _same_state(ref, {k: np.asarray(v) for k, v in jstate.items()})
    assert jtele.supersteps == jref.supersteps
    # bfloat16 both ways
    bf = _bf16(4)
    Checkpointer(str(tmp_path / "bf_t")).save({"w": bf}, 0)
    jw, _ = JCheckpointer(str(tmp_path / "bf_t")).restore(
        {"w": jnp.zeros((3, 5), jnp.bfloat16)})
    assert jw["w"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(jw["w"], np.float32), bf.float().numpy())
    JCheckpointer(str(tmp_path / "bf_j")).save({"w": jw["w"]}, 0)
    tw, _ = Checkpointer(str(tmp_path / "bf_j")).restore({"w": bf},
                                                     device="cpu")
    assert tw["w"].dtype == torch.bfloat16 and torch.equal(tw["w"], bf)


@pytest.mark.parametrize("exchange", ["dense", "compact", "megastep"])
def test_checkpointed_run_matches_jax(tmp_path, graph, monkeypatch,
                                      exchange):
    """State, telemetry and the snapshots' steps equal the JAX package's
    checkpointed run (megastep runs on the compact staged loop in both);
    two runs of one engine build its block once."""
    jpg, tpg = graph
    jd, td = tmp_path / "j", tmp_path / "t"
    js, jt = JEngine(jpg, _cc("jax"), exchange=exchange).run(
        checkpointer=JCheckpointer(str(jd)), checkpoint_every=2)
    builds = []
    real = tengine.graph_block
    monkeypatch.setattr(tengine, "graph_block",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    eng = GopherEngine(tpg, _cc("torch"), exchange=exchange, device="cpu")
    ts, tt = eng.run(checkpointer=Checkpointer(str(td)), checkpoint_every=2)
    staged = eng._staged_gb
    ts2, _ = eng.run(checkpointer=Checkpointer(str(tmp_path / "again")),
                     checkpoint_every=2)
    assert len(builds) == 1 and eng._staged_gb is staged
    assert eng.exchange == exchange
    _same_state(js, ts)
    _same_state(js, ts2)
    _same_telemetry(jt, tt)
    assert tt.part_seconds.shape == (tpg.num_parts,)
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))


def test_superstep_budget_segments_match_jax(tmp_path, graph):
    """Segments of 2 supersteps resumed to the end: each segment's state
    and telemetry (zero hist slots before the restored step, the byte
    model over this process's rounds, no prime) equal the JAX package's."""
    jpg, tpg = graph
    jeng = JEngine(jpg, _cc("jax"), exchange="compact")
    teng = GopherEngine(tpg, _cc("torch"), exchange="compact", device="cpu")
    jck, tck = JCheckpointer(str(tmp_path / "j")), Checkpointer(
        str(tmp_path / "t"))
    resume, segments = False, 0
    while True:
        js, jt = jeng.run(checkpointer=jck, checkpoint_every=1,
                          resume=resume, superstep_budget=2)
        ts, tt = teng.run(checkpointer=tck, checkpoint_every=1,
                          resume=resume, superstep_budget=2)
        _same_state(js, ts)
        _same_telemetry(jt, tt)
        segments += 1
        resume = True
        if jt.changed_hist.size and jt.changed_hist[-1] == 0:
            break
    assert segments >= 2
    with pytest.raises(ValueError, match="checkpointed"):
        teng.run(superstep_budget=2)


def test_pagerank_checkpointed_and_resumed_matches_jax(tmp_path, graph):
    """30-iteration PageRank on 'compact', cut after 11 supersteps and
    resumed, within rtol 1e-5 of the JAX package's checkpointed run; its
    (P,) float32 delta round-trips."""
    jpg, tpg = graph
    js, jt = JEngine(jpg, JPageRank(n_global=jpg.n_global, num_iters=30),
                     exchange="compact").run(
        checkpointer=JCheckpointer(str(tmp_path / "j")), checkpoint_every=5)
    eng = GopherEngine(tpg, PageRankProgram(n_global=tpg.n_global,
                                            num_iters=30),
                       exchange="compact", device="cpu")
    ck = Checkpointer(str(tmp_path / "t"))
    eng.run(checkpointer=ck, checkpoint_every=5, superstep_budget=11)
    ts, tt = eng.run(checkpointer=ck, checkpoint_every=5, resume=True)
    assert tt.supersteps == jt.supersteps == 30
    assert ts["delta"].shape == (tpg.num_parts,)
    assert ts["delta"].dtype == np.float32
    np.testing.assert_allclose(ts["r"], np.asarray(js["r"]), rtol=1e-5,
                               atol=0)
    assert np.array_equal(tt.changed_hist[11:], np.asarray(jt.changed_hist)
                          [11:])
