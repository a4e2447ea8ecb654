"""What kernel K3's cluster-per-partition design relies on, on the CPU.

K3 (``csrc/megastep.cu``) runs each partition's fixpoint on its own
thread-block cluster, to that partition's own quiescence, and each sweep
recomputes only the rows with an active in-neighbour, found through the
transpose of the local adjacency (``kernels.megastep.out_adjacency``).
A CUDA kernel has no CPU mode, so these tests hold what it relies on:

- the out-adjacency the wrapper builds is exactly the transpose of
  ``cm["nbr"]`` and stays inside each partition;
- the rows it yields from a frontier are the ``act`` rows of
  ``semiring_spmv_frontier_ref``;
- the schedule K3 runs — written out below in numpy: each partition looped
  alone until its own frontier empties, Jacobi sweeps over that work list
  (all of the partition's rows while the frontier is large), ``unroll``
  sweeps a trip — gives the same x2, changed2, frontier_left and liters as
  ``megastep_semiring_ref`` and as the JAX package's
  ``megastep_semiring_pallas`` in interpret mode, bit for bit, over every
  superstep of a run.

The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import graph_block as j_graph_block  # noqa: E402
from repro.gofs import bfs_grow_partition, powerlaw_social, road_grid  # noqa: E402
from repro.gofs.formats import partition_graph  # noqa: E402
from repro.kernels import megastep as jmega  # noqa: E402

from repro_torch.core import graph_block as t_graph_block  # noqa: E402
from repro_torch.core import SemiringProgram, init_max_vertex, make_sssp_init  # noqa: E402
from repro_torch.gofs.formats import PAD, partitioned_graph_from_fields  # noqa: E402
from repro_torch.kernels import megastep as tmega  # noqa: E402
from repro_torch.kernels.flat import combine_ew, idempotent_combine  # noqa: E402
from repro_torch.kernels.ref import semiring_spmv_frontier_ref  # noqa: E402

GRAPHS = {
    # a road grid: long paths, the main path's kind of graph
    "road": lambda: road_grid(10, 11, drop_frac=0.06, seed=3, weighted=True),
    # a powerlaw graph: hub rows with long out-lists, and hub feed rows
    "social": lambda: powerlaw_social(400, m=5, seed=2),
}
PARTS = [1, 3, 5]
SEMIRINGS = ["max_first", "min_plus"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: one torch thread
    per process keeps these small CPU tensors from oversubscribing cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_BLOCKS = {}


def _blocks(name: str, P: int):
    """(JAX pg, JAX block, JAX mailbox, port block, port mailbox) for one
    graph in P partitions, built once from the same partitioned arrays."""
    if (name, P) not in _BLOCKS:
        g = GRAPHS[name]()
        pg = partition_graph(g, bfs_grow_partition(g, P, seed=0), P)
        jgb = j_graph_block(pg)
        jcm = jax.jit(lambda gb: {
            k: v for k, v in jmega.compose_mailbox(gb).items()
            if k not in jmega.MAILBOX_STATICS})(jgb)
        jcm.update(num_parts=P, v_max=pg.v_max,
                   cap=jgb["ob_inv"].shape[1] // P, n=P * pg.v_max)
        tgb = t_graph_block(partitioned_graph_from_fields(
            dataclasses.asdict(pg)), "cpu")
        _BLOCKS[name, P] = (pg, jgb, jcm, tgb, tmega.compose_mailbox(tgb))
    return _BLOCKS[name, P]


def _expand(off, src, frontier_rows):
    """The rows a work list yields: the out-neighbours of the frontier
    rows, each once, ascending."""
    segs = [src[off[s]:off[s + 1]] for s in frontier_rows]
    return np.unique(np.concatenate(segs)) if segs else np.zeros(0, int)


@pytest.mark.parametrize("P", PARTS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_out_adjacency_is_the_transpose(name, P):
    *_, tcm = _blocks(name, P)
    cm = dict(tcm)
    off, src = tmega.out_adjacency(cm)
    assert off.dtype == src.dtype == torch.int32
    nbr = cm["nbr"].numpy()
    n, v_max = cm["n"], cm["v_max"]
    # every valid lane (u, j) is the edge nbr[u, j] -> u, listed by source
    # and then by row: a stable sort of the lanes by source
    u, j = np.nonzero(nbr != PAD)
    s = nbr[u, j]
    order = np.lexsort((u, s))
    assert np.array_equal(src.numpy(), u[order])
    assert np.array_equal(off.numpy(),
                          np.concatenate([[0], np.cumsum(np.bincount(
                              s, minlength=n))]))
    # local edges never leave a partition
    rows = np.repeat(np.arange(n), np.diff(off.numpy()))
    assert np.array_equal(rows // v_max, src.numpy() // v_max)
    # built once and kept in the mailbox
    assert tmega.out_adjacency(cm)[1] is src


@pytest.mark.parametrize("P", PARTS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_work_list_rows_are_the_act_rows(name, P):
    *_, tcm = _blocks(name, P)
    cm = dict(tcm)
    off, src = (t.numpy() for t in tmega.out_adjacency(cm))
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.uniform(0.0, 9.0, cm["n"]).astype(np.float32))
    for density in (0.0, 0.01, 0.1, 0.5, 1.0):
        f = rng.random(cm["n"]) < density
        _, act = semiring_spmv_frontier_ref(x, torch.from_numpy(f),
                                            cm["nbr"], cm["wgt"], "max_first")
        assert np.array_equal(_expand(off, src, np.nonzero(f)[0]),
                              np.nonzero(act.numpy())[0]), density


def test_out_adjacency_refuses_edges_outside_vmask():
    *_, tcm = _blocks("road", 3)
    cm = dict(tcm)
    vm = cm["vmask"].clone()
    vm[int(np.nonzero((cm["nbr"] != PAD).any(dim=1).numpy())[0][0])] = False
    cm["vmask"] = vm
    with pytest.raises(ValueError, match="K3"):
        tmega.out_adjacency(cm)


def test_dense_rows_follow_the_constant(monkeypatch):
    for frac, want in ((0.0, 0), (0.125, 20417), (1.0, 163334),
                       (2.0, 163335)):
        monkeypatch.setattr(tmega, "K3_DENSE_FRONTIER", frac)
        assert tmega.k3_dense_rows(163334) == want


def per_partition_superstep(x, changed, frontier, cm, semiring, unroll):
    """One fused superstep as K3 schedules it: delivery over the whole flat
    state, then each partition's masked fixpoint alone until its own
    frontier empties. A sweep takes the rows with an active in-neighbour
    from the out-adjacency (or, while the frontier holds at least
    ``k3_dense_rows`` rows, tests every row of the partition) and reads
    the adjacency cut to its used lanes (``k3_lanes``), computes their
    values from the current x into staging, then applies them (Jacobi). ``unroll`` sweeps make a trip; a trip starts only on a
    non-empty frontier and adds ``unroll`` to the partition's liters."""
    combine = idempotent_combine(semiring)
    vm = cm["vmask"].numpy()
    inbox = tmega.deliver_flat(x, changed, cm, combine, semiring == "min_plus")
    x1 = combine_ew(combine, x, inbox)
    f0 = (frontier | ((x1 != x) & cm["vmask"])).numpy()
    xc = x1.numpy().copy()
    nbr, wgt = (t.numpy() for t in tmega.k3_lanes(cm, "min_plus"))
    off, src = (t.numpy() for t in tmega.out_adjacency(cm))
    P, v_max = cm["num_parts"], cm["v_max"]
    dense_rows = tmega.k3_dense_rows(v_max)
    ident = np.float32(np.inf if semiring == "min_plus" else -np.inf)
    pick = np.minimum if semiring == "min_plus" else np.maximum
    f_left = np.zeros_like(f0)
    liters = np.zeros(P, np.int32)
    for p in range(P):
        lo = p * v_max
        front = np.nonzero(f0[lo:lo + v_max])[0] + lo
        while front.size:
            liters[p] += unroll
            for _ in range(unroll):
                if front.size >= dense_rows:
                    fb = np.zeros(cm["n"], bool)
                    fb[front] = True
                    rows = np.arange(lo, lo + v_max)
                    lanes = nbr[rows]
                    ok = lanes != PAD
                    rows = rows[(ok & fb[np.where(ok, lanes, 0)]).any(1)]
                else:
                    rows = _expand(off, src, front)
                lanes = nbr[rows]
                ok = lanes != PAD
                g = xc[np.where(ok, lanes, 0)]
                if semiring == "min_plus":
                    g = g + wgt[rows]
                y = (np.where(ok, g, ident).min(1) if semiring == "min_plus"
                     else np.where(ok, g, ident).max(1))
                new = pick(xc[rows], y)
                moved = (new != xc[rows]) & vm[rows]
                xc[rows] = new                 # staged, then applied
                front = rows[moved]
        f_left[front] = True
    xt = torch.from_numpy(xc)
    return xt, (xt != x) & cm["vmask"], torch.from_numpy(f_left), \
        torch.from_numpy(liters)


_PALLAS = {}


@pytest.mark.parametrize("unroll", [1, 3])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("P", PARTS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_per_partition_schedule_matches_ref_and_pallas(name, P, semiring,
                                                       unroll):
    pg, jgb, jcm, tgb, tcm = _blocks(name, P)
    cm = dict(tcm)
    init = (init_max_vertex if semiring == "max_first"
            else make_sssp_init(int(pg.part_of[0]), int(pg.local_of[0])))
    st = SemiringProgram(semiring=semiring, init_fn=init).init(tgb)
    x, ch, fr = (st[k].reshape(-1) for k in ("x", "changed_v", "frontier"))
    key = (name, P, semiring, unroll)
    if key not in _PALLAS:                     # one compile per case
        _PALLAS[key] = jax.jit(lambda *a: jmega.megastep_semiring_pallas(
            *a, jcm, semiring, unroll=unroll, interpret=True))
    steps = 0
    while bool(ch.any()):
        got = per_partition_superstep(x, ch, fr, cm, semiring, unroll)
        want = tmega.megastep_semiring_ref(x, ch, fr, cm, semiring, unroll)
        pallas = _PALLAS[key](*(jnp.asarray(t.numpy()) for t in (x, ch, fr)))
        for what, g, w, p in zip(("x2", "changed2", "frontier_left",
                                  "liters"), got, want, pallas):
            assert np.array_equal(g.numpy(), w.numpy()), (what, steps)
            assert np.array_equal(g.numpy(), np.asarray(p)), (what, steps)
        x, ch, fr = got[:3]
        steps += 1
        assert steps < 200
    assert steps > 0


@pytest.mark.parametrize("P", PARTS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_k3_lanes_keep_every_edge(name, P):
    """K3 reads the adjacency cut to the lanes some row uses: every valid
    lane is kept in place, every dropped lane is PAD in every row, and the
    width is a multiple of 4 (16-byte loads) or the ELL's own."""
    *_, tcm = _blocks(name, P)
    cm = dict(tcm)
    nbr, wgt = cm["nbr"], cm["wgt"]
    k_nbr, k_wgt = tmega.k3_lanes(cm, "min_plus")
    width = k_nbr.shape[1]
    assert width % 4 == 0 or width == nbr.shape[1]
    assert torch.equal(k_nbr, nbr[:, :width])
    assert torch.equal(k_wgt, wgt[:, :width])
    assert bool((nbr[:, width:] == PAD).all())
    assert tmega.k3_lanes(cm, "max_first") == (k_nbr, None)
    if name == "road":                   # the ELL pads 4 used lanes to 8
        assert width == 4 < nbr.shape[1]
