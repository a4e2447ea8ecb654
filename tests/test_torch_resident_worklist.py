"""What kernel K4's design relies on, on the CPU.

K4 (``csrc/megastep.cu`` ``resident_kernel``) runs the resident loop in
one cooperative launch. Each round delivers only over the feed rows
(``kernels.megastep.feed_rows``) and sweeps either every row or a work
list of the frontier's rows and their out-neighbours, by the frontier's
size (``k4_dense_rows``). Each row's x and its round stamp share one
8-byte word, two such arrays by the round's parity, and the send set is a
second pair of stamped arrays, so nothing is cleared between rounds. A
CUDA kernel has no CPU mode, so these tests hold what it relies on:

- ``feed_rows`` is exactly the rows with a valid lo lane or a hub row;
- the round schedule K4 runs, written out below in numpy with the
  kernel's own buffers (stamped words, lists, claims and counters), gives
  the state of ``resident_megastep_ref`` after every round and its
  outputs at every exit, and the JAX package's ``resident_megastep_pallas``
  in interpret mode agrees with both, bit for bit: road and powerlaw
  graphs, P 1/3/5, both semirings, from the init state and after one
  superstep, with the walks switching by the wrapper's constant and with
  each walk forced.

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

GRAPHS = {
    # a road grid: long paths, the main path's kind of graph
    "road": lambda: road_grid(10, 11, drop_frac=0.06, seed=3, weighted=True),
    # a powerlaw graph: hub rows with long out-lists, and hub feed rows
    "social": lambda: powerlaw_social(400, m=5, seed=2),
}
PARTS = [1, 3, 5]
SEMIRINGS = ["max_first", "min_plus"]
# the walks: by the wrapper's constant, every sweep dense, every sweep by
# work list (K4_DENSE_FRONTIER)
WALKS = {"switch": None, "dense": 0.0, "list": 2.0}
EXITS = (0, 1, 2, 7)                   # with rounds - 1, rounds and 4096
PALLAS_EXITS = (0, 2, 4096)            # and one round a call, every round


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
    """(JAX pg, JAX mailbox, port block, port mailbox) for one graph in P
    partitions, built once from the same partitioned arrays."""
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
        _BLOCKS[name, P] = (pg, jcm, tgb, tmega.compose_mailbox(tgb))
    return _BLOCKS[name, P]


def _starts(pg, tgb, cm, semiring):
    """The program's init state and the state after one superstep."""
    init = (init_max_vertex if semiring == "max_first"
            else make_sssp_init(int(pg.part_of[0]), int(pg.local_of[0])))
    st = SemiringProgram(semiring=semiring, init_fn=init).init(tgb)
    start = tuple(st[k].reshape(-1) for k in ("x", "changed_v", "frontier"))
    after = tmega.megastep_semiring_ref(*start, cm, semiring)[:3]
    return {"init": start, "after one superstep": after}


@pytest.mark.parametrize("P", PARTS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_feed_rows_are_the_rows_with_a_feed(name, P):
    *_, tcm = _blocks(name, P)
    cm = dict(tcm)
    feed = tmega.feed_rows(cm)
    assert feed.dtype == torch.int32
    lo_ok, hub_row_ok = cm["lo_ok"].numpy(), cm["hub_row_ok"].numpy()
    want = np.nonzero(lo_ok.any(axis=1) | hub_row_ok)[0]
    assert np.array_equal(feed.numpy(), want)
    # every other row receives nothing: no valid lo lane, no hub row
    rest = np.setdiff1d(np.arange(cm["n"]), want)
    assert not lo_ok[rest].any() and not hub_row_ok[rest].any()
    if name == "social" and P > 1:
        assert hub_row_ok.any()                 # hub feed rows are covered
    assert tmega.feed_rows(cm) is feed          # built once, kept in cm


def test_k4_dense_rows_follow_the_constant(monkeypatch):
    for frac, want in ((0.0, 0), (0.125, 245001), (1.0, 1960008),
                       (2.0, 1960009)):
        monkeypatch.setattr(tmega, "K4_DENSE_FRONTIER", frac)
        assert tmega.k4_dense_rows(1960008) == want


def k4_schedule(x, changed, frontier, cm, semiring, max_steps, dense_rows,
                each_round=None):
    """The resident loop as K4 schedules it, with its buffers: two (x,
    stamp) arrays by round parity (stamp r: in round r's frontier), two
    (x, stamp) send arrays (stamp r: in round r's send set), a claim stamp
    a row, two lists with the counters' ring. Each round delivers over the
    feed rows only, reading sources from the send array; then sweeps every
    row (frontier >= ``dense_rows``), the list the last sweep and this
    delivery appended to, or, after a dense sweep, the rows found by their
    stamps with their out-neighbours. A sweep writes x2 only where a row
    is in the frontier or moves. ``each_round(r, x2, changed2,
    frontier2, active_p)`` sees each round's state read from the buffers.
    Returns (x2, changed2, frontier2, iters, liters, walks)."""
    minp = semiring == "min_plus"
    pick = np.minimum if minp else np.maximum
    ident = np.float32(np.inf if minp else -np.inf)
    n, P, v_max = cm["n"], cm["num_parts"], cm["v_max"]
    vm = cm["vmask"].numpy()
    nbr, wgt = (t.numpy() for t in tmega.k3_lanes(cm, "min_plus"))
    off, src = (t.numpy() for t in tmega.out_adjacency(cm))
    feed = tmega.feed_rows(cm).numpy()
    lo = [cm[k].numpy() for k in ("lo_src", "lo_ok", "lo_w")]
    hub = [cm[k].numpy() for k in ("hub_src", "hub_ok", "hub_w")]
    hub_row, hub_row_ok = cm["hub_row"].numpy(), cm["hub_row_ok"].numpy()
    x, ch, fr = (t.numpy() for t in (x, changed, frontier))
    cap = max(1, min(dense_rows, n))

    ys_x, ys_st = np.stack([x, x]), np.full((2, n), -1, np.int64)
    ys_st[0][fr] = 0
    sn_x, sn_st = np.stack([x, x]), np.full((2, n), -1, np.int64)
    sn_st[0][ch] = 0
    claim = np.full(n, -1)
    lists = np.full((2, cap), -1)
    cnt, runs = np.zeros(3, np.int64), np.zeros(3, bool)
    pf = np.zeros((3, P), bool)
    cnt[0], runs[0] = fr.sum(), ch.any()
    pf[0] = fr.reshape(P, v_max).any(axis=1)
    liters = np.zeros(P, np.int32)
    listed, walks, r = False, [], 0

    def append(slot, par, v):
        if cnt[slot] < cap:
            lists[par][cnt[slot]] = v
        cnt[slot] += 1

    def feeds(srcs, ok, w, rows, sc_x, sc_st):
        live = ok[rows] & (sc_st[srcs[rows]] == r)
        g = sc_x[srcs[rows]] + (w[rows] if minp else 0)
        return pick.reduce(np.where(live, g, ident), axis=1, initial=ident)

    while r < max_steps and runs[r % 3]:
        cur, nxt, c_, n_ = r % 3, (r + 1) % 3, r & 1, (r + 1) & 1
        yx, yst, ynx, ynst = ys_x[c_], ys_st[c_], ys_x[n_], ys_st[n_]
        # delivery over the feed rows: sources from the send array only,
        # so the in-place writes to yx at feed rows are never read here
        inbox = feeds(*lo, feed, sn_x[c_], sn_st[c_])
        hr = feed[hub_row_ok[feed]]
        inbox[hub_row_ok[feed]] = pick(
            inbox[hub_row_ok[feed]],
            feeds(*hub, hub_row[hr], sn_x[c_], sn_st[c_]))
        x1 = pick(yx[feed], inbox)
        moved = x1 != yx[feed]
        out = feed[moved & ~vm[feed]]           # no frontier: both arrays
        yx[out] = ynx[out] = x1[moved & ~vm[feed]]
        ynst[out] = -1
        rows = feed[moved & vm[feed]]
        new = rows[yst[rows] != r]              # not yet in f_r
        yx[rows], yst[rows] = x1[moved & vm[feed]], r
        sn_x[n_][rows], sn_st[n_][rows] = yx[rows], r + 1
        runs[nxt] |= rows.size > 0
        pf[cur][np.unique(new // v_max)] = True
        for v in new:
            if listed:
                append(cur, c_, v)
            else:
                cnt[cur] += 1

        # the sweep, by the walk the frontier's size picks
        c = int(cnt[cur])
        assert c == int((yst == r).sum())       # the counter is |f_r|
        liters += pf[cur]
        if each_round is not None:
            active_p = pf[cur].copy()
        cnt[(r + 2) % 3], runs[(r + 2) % 3] = 0, False
        pf[(r + 2) % 3] = False
        dense = c >= dense_rows
        if c == 0:
            rows = np.zeros(0, int)
        elif dense:
            rows = np.arange(n)
        else:
            if listed:
                entries = lists[c_][:c]
                assert np.array_equal(np.sort(entries),
                                      np.nonzero(yst == r)[0])
            else:                               # found by their stamps
                entries = np.nonzero(yst == r)[0]
            segs = [np.concatenate([[s], src[off[s]:off[s + 1]]])
                    for s in entries]
            rows = np.unique(np.concatenate(segs))
            assert (claim[rows] != r).all()
            claim[rows] = r                     # each row claimed once
        walks.append("none" if c == 0 else "dense" if dense
                     else "list" if listed else "scan")
        lanes = nbr[rows]
        ok = lanes != PAD
        safe = np.where(ok, lanes, 0)
        act = (ok & (yst[safe] == r)).any(axis=1)
        g = yx[safe] + (wgt[rows] if minp else 0)
        y = (np.where(ok, g, ident).min(1) if minp
             else np.where(ok, g, ident).max(1))
        x1 = yx[rows]
        x2 = np.where(act, pick(x1, y), x1)
        moved = (x2 != x1) & vm[rows]
        keep = (yst[rows] == r) | moved         # the rows that are written
        ynx[rows[keep]] = x2[keep]
        ynst[rows[keep]] = np.where(moved[keep], r + 1, -1)
        sn_x[n_][rows[moved]], sn_st[n_][rows[moved]] = x2[moved], r + 1
        if moved.any():
            runs[nxt] = True
            pf[nxt][np.unique(rows[moved] // v_max)] = True
        for v in rows[moved]:
            if dense:
                cnt[nxt] += 1
            else:
                append(nxt, n_, v)
        listed = not dense
        r += 1
        if each_round is not None:
            each_round(r, ys_x[n_].copy(), sn_st[n_] == r, ynst == r,
                       active_p)
    par = r & 1
    return (torch.from_numpy(ys_x[par].copy()),
            torch.from_numpy(sn_st[par] == r),
            torch.from_numpy(ys_st[par] == r),
            torch.tensor(r, dtype=torch.int32), torch.from_numpy(liters),
            walks)


_PALLAS = {}


def _pallas(name, P, semiring, max_steps, state):
    """resident_megastep_pallas in interpret mode, one compile a case."""
    key = (name, P, semiring, max_steps)
    if key not in _PALLAS:
        jcm = _blocks(name, P)[1]
        _PALLAS[key] = jax.jit(lambda *a: jmega.resident_megastep_pallas(
            *a, jcm, semiring, max_steps, interpret=True))
    out = _PALLAS[key](*(jnp.asarray(t.numpy()) for t in state))
    return [np.asarray(o) for o in out]


def _same(got, want, what):
    for field, g, w in zip(("x2", "changed2", "frontier2", "iters",
                            "liters"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert np.array_equal(g, w), (what, field)


@pytest.mark.parametrize("walk", sorted(WALKS))
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("P", PARTS)
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_k4_schedule_matches_ref_and_pallas(monkeypatch, name, P, semiring,
                                            walk):
    pg, _, tgb, tcm = _blocks(name, P)
    cm = dict(tcm)
    if WALKS[walk] is not None:
        monkeypatch.setattr(tmega, "K4_DENSE_FRONTIER", WALKS[walk])
    dense_rows = tmega.k4_dense_rows(cm["n"])
    seen = set()
    for sname, start in _starts(pg, tgb, cm, semiring).items():
        # every round: the buffers' state against the plain round, and the
        # plain round against Pallas (one round a call)
        state = list(start)

        def each_round(r, x2, ch2, fr2, active_p):
            want = tmega.resident_step_semiring(*state, cm, semiring)
            pal = _pallas(name, P, semiring, 1, state)
            for what, g, w, p in zip(("x2", "changed2", "frontier2"),
                                     (x2, ch2, fr2), want, pal):
                assert np.array_equal(g, w.numpy()), (sname, r, what)
                assert np.array_equal(g, p), (sname, r, what, "pallas")
            assert np.array_equal(active_p, want[3].numpy()), (sname, r)
            assert np.array_equal(pal[4], active_p.astype(np.int32))
            state[:] = want[:3]

        *_, walks = k4_schedule(*start, cm, semiring, 4096, dense_rows,
                                each_round)
        rounds = len(walks)
        assert rounds > 0
        seen.update(walks)
        # the exits: a cut before quiescence, at it, and none
        for max_steps in sorted({*EXITS, rounds - 1, rounds, 4096}):
            got = k4_schedule(*start, cm, semiring, max_steps, dense_rows)
            want = tmega.resident_megastep_ref(*start, cm, semiring,
                                               max_steps)
            _same(got[:5], want, (sname, max_steps))
            assert int(got[3]) == min(max_steps, rounds)
            if max_steps in PALLAS_EXITS:
                _same(got[:5], _pallas(name, P, semiring, max_steps, start),
                      (sname, max_steps, "pallas"))
    if walk == "dense":
        assert seen <= {"dense", "none"}
    elif walk == "list":
        assert "dense" not in seen and {"scan", "list"} <= seen
    elif name == "road":
        assert {"dense", "scan", "list"} <= seen  # the walks switch


def test_k4_schedule_no_changed_row_is_the_input():
    pg, _, tgb, tcm = _blocks("road", 3)
    cm = dict(tcm)
    x, ch, fr = _starts(pg, tgb, cm, "min_plus")["init"]
    quiet = torch.zeros_like(ch)
    for max_steps in (0, 5):
        got = k4_schedule(x, quiet, fr, cm, "min_plus", max_steps,
                          tmega.k4_dense_rows(cm["n"]))
        want = tmega.resident_megastep_ref(x, quiet, fr, cm, "min_plus",
                                           max_steps)
        _same(got[:5], want, max_steps)
        assert int(got[3]) == 0 and got[5] == []
        assert torch.equal(got[0], x) and torch.equal(got[2], fr)


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_k4_schedule_feed_row_outside_vmask(semiring):
    """A feed row outside vmask (no local edge of its own, but listed by
    its neighbours) that a delivery changes enters no frontier, so no
    sweep rewrites it: K4 writes it into both (x, stamp) arrays, and its
    neighbours read the delivered value in later rounds."""
    pg, _, tgb, tcm = _blocks("road", 3)
    cm = {k: v for k, v in tcm.items()
          if k not in ("out_off", "out_src", "k3_nbr", "k3_wgt", "k3_width",
                       "feed_rows")}
    nbr, vm = cm["nbr"].clone(), cm["vmask"].clone()
    feed = tmega.feed_rows(dict(cm)).numpy()
    v = int(feed[np.isin(feed, nbr.numpy())][0])
    nbr[v], vm[v] = PAD, False
    cm["nbr"], cm["vmask"] = nbr, vm
    dense_rows = tmega.k4_dense_rows(cm["n"])
    moved = False
    for start in _starts(pg, tgb, cm, semiring).values():
        got = k4_schedule(*start, cm, semiring, 4096, dense_rows)
        want = tmega.resident_megastep_ref(*start, cm, semiring, 4096)
        _same(got[:5], want, "outside vmask")
        moved |= bool(got[0][v] != start[0][v])
    assert moved                      # a delivery did change the row
