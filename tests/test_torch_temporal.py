"""The port's GoFS store, edge deltas and zero-repack block patch against
the JAX package's: files each package wrote read back equal in the other,
the same delta on the same graph gives equal graphs, dirty masks, stats,
event logs and patched host blocks, and the same malformed delta is
rejected with the same message. No engine runs here (those are in
tests/test_torch_incremental.py)."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import repro.core.blocks as jblocks  # noqa: E402
import repro.gofs as jgofs  # noqa: E402
from repro.gofs.formats import partition_graph as j_partition_graph  # noqa: E402
from repro.gofs.generators import random_graph as j_random_graph  # noqa: E402

import repro_torch.core.blocks as tblocks  # noqa: E402
import repro_torch.gofs as tgofs  # noqa: E402
from repro_torch.gofs.formats import (PAD,  # noqa: E402
                                      partitioned_graph_from_fields)


def _assert_fields_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, dict):
            assert va.keys() == vb.keys(), f.name
            for k in va:
                assert np.array_equal(va[k], vb[k]), (f.name, k)
        elif isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, f.name
            assert np.array_equal(va, vb), f.name
        else:
            assert va == vb, f.name


def _assert_blocks_equal(jb, tb):
    assert set(jb) == set(tb)
    for k, v in tb.items():
        assert v.dtype == jb[k].dtype, k
        assert v.shape == jb[k].shape, k
        assert np.array_equal(v, jb[k]), k


def _both(jpg):
    """The JAX graph and the port's copy of it."""
    return jpg, partitioned_graph_from_fields(dataclasses.asdict(jpg))


def _deltas(d):
    """One EdgeDelta's arrays as a delta of each package."""
    kw = dict(insert_src=d["isrc"], insert_dst=d["idst"],
              insert_wgt=d.get("iwgt"), remove_src=d.get("rsrc", ()),
              remove_dst=d.get("rdst", ()))
    return jgofs.EdgeDelta.of(**kw), tgofs.EdgeDelta.of(**kw)


@pytest.fixture(scope="module")
def road():
    jg = jgofs.road_grid(9, 13, drop_frac=0.07, seed=5, weighted=True)
    jg.attrs["color"] = np.arange(jg.n).astype(np.float32)
    jg.attrs["heat"] = np.linspace(0, 1, jg.n).astype(np.float32)
    return jg, j_partition_graph(jg, jgofs.bfs_grow_partition(jg, 4, seed=0),
                                 4)


# ---------------- the store, both ways ----------------

def test_store_files_read_by_the_other_package(road, tmp_path):
    """Files the port wrote load in the JAX package to equal fields, and
    the reverse."""
    jg, jpg = road
    _, tpg = _both(jpg)
    for writer in ("port", "jax"):
        root = str(tmp_path / writer)
        if writer == "port":
            tgofs.GoFSStore(root).write("g", tpg)
            got = jgofs.GoFSStore(root).load_partitioned(
                "g", attrs=["color", "heat"])
            want = jpg
        else:
            jgofs.GoFSStore(root).write("g", jpg)
            got = tgofs.GoFSStore(root).load_partitioned(
                "g", attrs=["color", "heat"])
            want = tpg
        _assert_fields_equal(want, got)
        assert type(got).__module__.startswith(
            "repro.gofs" if writer == "port" else "repro_torch.gofs"), writer


def test_store_build_matches(road, tmp_path):
    """``build`` partitions with each package's own code and writes equal
    files."""
    jg, _ = road
    tg = tgofs.road_grid(9, 13, drop_frac=0.07, seed=5, weighted=True)
    tg.attrs = dict(jg.attrs)
    assign = jgofs.bfs_grow_partition(jg, 4, seed=0)
    jpg = jgofs.GoFSStore(str(tmp_path / "j")).build("g", jg, assign, 4)
    tpg = tgofs.GoFSStore(str(tmp_path / "t")).build("g", tg, assign, 4)
    _assert_fields_equal(jpg, tpg)
    for p in range(4):
        jp = jgofs.GoFSStore(str(tmp_path / "j")).load_partition("g", p)
        tp = tgofs.GoFSStore(str(tmp_path / "t")).load_partition("g", p)
        assert jp.keys() == tp.keys()
        for k in jp:
            assert np.array_equal(jp[k], tp[k]), (p, k)


def test_store_attribute_subset_lazy_load(tmp_path, monkeypatch):
    """Loading one of two attributes never OPENS the other's slice file
    (the JAX package's tests/test_gofs.py holds its store to the same)."""
    g = tgofs.road_grid(8, 8, seed=7)
    g.attrs["color"] = np.arange(g.n).astype(np.float32)
    g.attrs["heat"] = np.linspace(0, 1, g.n).astype(np.float32)
    st = tgofs.GoFSStore(str(tmp_path))
    pg = st.build("g", g, tgofs.bfs_grow_partition(g, 2, seed=0), 2)
    opened = []
    real_load = np.load

    def spy_load(path, *a, **kw):
        opened.append(str(path))
        return real_load(path, *a, **kw)

    monkeypatch.setattr(np, "load", spy_load)
    part = st.load_partition("g", 0, attrs=["color"])
    assert "attr_color" in part and "attr_heat" not in part
    np.testing.assert_array_equal(part["attr_color"], pg.attrs["color"][0])
    assert any(p.endswith("attr_color.npz") for p in opened)
    assert not any("attr_heat" in p for p in opened)
    whole = st.load_partitioned("g", attrs=["heat"])
    assert set(whole.attrs) == {"heat"}
    assert "nbr" in st.load_partition("g", 1)


# ---------------- validate_delta ----------------

# (name, delta fields, directed, weight_domain)
BAD_DELTAS = [
    ("insert_src_range", dict(isrc=[200], idst=[0]), False, "nonneg"),
    ("insert_dst_negative", dict(isrc=[0], idst=[-3]), False, "nonneg"),
    ("remove_src_range", dict(isrc=[], idst=[], rsrc=[117], rdst=[1]),
     False, "nonneg"),
    ("remove_dst_range", dict(isrc=[], idst=[], rsrc=[1], rdst=[999]),
     False, "nonneg"),
    ("nan_weight", dict(isrc=[0, 1], idst=[1, 2], iwgt=[1.0, np.nan]),
     False, "nonneg"),
    ("negative_weight", dict(isrc=[0], idst=[5], iwgt=[-2.0]), False,
     "nonneg"),
    ("unknown_domain", dict(isrc=[0], idst=[5]), False, "real"),
    ("contradictory_undirected", dict(isrc=[4], idst=[9], rsrc=[9],
                                      rdst=[4]), False, "nonneg"),
    ("contradictory_directed", dict(isrc=[4], idst=[9], rsrc=[4],
                                    rdst=[9]), True, "nonneg"),
]


def test_validate_delta_rejects_like_jax(road):
    """Every malformed delta of BAD_DELTAS is refused by both packages with
    the same message, before the port's graph changes."""
    for name, fields, directed, domain in BAD_DELTAS:
        jpg, tpg = _both(road[1])
        jd, td = _deltas(fields)
        with pytest.raises(jgofs.DeltaValidationError) as je:
            jgofs.validate_delta(jpg, jd, directed=directed,
                                 weight_domain=domain)
        with pytest.raises(tgofs.DeltaValidationError) as te:
            tgofs.apply_delta(tpg, td, directed=directed,
                              weight_domain=domain)
        assert str(te.value) == str(je.value), name
        assert isinstance(te.value, ValueError), name
        assert tpg.version == 0, name


def test_validate_delta_accepts_what_jax_accepts(road):
    jpg, tpg = _both(road[1])
    # opposite arcs of a directed graph are different edges; negative
    # weights pass under 'any'
    jd, td = _deltas(dict(isrc=[4], idst=[9], iwgt=[-1.0], rsrc=[9],
                          rdst=[4]))
    jgofs.validate_delta(jpg, jd, directed=True, weight_domain="any")
    tgofs.validate_delta(tpg, td, directed=True, weight_domain="any")


# ---------------- apply_delta, with and without block= ----------------

def _local_ids(pg, p, k, skip=()):
    ids = [int(x) for x in pg.global_id[p][pg.vmask[p]] if int(x) not in skip]
    return ids[:k]


def _delta_case(name, jg, jpg):
    """(delta fields, directed) of one apply_delta case on the road graph."""
    rng = np.random.default_rng(11)
    n = jg.n
    if name == "inserts":
        iu = rng.integers(0, n, 30)
        iv = (iu + rng.integers(1, n, 30)) % n
        return dict(isrc=iu, idst=iv,
                    iwgt=rng.uniform(1, 5, 30).astype(np.float32)), False
    a = jg.csr().tocoo()
    src, dst, w = a.col, a.row, a.data.astype(np.float32)
    und = np.flatnonzero(src < dst)
    if name == "removals_and_weight_updates":
        pick = rng.choice(und, 12, replace=False)
        keep = np.setdiff1d(und, pick)[:6]
        # existing edges re-inserted lower (updated) and higher (kept)
        iw = np.concatenate([w[keep[:3]] * 0.5, w[keep[3:]] * 2.0])
        return dict(isrc=src[keep], idst=dst[keep], iwgt=iw,
                    rsrc=np.r_[src[pick], 0], rdst=np.r_[dst[pick], n - 1]
                    ), False
    if name == "directed":
        iu = rng.integers(0, n, 25)
        iv = (iu + 1 + rng.integers(0, n - 1, 25)) % n
        pick = rng.choice(np.flatnonzero(src != dst), 10, replace=False)
        return dict(isrc=iu, idst=iv, rsrc=src[pick], rdst=dst[pick]), True
    if name == "row_widens":
        # one vertex's in-row gets more local in-edges than its lanes hold
        tgt = int(jpg.global_id[0][np.flatnonzero(jpg.vmask[0])[0]])
        srcs = _local_ids(jpg, 0, jpg.d_max + 3, skip={tgt})
        return dict(isrc=srcs, idst=[tgt] * len(srcs)), True
    if name == "cap_grows":
        # more remote edges from partition 0 into partition 1 than the
        # pair's slots hold
        k = jpg.mailbox_cap + 5
        return dict(isrc=_local_ids(jpg, 0, k), idst=_local_ids(jpg, 1, k)
                    ), True
    raise ValueError(name)


DELTA_CASES = ["inserts", "removals_and_weight_updates", "directed",
               "row_widens", "cap_grows"]


@pytest.mark.parametrize("with_block", [False, True],
                         ids=["no_block", "block"])
def test_apply_delta_matches_jax(with_block, road):
    """Each delta of DELTA_CASES gives equal graphs, dirty masks, stats,
    event logs and (with ``block=``) patched blocks in both packages."""
    jg, jpg0 = road
    for case in DELTA_CASES:
        jpg, tpg = _both(jpg0)
        fields, directed = _delta_case(case, jg, jpg)
        jd, td = _deltas(fields)
        jb = jblocks.host_graph_block(jpg) if with_block else None
        tb = tblocks.host_graph_block(tpg) if with_block else None
        jr = jgofs.apply_delta(jpg, jd, directed=directed, block=jb)
        tr = tgofs.apply_delta(tpg, td, directed=directed, block=tb)
        _assert_fields_equal(jr.pg, tr.pg)
        assert np.array_equal(jr.dirty_insert, tr.dirty_insert), case
        assert np.array_equal(jr.dirty_remove, tr.dirty_remove), case
        assert jr.stats == tr.stats, case
        assert np.array_equal(jr.events[0], tr.events[0]), case
        assert jr.events[1:] == tr.events[1:], case
        if case == "row_widens":
            assert tr.pg.d_max > tpg.d_max
        if case == "cap_grows":
            assert tr.pg.mailbox_cap > tpg.mailbox_cap
            if with_block:          # sticky growth is lane-padded
                assert tr.pg.mailbox_cap % 8 == 0
        if case == "removals_and_weight_updates":
            assert tr.stats["weight_updated"] > 0 and tr.stats["removed"] > 0
            assert tr.stats["remove_missed"] >= 1
        if with_block:
            _assert_blocks_equal(jr.block, tr.block)
            assert tblocks.verify_host_block(tr.block) == [], case
        else:
            assert tr.block is None, case


# ---------------- patch_host_block over a delta chain ----------------

def _chain_deltas(jpg, hb, rng, v):
    """Delta ``v`` of the chain: remote edges removed, random inserts, and
    in delta 1 two stars that promote a vertex to hub on both sides of the
    block (its adjacency row past w_lo, its feed list past m_lo)."""
    n = jpg.n_global
    srcs, dsts = [], []
    for p in range(jpg.num_parts):
        m = jpg.re_src[p] != PAD
        srcs.append(jpg.global_id[p][jpg.re_src[p][m]])
        dsts.append(jpg.global_id[jpg.re_dst_part[p][m],
                                  jpg.re_dst_local[p][m]])
    el = np.stack([np.concatenate(srcs), np.concatenate(dsts)], 1)
    el = el[el[:, 0] < el[:, 1]]
    pick = rng.choice(el.shape[0], min(8, el.shape[0]), replace=False)
    rs, rd = el[pick, 0], el[pick, 1]
    iu = rng.integers(0, n, 20)
    iv = (iu + rng.integers(1, n, 20)) % n
    iw = rng.uniform(0.5, 4.0, 20).astype(np.float32)
    if v == 1:
        deg = (jpg.nbr[0] != PAD).sum(1) + (hb["ib_lo"][0] != PAD).sum(1)
        deg[~jpg.vmask[0]] = 1 << 20
        tl = int(np.argmin(deg))
        tgt = int(jpg.global_id[0][tl])
        local = _local_ids(jpg, 0, hb["nbr_lo"].shape[2] + 2, skip={tgt})
        remote = [int(x) for p in range(1, jpg.num_parts)
                  for x in jpg.global_id[p][jpg.vmask[p]]
                  ][:hb["ib_lo"].shape[2] + 2]
        star = np.asarray(local + remote, np.int64)
        iu = np.r_[iu, star]
        iv = np.r_[iv, np.full(star.size, tgt)]
        iw = np.r_[iw, np.full(star.size, 1.5, np.float32)]
    ok = ~np.isin(np.minimum(iu, iv) * n + np.maximum(iu, iv), rs * n + rd)
    return dict(isrc=iu[ok], idst=iv[ok], iwgt=iw[ok], rsrc=rs, rdst=rd)


def _hubs(hb, key):
    """The (partition, vertex) pairs of a block's hub rows."""
    return {(p, int(hb[key][p, h])) for p, h in zip(*np.nonzero(hb[key]
                                                               != PAD))}


def test_patch_host_block_chain_matches_jax():
    jg = jgofs.powerlaw_social(500, m=4, seed=2)
    jpg, tpg = _both(j_partition_graph(
        jg, jgofs.bfs_grow_partition(jg, 4, seed=0), 4))
    jb, tb = jblocks.host_graph_block(jpg), tblocks.host_graph_block(tpg)
    _assert_blocks_equal(jb, tb)
    adj0, ib0 = _hubs(tb, "adj_hub_idx"), _hubs(tb, "ib_hub_idx")
    rng = np.random.default_rng(5)
    for v in range(1, 4):
        jd, td = _deltas(_chain_deltas(jpg, tb, rng, v))
        replica = {k: np.array(a, copy=True) for k, a in tb.items()}
        jr = jgofs.apply_delta(jpg, jd, directed=False, block=jb)
        tr = tgofs.apply_delta(tpg, td, directed=False, block=tb)
        _assert_fields_equal(jr.pg, tr.pg)
        _assert_blocks_equal(jr.block, tr.block)
        assert tblocks.verify_host_block(tr.block) == []
        # the event log patches a further replica of the old block to the
        # same entries (the traffic profile aside: apply_delta announces
        # the dirty frontier into its own block only)
        again = tblocks.patch_host_block(replica, tr.pg, *tr.events)
        for k in set(again) - {"wire_ewma", "announce_ewma"}:
            assert np.array_equal(again[k], tr.block[k]), (v, k)
        jpg, jb, tpg, tb = jr.pg, jr.block, tr.pg, tr.block
        assert tpg.version == v
    assert _hubs(tb, "adj_hub_idx") - adj0, "no adjacency hub promoted"
    assert _hubs(tb, "ib_hub_idx") - ib0, "no feed hub promoted"


# ---------------- verify_host_block ----------------

def _corrupt(hb, kind, pg):
    bad = dict(hb)
    i = tuple(np.argwhere(hb["nbr"] != PAD)[0])
    if kind == "nbr_out_of_range":
        bad["nbr"] = np.array(hb["nbr"], copy=True)
        bad["nbr"][i] = pg.v_max + 5
    elif kind == "nan_weight":
        bad["wgt"] = np.array(hb["wgt"], np.float32, copy=True)
        bad["wgt"][i] = np.nan
    elif kind == "missing_ob_inv":
        del bad["ob_inv"]
    elif kind == "shape_drift":
        bad["wgt_lo"] = hb["wgt_lo"][:, :, :-1]
        bad["re_dst_part"] = np.where(hb["re_src"] != PAD, pg.num_parts,
                                      hb["re_dst_part"])
    return bad


def test_verify_host_block_matches_jax():
    """Both packages list the same problems in a clean block (none) and in
    each corrupted one."""
    jg = j_random_graph(60, avg_degree=4.0, seed=3, weighted=True)
    jpg, tpg = _both(j_partition_graph(
        jg, jgofs.bfs_grow_partition(jg, 4, seed=0), 4))
    jhb, thb = jblocks.host_graph_block(jpg), tblocks.host_graph_block(tpg)
    for kind in ("clean", "nbr_out_of_range", "nan_weight", "missing_ob_inv",
                 "shape_drift"):
        jp = jblocks.verify_host_block(_corrupt(jhb, kind, jpg))
        tp = tblocks.verify_host_block(_corrupt(thb, kind, tpg))
        assert tp == jp, kind
        assert (tp == []) == (kind == "clean"), kind


# ---------------- TemporalStore ----------------

def test_temporal_store_materialize_and_replay(road, tmp_path):
    jg, jpg0 = road
    jpg, tpg = _both(jpg0)
    st = tgofs.TemporalStore(str(tmp_path))
    st.write("g", tpg)
    assert st.latest_version("g") == 0
    d1 = dict(isrc=[0, 5], idst=[99, 110], iwgt=[2.0, 3.0])
    d2 = dict(isrc=[7], idst=[8], rsrc=[0], rdst=[99])
    jd1, td1 = _deltas(d1)
    jd2, td2 = _deltas(d2)
    assert st.append_delta("g", td1) == 1
    assert st.append_delta("g", td2, directed=True) == 2
    got, directed = st.load_delta("g", 2)
    assert directed and np.array_equal(got.remove_dst, td2.remove_dst)
    mem1 = tgofs.apply_delta(tpg, td1).pg
    mem2 = tgofs.apply_delta(mem1, td2, directed=True).pg
    jmem2 = jgofs.apply_delta(jgofs.apply_delta(jpg, jd1).pg, jd2,
                              directed=True).pg
    _assert_fields_equal(mem1, st.materialize("g", version=1,
                                              attrs=["color", "heat"]))
    latest = st.materialize("g", attrs=["color", "heat"])
    assert latest.version == 2
    _assert_fields_equal(mem2, latest)
    _assert_fields_equal(jmem2, latest)
    # the JAX package replays the port's delta chain to the same graph
    jlatest = jgofs.TemporalStore(str(tmp_path)).materialize(
        "g", attrs=["color", "heat"])
    _assert_fields_equal(jmem2, jlatest)
