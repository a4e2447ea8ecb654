"""The port's GoFS copies and host block against the JAX package's: the same
seeds give the same graphs, assignments and partitioned arrays, and the
host block agrees entry for entry on the entries the port keeps."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import torch  # noqa: E402

import repro.core.blocks as jblocks  # noqa: E402
import repro.gofs as jgofs  # noqa: E402
from repro.gofs.formats import partition_graph as j_partition_graph  # noqa: E402

import repro_torch.core.blocks as tblocks  # noqa: E402
import repro_torch.gofs as tgofs  # noqa: E402
from repro_torch.gofs.formats import (partition_graph as t_partition_graph,  # noqa: E402
                                      partitioned_graph_from_fields)

GENERATORS = {
    "road": ("road_grid", dict(rows=9, cols=13, drop_frac=0.07, seed=5,
                               weighted=True)),
    "social": ("powerlaw_social", dict(n=400, m=5, seed=2)),
    "trace": ("trace_star", dict(n=300, n_hubs=4, seed=3)),
    "random": ("random_graph", dict(n=150, avg_degree=4.0, seed=7,
                                    weighted=True)),
}
PARTITIONERS = ["hash_partition", "bfs_grow_partition",
                "subgraph_balanced_partition"]
DEVICE_KEYS = {"nbr", "wgt", "vmask", "out_degree", "global_id", "sg_id",
               "re_src", "re_wgt", "re_dst_part", "re_dst_local", "re_slot",
               "part_index", "ob_inv", "ib_lo", "ib_hub_idx", "ib_hub",
               "wire_ewma"}


def _graphs(name):
    fn, kw = GENERATORS[name]
    if fn == "random_graph":
        from repro.gofs.generators import random_graph as jfn
    else:
        jfn = getattr(jgofs, fn)
    return jfn(**kw), getattr(tgofs, fn)(**kw)


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


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_match(name):
    jg, tg = _graphs(name)
    _assert_fields_equal(jg, tg)


@pytest.mark.parametrize("part", PARTITIONERS)
@pytest.mark.parametrize("name", ["road", "social"])
def test_partitioners_and_partition_graph_match(name, part):
    jg, tg = _graphs(name)
    ja = getattr(jgofs, part)(jg, 4, seed=1)
    ta = getattr(tgofs, part)(tg, 4, seed=1)
    assert np.array_equal(ja, ta)
    _assert_fields_equal(j_partition_graph(jg, ja, 4),
                         t_partition_graph(tg, ta, 4))


@pytest.mark.parametrize("name", ["road", "social"])
def test_host_block_matches(name):
    jg, tg = _graphs(name)
    jpg = j_partition_graph(jg, jgofs.bfs_grow_partition(jg, 4, seed=0), 4)
    tpg = t_partition_graph(tg, tgofs.bfs_grow_partition(tg, 4, seed=0), 4)
    jb = jblocks.host_graph_block(jpg)
    tb = tblocks.host_graph_block(tpg)
    assert set(tb) == set(jb)
    for k, v in tb.items():
        assert v.dtype == jb[k].dtype, k
        assert np.array_equal(v, jb[k]), k
    for jd, td in zip(jblocks._decode_feeds(jb), tblocks._decode_feeds(tb)):
        assert np.array_equal(jd, td)
    # the upload: torch tensors equal to the JAX device block's arrays
    jdev = jblocks.device_block(jb)
    tdev = tblocks.graph_block(tpg, "cpu")
    # the device block leaves the planning metadata and the binned
    # adjacency behind, and the upload of a host block equals the cold build
    assert set(tdev) == DEVICE_KEYS
    assert set(tblocks.device_block(tb, "cpu")) == DEVICE_KEYS
    for k, v in tdev.items():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu", k
        assert np.array_equal(v.numpy(), np.asarray(jdev[k])), k


def test_graph_block_builds_no_binned_adjacency(monkeypatch):
    """The engine's cold build skips the binned adjacency (O(E) host work
    only the serving sweeps need); the host block carries it."""
    tg = tgofs.road_grid(6, 7, seed=1)
    tpg = t_partition_graph(tg, tgofs.bfs_grow_partition(tg, 3, seed=0), 3)
    hb = tblocks.host_graph_block(tpg)
    assert set(tblocks._BINNED) <= set(hb)

    def refuse(*a, **kw):
        raise AssertionError("graph_block built the binned adjacency")

    monkeypatch.setattr(tblocks, "_binned_adjacency", refuse)
    gb = tblocks.graph_block(tpg, "cpu")
    assert set(gb) == DEVICE_KEYS
    for k, v in gb.items():
        assert np.array_equal(v.numpy(), tblocks.device_block(hb, "cpu")[k]
                              .numpy()), k


def test_host_block_keeps_attrs():
    tg = tgofs.road_grid(5, 6, seed=0)
    tg.attrs["w"] = np.arange(tg.n, dtype=np.float32)
    tpg = t_partition_graph(tg, tgofs.hash_partition(tg, 3, seed=0), 3)
    tb = tblocks.host_graph_block(tpg)
    assert np.array_equal(tb["attr_w"], tpg.attrs["w"])


def test_partitioned_graph_from_fields_round_trips():
    jg, _ = _graphs("social")
    jpg = j_partition_graph(jg, jgofs.bfs_grow_partition(jg, 4, seed=0), 4)
    tpg = partitioned_graph_from_fields(dataclasses.asdict(jpg))
    _assert_fields_equal(jpg, tpg)
    again = partitioned_graph_from_fields(dataclasses.asdict(tpg))
    _assert_fields_equal(tpg, again)
    with pytest.raises(ValueError, match="unknown"):
        partitioned_graph_from_fields({**dataclasses.asdict(tpg), "bogus": 1})
