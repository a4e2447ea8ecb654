"""Patched graph versions for the incremental tests: a graph's version 0
and two versions made by ``apply_delta(block=)`` whose blocks hold what a
cold build never does, and the resumes through them. Shared by the CPU
tests (tests/test_torch_incremental.py) and the card tests
(tests/test_torch_cuda.py); it imports no JAX."""
import numpy as np

from repro_torch import algorithms
from repro_torch.core import PhasedTierPlan, device_block, host_graph_block
from repro_torch.gofs import (EdgeDelta, apply_delta, bfs_grow_partition,
                              partition_graph)
from repro_torch.gofs.formats import PAD


def _ids(pg, parts, k, skip=()):
    """The first ``k`` global ids of the partitions ``parts``."""
    out = [int(x) for p in parts for x in pg.global_id[p][pg.vmask[p]]
           if int(x) not in skip]
    return out[:k]


def patched_versions(g, P):
    """A graph's version 0 and two versions patched by
    ``apply_delta(block=)``, chosen so that the patched blocks hold what a
    cold build never does: delta 1 promotes one vertex to hub on both
    sides of the block (its adjacency row past w_lo, its feed list past
    m_lo) and puts more remote edges into the pair (0, 1) than the mailbox
    cap holds, so the sticky cap grows; delta 2 removes the first local
    in-edge of rows that keep later ones (PAD holes mid-row in the ELL) and
    remote edges (holes mid-row in the feed lists). Returns (pg0, res1,
    res2), each a DeltaResult; the tests also use it on the CPU."""
    pg0 = partition_graph(g, bfs_grow_partition(g, P, seed=0), P)
    hb = host_graph_block(pg0)
    deg = np.where(pg0.vmask[0], (pg0.nbr[0] != PAD).sum(1), 1 << 20)
    tgt = int(pg0.global_id[0][int(np.argmin(deg))])
    star = (_ids(pg0, [0], hb["nbr_lo"].shape[2] + 2, skip={tgt})
            + _ids(pg0, range(1, P), hb["ib_lo"].shape[2] + 2))
    # distinct (partition 0, partition 1) pairs, more than the cap holds
    a, b = _ids(pg0, [0], pg0.v_max), _ids(pg0, [1], pg0.v_max)
    k = pg0.mailbox_cap + 20
    src = [a[i % len(a)] for i in range(k)]
    dst = [b[(i + 7 * (i // len(a))) % len(b)] for i in range(k)]
    rng = np.random.default_rng(3)
    d1 = EdgeDelta.inserts(star + src, [tgt] * len(star) + dst,
                           rng.uniform(1.0, 3.0, len(star) + len(src)))
    res1 = apply_delta(pg0, d1, directed=False, block=hb)
    pg1 = res1.pg
    rows = np.argwhere(pg1.vmask & (pg1.nbr[:, :, 0] != PAD)
                       & ((pg1.nbr[:, :, 1:] != PAD).sum(2) > 0))
    rows = rows[rng.choice(len(rows), min(12, len(rows)), replace=False)]
    rsrc = [int(pg1.global_id[p, pg1.nbr[p, v, 0]]) for p, v in rows]
    rdst = [int(pg1.global_id[p, v]) for p, v in rows]
    live = np.argwhere(pg1.re_src != PAD)
    for p, e in live[rng.choice(len(live), 12, replace=False)]:
        rsrc.append(int(pg1.global_id[p, pg1.re_src[p, e]]))
        rdst.append(int(pg1.global_id[pg1.re_dst_part[p, e],
                                      pg1.re_dst_local[p, e]]))
    key = {(min(a, b), max(a, b)) for a, b in zip(rsrc, rdst)}
    rsrc, rdst = zip(*sorted(key))
    res2 = apply_delta(pg1, EdgeDelta.removes(rsrc, rdst), directed=False,
                       block=res1.block)
    return pg0, res1, res2


def resume_all(pg0, res1, res2, device, exchange="auto", resident=False):
    """CC and SSSP from 0 through the versions of :func:`patched_versions`
    on ``device``, each resumed from the last on its patched block: a list
    of (result, Telemetry), version 1 then version 2, CC then SSSP."""
    out = []
    cc = algorithms.connected_components(pg0, device=device)[0]
    d = algorithms.sssp(pg0, 0, device=device)[0]
    for res in (res1, res2):
        gb = device_block(res.block, device)
        plan = PhasedTierPlan.from_graph(res.pg) if resident else None
        cc, _, t_cc = algorithms.incremental_connected_components(
            res.pg, cc, res, gb=gb, exchange=exchange, tier_plan=plan,
            device=device)
        d, t_d = algorithms.incremental_sssp(
            res.pg, 0, d, res, gb=gb, exchange=exchange, tier_plan=plan,
            device=device)
        out += [(cc, t_cc), (d, t_d)]
    return out
