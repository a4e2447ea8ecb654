"""Admission + batching policy for the query-serving loop.

The port's copy of the JAX package's ``serving/planner.py`` (pure Python,
the same batches and rejections). Queries are admitted (validated against
the target graph), grouped by compatibility key — (graph, program family) —
and packed into batches whose query count is padded UP to a power-of-two
bucket. The padding trades a few wasted query lanes for reuse: every batch
of a given (graph, family, bucket) triple runs on the same pooled engine,
with its composed mailbox and its shapes. Pad lanes replay the first real
query and their results are dropped (they add no supersteps: the batch halt
is the max over queries, and a duplicate finishes with its twin).

Families:
    traversal     min_plus over the graph's own weights — sssp, bfs (hop
                  counts on unit-weight graphs, per the bfs() convention),
                  and reach (multi-seed reachability) are all the SAME
                  program with different init rows, so they share one batch,
                  one engine, one compiled loop, and one cache namespace
    ppr           personalized PageRank (sum semiring, fixed supersteps)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

FAMILY_OF_KIND = {"sssp": "traversal", "bfs": "traversal",
                  "reach": "traversal", "ppr": "ppr"}
FAMILY_SEMIRING = {"traversal": "min_plus", "ppr": "sum"}


@dataclasses.dataclass(frozen=True)
class Query:
    """One graph query. ``sources`` is a tuple of global vertex ids — one
    entry for sssp/bfs/ppr, any number for reach (seed set)."""
    kind: str
    graph: str
    sources: Tuple[int, ...]

    @staticmethod
    def make(kind: str, graph: str, sources) -> "Query":
        if isinstance(sources, int):
            sources = (sources,)
        return Query(kind=kind, graph=graph, sources=tuple(int(s) for s in sources))

    @property
    def family(self) -> str:
        # unknown kinds map to themselves so cache_key()/grouping stay total;
        # validate() rejects them at admission
        return FAMILY_OF_KIND.get(self.kind, self.kind)

    def cache_key(self) -> tuple:
        return (self.graph, self.family, tuple(sorted(self.sources)))


@dataclasses.dataclass
class Batch:
    """A planned engine run: queries sharing (graph, family), padded to Q."""
    graph: str
    family: str
    queries: List[Query]
    padded_q: int                 # power-of-two bucket the batch runs at

    @property
    def fill(self) -> float:
        return len(self.queries) / self.padded_q


def bucket_size(n: int, max_batch: int = 64) -> int:
    """Smallest power of two >= n, clamped to max_batch."""
    assert n >= 1
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


def validate(q: Query, graphs: Dict[str, int]) -> Optional[str]:
    """Admission check. Returns a rejection reason or None."""
    if q.kind not in FAMILY_OF_KIND:
        return f"unknown query kind {q.kind!r}"
    if q.graph not in graphs:
        return f"unknown graph {q.graph!r}"
    if not q.sources:
        return "query has no source vertices"
    if q.kind != "reach" and len(q.sources) != 1:
        return f"{q.kind} takes exactly one source, got {len(q.sources)}"
    n = graphs[q.graph]
    for s in q.sources:
        if not (0 <= s < n):
            return f"source {s} out of range for graph {q.graph!r} (n={n})"
    return None


def plan(queries: Sequence[Query], graphs: Dict[str, int],
         max_batch: int = 64) -> Tuple[List[Batch], List[Tuple[Query, str]]]:
    """(batches, rejected) — rejected carries (query, reason).

    Grouping preserves arrival order within a group; groups larger than
    max_batch split into full max_batch chunks plus a padded tail.
    """
    rejected: List[Tuple[Query, str]] = []
    groups: Dict[Tuple[str, str], List[Query]] = {}
    for q in queries:
        reason = validate(q, graphs)
        if reason is not None:
            rejected.append((q, reason))
            continue
        groups.setdefault((q.graph, q.family), []).append(q)

    batches: List[Batch] = []
    for (graph, family), qs in groups.items():
        for i in range(0, len(qs), max_batch):
            chunk = qs[i:i + max_batch]
            batches.append(Batch(graph=graph, family=family, queries=chunk,
                                 padded_q=bucket_size(len(chunk), max_batch)))
    return batches, rejected
