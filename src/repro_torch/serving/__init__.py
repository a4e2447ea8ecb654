"""Gopher Serve: multi-tenant batched graph-query serving.

The port of the JAX package's ``serving``: many concurrent SSSP / BFS /
reachability / personalized-PageRank queries are batched along a query
axis and answered by ONE engine run (``GopherEngine.run_queries``), fronted
by exact and landmark caches and a batching planner.
"""
from repro_torch.serving.batched import (BatchedPersonalizedPageRank,
                                         BatchedSemiringProgram,
                                         gather_query_results, ppr_query_seed,
                                         reachability_query_init,
                                         sssp_query_init)
from repro_torch.serving.cache import (LandmarkCache, ResultCache,
                                       choose_landmarks)
from repro_torch.serving.planner import Batch, Query, bucket_size, plan
from repro_torch.serving.service import (GraphQueryService, Response,
                                         ServiceStats)

__all__ = [
    "BatchedSemiringProgram", "BatchedPersonalizedPageRank",
    "sssp_query_init", "reachability_query_init", "ppr_query_seed",
    "gather_query_results",
    "ResultCache", "LandmarkCache", "choose_landmarks",
    "Query", "Batch", "plan", "bucket_size",
    "GraphQueryService", "Response", "ServiceStats",
]
