"""Unified search substrate: one strategy-routed execution layer.

    SearchRequest (queries, rank intervals, k/ef, strategy)
        -> resolve   (rank-interval mapping + RMQ entry selection)
        -> cache     (optional SearchCache: hit rows skip dispatch entirely)
        -> dispatch  (range_scan kernel | graph beam | planned mix)
        -> stitch    (request-order stats, rank -> original id remap)
        -> SearchResult
"""
from repro_torch.search.cache import SearchCache, query_key
from repro_torch.search.request import (PRECISIONS, STRATEGIES,
                                        SearchRequest, SearchResult)
from repro_torch.search.resolve import (clip_interval, clip_interval_torch,
                                        rank_interval, remap_ids,
                                        remap_ids_torch, select_entry)
from repro_torch.search.substrate import (MeshSubstrate, PendingSearch,
                                          SearchSubstrate, merge_topk)

__all__ = ["PRECISIONS", "STRATEGIES", "SearchRequest", "SearchResult",
           "SearchSubstrate", "PendingSearch", "SearchCache", "query_key",
           "MeshSubstrate", "merge_topk", "rank_interval", "select_entry",
           "remap_ids", "remap_ids_torch", "clip_interval",
           "clip_interval_torch"]
