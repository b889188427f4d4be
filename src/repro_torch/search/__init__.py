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
from repro_torch.search.resolve import rank_interval, remap_ids, select_entry
from repro_torch.search.substrate import (PendingSearch, SearchSubstrate,
                                          merge_topk)

__all__ = ["PRECISIONS", "STRATEGIES", "SearchRequest", "SearchResult",
           "SearchSubstrate", "PendingSearch", "SearchCache", "query_key",
           "merge_topk", "rank_interval", "select_entry", "remap_ids"]
