"""Adaptive query planner: selectivity-aware routing between the exact
``range_scan`` kernel and graph beam search.

Pure host policy (numpy), copied from the reference: the online-calibrated
cost model, pow2 bucketing, the per-query routing decision and
``plan_batch`` partitioning.  Execution lives in the search substrate."""
from repro_torch.planner.bucketing import (bucket_for_len, ef_bucket,
                                           ef_bucket_np, next_pow2,
                                           next_pow2_np, pad_pow2,
                                           window_rows, window_rows_np)
from repro_torch.planner.cost import CostModel
from repro_torch.planner.planner import (BEAM, SCAN, Partition, Plan,
                                         QueryPlanner)

__all__ = ["CostModel", "QueryPlanner", "Plan", "Partition",
           "SCAN", "BEAM", "bucket_for_len", "ef_bucket", "ef_bucket_np",
           "next_pow2", "next_pow2_np", "pad_pow2", "window_rows",
           "window_rows_np"]
