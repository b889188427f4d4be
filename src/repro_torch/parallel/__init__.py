"""Shard placement for the multi-device paths (``parallel/sharding.py``)
and the GPipe schedule (``parallel/pipeline.py``)."""
