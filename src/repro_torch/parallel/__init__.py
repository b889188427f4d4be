"""Shard placement for the multi-device paths (``parallel/sharding.py``)."""
