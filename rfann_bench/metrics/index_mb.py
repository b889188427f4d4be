"""The built index's size in MiB (``RNSGIndex.stats()["index_mb"]``)."""


def read(ctx):
    return ctx.index_stats.get("index_mb")
