"""Recall@10 of every query answered in the window against the reference's
exact range-filtered top-10 (``judge.recall``)."""


def read(ctx):
    return ctx.recall
