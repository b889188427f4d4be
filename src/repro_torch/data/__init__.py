"""Synthetic corpora, query ranges and ground truth; the LM training
token stream (``data/tokens.py``)."""
