"""Synthetic corpora, query ranges and ground truth."""
