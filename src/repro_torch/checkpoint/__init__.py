"""Fault-tolerant, cross-package train-state checkpoints
(``checkpoint.py``)."""
