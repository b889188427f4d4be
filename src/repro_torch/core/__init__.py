"""The paper's system: RNSG construction, entry selection, beam search and
the ``RNSGIndex`` API."""
