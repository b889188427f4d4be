"""The serving engine (``RFANNEngine``) over one index on one device."""
