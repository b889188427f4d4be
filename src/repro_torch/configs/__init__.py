"""Architecture configs of the LM scaffold: ``registry.get_config`` and the
ten arch files, copied from the reference's ``repro.configs``."""
