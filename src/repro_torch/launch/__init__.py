"""Entry points: the serve launcher (``python -m repro_torch.launch.serve``)."""
