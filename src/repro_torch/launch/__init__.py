"""Entry points: the serve launcher (``python -m repro_torch.launch.serve``)
and the train launcher (``python -m repro_torch.launch.train``)."""
