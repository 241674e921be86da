"""Entry points users run: ``python -m repro_torch.launch.serve --he``."""
