"""Launchers: ``python -m repro_torch.launch.serve``, ``.train`` and
``.dryrun --pim``."""
