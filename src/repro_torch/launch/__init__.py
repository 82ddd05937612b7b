"""Launchers: ``python -m repro_torch.launch.serve``, ``.train`` and
``.dryrun`` (cell lowering and ``--pim``); ``launch/mesh.py`` builds the
production and lane meshes."""
