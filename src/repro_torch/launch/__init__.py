"""Entry points of the port: ``python -m repro_torch.launch.serve``,
``python -m repro_torch.launch.train`` and the dry-run ``python -m
repro_torch.launch.dryrun`` (``specs.py`` builds its cells), and the meshes
of ranks they run on (``launch.mesh``).  Counterpart of ``repro/launch``."""
