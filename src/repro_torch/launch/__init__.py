"""Entry points of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``, and the meshes of ranks they run
on (``launch.mesh``).  Counterpart of ``repro/launch``; the dry-run
launcher belongs to a later slice (ROADMAP.md)."""
