"""Entry points of the port: ``python -m repro_torch.launch.serve`` and
``python -m repro_torch.launch.train``.  Counterpart of ``repro/launch``;
the mesh and dry-run launchers belong to the operations slice
(ROADMAP.md, slice F)."""
