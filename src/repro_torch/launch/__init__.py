"""Entry points of the port: ``python -m repro_torch.launch.serve``.
Counterpart of ``repro/launch``; the mesh, dry-run and training
launchers belong to the operations slice (ROADMAP.md, slice F)."""
