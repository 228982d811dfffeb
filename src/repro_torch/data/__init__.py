"""Deterministic synthetic-LM data pipeline: seed + step fully define
every global batch, so an elastic restart re-deals bit-exact batches
over a different host set.  Counterpart of ``repro/data`` (the dry-run's
``global_batch_spec`` comes with the dry-run slice)."""

from repro_torch.data.pipeline import DataState, SyntheticLM, make_pipeline

__all__ = ["DataState", "SyntheticLM", "make_pipeline"]
