"""Deterministic synthetic-LM data pipeline: seed + step fully define
every global batch, so an elastic restart re-deals bit-exact batches
over a different host set.  Counterpart of ``repro/data``;
``global_batch_spec`` gives the dry-run the global batch as ``meta``
tensors."""

from repro_torch.data.pipeline import DataState, SyntheticLM, global_batch_spec, make_pipeline

__all__ = ["DataState", "SyntheticLM", "make_pipeline", "global_batch_spec"]
