"""Kernel autotuning of the port: per-shape tile search and persistent
plans.  Counterpart of ``repro/tune``.

* :mod:`repro_torch.tune.space` — ``TuningSpace``: the candidate
  blockings a kernel declares on its registry entry
  (``KernelSpec.tunable``): the CUDA GeMMs' CTA tile, the plain
  versions' ``word_chunk``, the indexed backend's segment width;
* :mod:`repro_torch.tune.tuner` — measures candidates on the device
  (seeded operands, median of CUDA-event times) and returns a ``Plan``;
* :mod:`repro_torch.tune.cache` — persists plans as JSON keyed by
  ``(mode, backend, fused, device_kind, m-bucket, n, k)`` with atomic,
  locked, merging writes, a ``REPRO_TUNE_CACHE`` path override and the
  untuned choice (``gemm_tile``) as the fallback.

``ops.qmm`` resolves each request's blocking through
``cache.plan_for`` (one dict lookup once resolved), so a warm cache
re-tiles every projection without call-site changes.
``python -m repro_torch.tune`` runs offline sweeps;
``ServeConfig(autotune=...)`` tunes the engine's shapes at build.

``tuner`` is not imported here: it reaches into
``repro_torch.kernels.ops``, which imports this package's cache.
"""

from repro_torch.tune import cache, space                       # noqa: F401
from repro_torch.tune.cache import Plan, PlanCache, plan_for    # noqa: F401
from repro_torch.tune.space import TuningSpace                  # noqa: F401

__all__ = ["cache", "space", "Plan", "PlanCache", "plan_for", "TuningSpace"]
