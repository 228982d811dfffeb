"""Continuous-batching LM serving over packed low-bit weights: the
slot-scheduled Engine (bucket prefill on dense caches, chunked prefill
on paged ternary caches) and its samplers.  Counterpart of
``repro/serving``; serving on a mesh is not ported (slice F)."""

from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.engine import (ServeConfig, Engine, Request, Result,
                                        make_serve_step, make_prefill_fn,
                                        make_chunk_step)
from repro_torch.serving.scheduler import (Scheduler, BucketScheduler,
                                           ChunkedScheduler)
from repro_torch.serving.metrics import EngineMetrics

__all__ = ["SamplerConfig", "sample", "ServeConfig", "Engine", "Request",
           "Result", "make_serve_step", "make_prefill_fn",
           "make_chunk_step", "Scheduler", "BucketScheduler",
           "ChunkedScheduler", "EngineMetrics"]
