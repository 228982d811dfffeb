"""Roofline accounting of the port on the H100: per-kernel work from
problem shapes, per-step operation counts on ``meta`` tensors, and the
compute / memory / collective terms of a dry-run record.  Counterpart of
``repro/roofline``."""

from repro_torch.roofline.analysis import (HW, RooflineTerms, Work, kernel_work, model_flops,
                                           roofline_from_artifact)

__all__ = ["HW", "RooflineTerms", "Work", "kernel_work", "model_flops",
           "roofline_from_artifact"]
