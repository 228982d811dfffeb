"""AdamW with int8-quantized moments + error-feedback gradient
compression for the data-parallel all-reduce.  Counterpart of
``repro/optim``."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule, global_norm)
from repro_torch.optim.compression import (compress_int8, decompress_int8,
                                           ef_compress_update, ef_state_init)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm", "compress_int8",
           "decompress_int8", "ef_compress_update", "ef_state_init"]
