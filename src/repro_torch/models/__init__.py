"""Model zoo of the port: decoder LMs with quantized (binary / ternary /
ternary-binary / u8 / u4 / float) projections: attention ("A", "AL")
and Mamba2/SSD ("M") mixers, dense ("D") and MoE ("E") FFNs, dense slab,
paged ternary (``tnn2``) and SSM decode caches."""

from repro_torch.models.common import ModelConfig, ShardLayout
from repro_torch.models.kvcache import init_caches
from repro_torch.models.model import (decode_step, forward, forward_hidden, init_lm,
                                      logits_from_hidden, prefill)
