"""Model zoo of the port: decoder LMs with quantized (binary / ternary /
ternary-binary / u8 / u4 / float) projections.  This slice runs the
dense-attention decoders (layer patterns of "A"/"AL" mixers and "D"
FFNs); MoE, SSM and the paged cache come with a later slice."""

from repro_torch.models.common import ModelConfig, ShardLayout
from repro_torch.models.kvcache import init_caches
from repro_torch.models.model import (decode_step, forward, forward_hidden, init_lm,
                                      logits_from_hidden, prefill)
