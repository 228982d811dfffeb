"""mamba2-1.3b [ssm] — SSD, attention-free (arXiv:2405.21060).

48L d_model=2048 vocab=50280 ssm_state=128, no FFN (the SSD block *is*
the layer: pattern ("M", "-")).  d_inner = 2 * d_model = 4096, headdim 64
-> 64 SSD heads; 1 group (the published config).  head/kv counts are
placeholders — there is no attention anywhere in this arch.

O(1) recurrent decode state makes this the canonical long_500k arch.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,          # unused: attention-free
    num_kv_heads=1,       # unused
    head_dim=64,          # unused
    d_ff=0,
    vocab_size=50280,
    layer_pattern=(("M", "-"),),
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, vocab_size=512, ssm_state=16, ssm_headdim=16,
    ssm_chunk=32, remat=False)
