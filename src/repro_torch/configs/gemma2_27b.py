"""gemma2-27b [dense] — alternating local/global attention + logit
softcaps + sandwich norms (arXiv:2408.00118).

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.  head_dim is
128 (32 x 128 = 4096 != d_model; wo maps 4096 -> 4608).  Pattern period
2: local (SWA 4096) then global.  Global layers see the full context, so
long_500k is skipped.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    layer_pattern=(("AL", "D"), ("A", "D")),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    post_block_norm=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=192,
    vocab_size=512, head_dim=16, sliding_window=64, remat=False)
