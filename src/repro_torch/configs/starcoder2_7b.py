"""starcoder2-7b [dense] — GQA + RoPE code LM (arXiv:2402.19173).

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.  StarCoder2 uses
LayerNorm (not RMSNorm) and a high RoPE base.  Treated as full attention
(long_500k skipped).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    layer_pattern=(("A", "D"),),
    norm_type="layernorm",
    rope_theta=1e5,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=72, num_heads=6, num_kv_heads=2, d_ff=192,
    vocab_size=512, remat=False)
