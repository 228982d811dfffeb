"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention
(arXiv:2401.04088).

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2.
Every layer is SWA ("AL", window 4096) + MoE FFN, which bounds the KV
cache and makes long_500k decode O(window) — this arch runs all four
shapes.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    layer_pattern=(("AL", "E"),),
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=512, num_experts=4, num_experts_per_tok=2,
    sliding_window=64, remat=False)
