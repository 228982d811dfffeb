"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts
(hf:Qwen/Qwen1.5-MoE-A2.7B).

24L d_model=2048 16H (kv=16 -> MHA) d_ff=1408 (per expert) vocab=151936.
The 4 always-on shared experts are modelled as one fused shared FFN of
width 4 * 1408 = 5632 (mathematically identical for SwiGLU experts that
are summed).

``CONFIG`` and ``SMOKE`` are the block the JAX package models (top-k
renormalised, capacity 1.25, the shared expert ungated, no q/k/v biases,
rope_theta 1e4), which its parity tests pair them with.  ``PUBLISHED``
is the published block (the model's config.json): q/k/v biases,
rope_theta 1e6, rms_norm_eps 1e-6, the top-4 probabilities not
renormalised (norm_topk_prob false), dropless routing, the shared expert
scaled by sigmoid(x . w_gate), router_aux_loss_coef 0.001.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    layer_pattern=(("A", "E"),),
    num_experts=60,
    num_experts_per_tok=4,
    shared_expert_d_ff=4 * 1408,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=48,
    vocab_size=512, num_experts=8, num_experts_per_tok=4,
    shared_expert_d_ff=96, remat=False)

# what the published block sets apart from CONFIG
PUBLISHED_SWITCHES = dict(
    qkv_bias=True, rope_theta=1e6, norm_eps=1e-6, moe_renormalize=False,
    moe_dropless=True, shared_expert_gate=True, router_aux_loss=0.001)
PUBLISHED = CONFIG.with_(**PUBLISHED_SWITCHES)
