"""chameleon-34b [vlm] — early-fusion token LM (arXiv:2405.09818).

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536.  Image content
arrives as VQ-VAE token ids inside the same vocabulary (early fusion), so
``input_kind`` stays "tokens" — the VQ tokenizer frontend is a stub.
Chameleon's QK-norm is on (it is what makes the arch trainable at this
width).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    layer_pattern=(("A", "D"),),
    qk_norm=True,
    rope_theta=10000.0,
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=160,
    vocab_size=512, remat=False)
