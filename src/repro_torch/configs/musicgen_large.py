"""musicgen-large [audio] — decoder-only over EnCodec tokens (arXiv:2306.05284).

48L d_model=2048 32H (kv=32 -> plain MHA) d_ff=8192 vocab=2048.  The
EnCodec frontend (audio -> RVQ codebook frames) is a stub:
``input_kind="embeddings"``, and the caller provides precomputed frame
embeddings of shape (B, S, d_model).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    layer_pattern=(("A", "D"),),
    input_kind="embeddings",
    norm_type="layernorm",
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=256, remat=False)
