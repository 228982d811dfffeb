"""tinyllama-1.1b [dense] — llama2-architecture small LM (arXiv:2401.02385).

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.  Also the default
arch for the end-to-end training example (examples/train_tinylm.py uses a
`~100M` cut of this config).
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    layer_pattern=(("A", "D"),),
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=160,
    vocab_size=512, remat=False)

# ~100M-parameter cut for the runnable end-to-end training example.
TRAIN_100M = CONFIG.with_(
    name="tinyllama-100m", num_layers=8, d_model=768, num_heads=12,
    num_kv_heads=4, d_ff=2048, vocab_size=32000)
