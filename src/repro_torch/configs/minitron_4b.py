"""minitron-4b [dense] — width/depth-pruned Nemotron (arXiv:2407.14679).

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern=(("A", "D"),),
)

SMOKE = CONFIG.with_(
    num_layers=2, d_model=96, num_heads=6, num_kv_heads=2, d_ff=256,
    vocab_size=512, remat=False)
