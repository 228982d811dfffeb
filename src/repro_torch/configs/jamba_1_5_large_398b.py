"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7, MoE (arXiv:2403.19887).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16 experts
top-2.  The Jamba period is 8 layers: attention at position 4 of each
period (1 attn : 7 mamba) and MoE replacing the dense FFN on every second
layer.  72 layers = 9 periods.

The paper's Jamba uses Mamba-1 blocks; this framework's SSM substrate is
Mamba2/SSD (chunked scan + O(1) recurrent decode) — a deliberate,
documented substitution: SSD is the accelerator-friendly
formulation of the same selective-state-space family and gives the
hybrid its bounded-state long_500k decode.
"""

from repro_torch.models.common import ModelConfig

_PERIOD = tuple(
    ("A" if i == 4 else "M", "E" if i % 2 == 1 else "D") for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    layer_pattern=_PERIOD,
    num_experts=16,
    num_experts_per_tok=2,
    ssm_state=128,
    ssm_conv=4,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=8,
    ssm_chunk=256,
)

SMOKE = CONFIG.with_(
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=512, num_experts=4, num_experts_per_tok=2,
    ssm_state=16, ssm_headdim=16, ssm_ngroups=2, ssm_chunk=32, remat=False)
