"""Model configuration schema + shared layers (norms, RoPE, softcap).

Counterpart of ``repro/models/common.py``.  One :class:`ModelConfig`
describes every architecture through a per-period ``layer_pattern``:
each entry is ``(mixer, ffn)`` with mixer in {"A": attention, "AL":
local/sliding-window attention, "M": Mamba2/SSD} and ffn in {"D": dense
FFN, "E": MoE FFN, "-": none}.  The network is the pattern repeated
``num_layers / period`` times; parameters and caches are stacked over
the repeats, and the port's model walks them in a Python loop.

Float products of the models run through :func:`einsum_f32` (and
``core.conv.matmul_f32``): float32 operands, TF32 off, as the
reference's ``preferred_element_type=float32`` products of float32 or
bf16 values (bf16 products are exact in float32).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.policy import POLICIES, QuantPolicy
from repro_torch.core.quantize import f32_scalar

__all__ = ["ModelConfig", "ShardLayout", "rms_norm", "layer_norm",
           "apply_rope", "rope_freqs", "softcap", "ceil_to",
           "KVCacheFormat", "kv_cache_format", "KV_CACHE_FORMATS", "einsum_f32"]

def ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def einsum_f32(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` on float32 copies of ``operands`` with TF32 off:
    full float32 products and sums on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.einsum(eq, *(o.to(torch.float32) for o in operands))


@dataclasses.dataclass(frozen=True)
class KVCacheFormat:
    """Resolved ``ModelConfig.kv_cache_dtype`` value: ``storage_dtype`` is
    the element dtype of a dense cache (None for packed formats);
    ``paged`` selects the page-table cache (models/paged_kvcache.py)."""
    name: str
    storage_dtype: Any            # torch dtype or None (packed payload)
    paged: bool


KV_CACHE_FORMATS = {
    "bf16": KVCacheFormat("bf16", torch.bfloat16, paged=False),
    "int8": KVCacheFormat("int8", torch.int8, paged=False),
    # the paper's 2-bit ternary planes applied to the KV cache (paged)
    "tnn2": KVCacheFormat("tnn2", None, paged=True),
    # the same page tables with dense bf16 pages (the oracle)
    "tnn2-oracle": KVCacheFormat("tnn2-oracle", torch.bfloat16, paged=True),
}


def kv_cache_format(name: str) -> KVCacheFormat:
    """The one resolution point for ``kv_cache_dtype`` strings; an unknown
    name raises."""
    try:
        return KV_CACHE_FORMATS[name]
    except KeyError:
        raise ValueError(
            f"unknown kv_cache_dtype {name!r}; expected one of "
            f"{sorted(KV_CACHE_FORMATS)}") from None


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Layout decisions that depend on the mesh, not the arch: ``tp`` is
    the model-axis size used for head/ffn sharding (1 on one card).  Head
    counts that do not divide tp are padded with zero heads
    (output-exact)."""
    tp: int = 1

    def pad_heads(self, h: int) -> int:
        return ceil_to(h, self.tp)

    def pad_vocab(self, v: int) -> int:
        return ceil_to(v, 128 * math.gcd(self.tp, 128))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- layer pattern (one period) ---
    layer_pattern: Tuple[Tuple[str, str], ...] = (("A", "D"),)
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    shared_expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    # --- attention ---
    sliding_window: int = 0          # used by "AL" mixers
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    qk_norm: bool = False            # chameleon
    post_block_norm: bool = False    # gemma2 sandwich norms
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm (starcoder2)
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 128
    # --- frontend ---
    input_kind: str = "tokens"       # tokens | embeddings
    # --- numerics / quantization ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    quant_policy: str = "bf16"
    # Run every projection class on this backend instead of the policy's
    # (e.g. "torch": the plain versions, to hold a run against its
    # kernels); None keeps the policy's backends.
    quant_backend: Optional[str] = None
    kv_cache_dtype: str = "bf16"     # KV_CACHE_FORMATS
    dtype: Any = torch.bfloat16
    # --- training (kept for the reference's configs; the serving path of
    # the port does not checkpoint) ---
    remat: bool = True
    remat_block: bool = True

    # ---------------- derived -----------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_periods(self) -> int:
        assert self.num_layers % self.period == 0, (
            f"{self.name}: num_layers={self.num_layers} not a multiple of "
            f"pattern period {self.period}")
        return self.num_layers // self.period

    @property
    def policy(self) -> QuantPolicy:
        p = POLICIES[self.quant_policy]
        return p if self.quant_backend is None else p.with_backend(self.quant_backend)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_d_inner // self.ssm_headdim

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Shared layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / f32_scalar(head_dim, i)))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, dh); positions (..., S) integers."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                   # (dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, dh/2)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
