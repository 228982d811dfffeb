"""Sequence-chunked softmax cross-entropy.

Counterpart of ``repro/train/loss.py``: the head product and the
log-sum-exp run over sequence chunks (a Python loop in place of
``lax.scan``), so the float32 logits of one chunk, (B, chunk, Vp), are
what the loss holds at a time.  The head product has bf16 operands with
float32 products and sums (``matmul_f32``, as ``logits_from_hidden``);
the max under ``detach()`` (``stop_gradient``); the correct-class logit
by ``torch.gather``.  Padded vocab columns (``ShardLayout.pad_vocab``)
are masked to -1e30 before the lse.  Optional z-loss (PaLM) regularizes
the partition function.

The mean is over the global batch's tokens: on the training mesh
(``sharding.split_batch``) the mask's sum is summed over the batch axes,
so each rank returns its rows' share of the global loss (z-loss too) and
the shares add up to it, however unevenly the rows or masks fall.

On a tensor-parallel split of the vocab the head is column-parallel
(vocab-parallel cross-entropy): ``hidden``, this rank's sequence shard
under sequence parallelism, is gathered whole, each rank holds the
logits of its vocab slice, and the row max (under ``detach``), the sum
of exponentials and the target logit are reduced over the
tensor-parallel axis (``sharding.max_over_tp`` / ``sum_over_tp``: every
rank of it then computes the same loss, counted once per batch row).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.conv import matmul_f32
from repro_torch.models.common import ModelConfig, ShardLayout, softcap
from repro_torch.parallel import sharding

__all__ = ["xent_loss"]


def _head_weight(params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].t()
    return params["lm_head"]["w"]


def xent_loss(params, hidden: torch.Tensor, batch: Dict[str, torch.Tensor],
              cfg: ModelConfig, layout: ShardLayout, *,
              seq_chunk: int = 1024, z_loss: float = 0.0,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """hidden (B, S, D) post-final-norm -> (mean token nll, metrics)."""
    w = _head_weight(params, cfg).to(torch.bfloat16)        # (D, Vp) or its vocab slice
    split = sharding.tp_split("vocab")
    hidden = hidden.to(torch.bfloat16)
    if split is not None:
        # float32 holding the bf16 operand's values: the ranks' partial
        # cotangents sum in float32 and round to bf16 once (sharding.tp_enter)
        hidden = sharding.tp_enter(hidden)
    vp = w.shape[1]
    v0 = split.tp_index * vp if split is not None else 0
    b, s, d = hidden.shape
    labels, mask = batch["labels"], batch["mask"]

    chunk = min(seq_chunk, s)
    if s % chunk:
        chunk = s
    valid = v0 + torch.arange(vp, device=hidden.device) < cfg.vocab_size

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    zsum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        h = hidden[:, c0:c0 + chunk]
        y = labels[:, c0:c0 + chunk].long()
        m = mask[:, c0:c0 + chunk]
        logits = matmul_f32(h.reshape(-1, d), w).reshape(b, -1, vp)
        logits = softcap(logits, cfg.final_logit_softcap)
        logits = torch.where(valid, logits, -1e30)
        logits = sharding.constrain(logits, ("batch", None, "vocab"))
        mx = torch.amax(logits, dim=-1, keepdim=True).detach()
        if split is None:
            lse = mx[..., 0] + torch.log(torch.sum(torch.exp(logits - mx), dim=-1))
            correct = torch.gather(logits, -1, y[..., None])[..., 0]
        else:
            mx = sharding.max_over_tp(mx)
            yl = y - v0
            mine = (yl >= 0) & (yl < vp)
            own = torch.gather(logits, -1, yl.clamp(0, vp - 1)[..., None])[..., 0]
            sums = sharding.sum_over_tp(torch.stack(
                [torch.sum(torch.exp(logits - mx), dim=-1), torch.where(mine, own, 0.0)]))
            lse = mx[..., 0] + torch.log(sums[0])
            correct = sums[1]
        nll = (lse - correct) * m
        total = total + torch.sum(nll)
        zsum = zsum + torch.sum(torch.square(lse) * m)

    # the global batch's token count: on a split batch each rank's share of
    # the mean is its own sum over the global count
    denom = torch.clamp(sharding.sum_over_batch(torch.sum(mask)), min=1.0)
    loss = total / denom
    if z_loss:
        loss = loss + z_loss * zsum / denom
    return loss, {"nll": total / denom, "tokens": denom}
