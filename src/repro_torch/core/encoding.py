"""Bit-plane encodings for binary and ternary tensors (paper §III-A).

Counterpart of ``repro/core/encoding.py``: 32 consecutive depth elements
pack into one 32-bit word, LSB first (element ``k = 32 w + i`` is bit
``i`` of word ``w``).

Storage: torch's ``uint32`` lacks ``~``, ``>>`` and ``<<`` on the CPU,
so planes are ``torch.int32`` tensors holding the reference's uint32
bits (``np.uint32 -> .view(np.int32)`` is free).  ``int32 >>`` is an
arithmetic shift, so every right shift here is masked.

Encodings::

    binary   x in {-1, +1}    ->  1 bit :  +1 -> 0,  -1 -> 1        (eq. 6)
    ternary  x in {-1, 0, +1} ->  2 bits:  +1 -> (1,0), 0 -> (0,0),
                                           -1 -> (0,1)              (Table I)

Pad positions past the depth encode bit 0 (value +1) on both binary
operands and (0,0) (value 0) on ternary ones, so every popcount formula
stays exact with the true depth ``k``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

WORD_BITS = 32

__all__ = [
    "WORD_BITS",
    "packed_width",
    "pack_bits",
    "unpack_bits",
    "pack_binary",
    "unpack_binary",
    "pack_ternary",
    "unpack_ternary",
    "random_binary",
    "random_ternary",
]

# Bit i's weight as an int32: 2**i, with 2**31 wrapping to -2**31.  The
# weighted sum of distinct powers never overflows int32 (the positive
# part stays below 2**31), so it is the packed word exactly.
_BIT_WEIGHTS = np.array([1 << i for i in range(WORD_BITS)],
                        np.uint32).view(np.int32)


@functools.lru_cache(maxsize=16)
def _bit_weights(device: torch.device) -> torch.Tensor:
    """``_BIT_WEIGHTS`` on ``device``, copied there once (a host-to-device
    copy of pageable memory syncs the stream)."""
    return torch.from_numpy(_BIT_WEIGHTS).to(device)


def packed_width(k: int) -> int:
    """Number of 32-bit words for depth ``k``."""
    return -(-k // WORD_BITS)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack a {0,1} integer/bool tensor along its last axis, LSB first.

    ``bits`` of shape (..., k) -> int32 of shape (..., packed_width(k)).
    """
    k = bits.shape[-1]
    kw = packed_width(k)
    b = bits.to(torch.int32)
    if kw * WORD_BITS != k:
        b = F.pad(b, (0, kw * WORD_BITS - k))
    b = b.reshape(*b.shape[:-1], kw, WORD_BITS)
    return (b * _bit_weights(b.device)).sum(dim=-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns int32 {0,1} of shape (..., k)."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words.to(torch.int32)[..., None] >> shifts) & 1
    bits = bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS)
    return bits[..., :k].contiguous()


# ---------------------------------------------------------------------------
# Binary: {-1, +1}
# ---------------------------------------------------------------------------

def pack_binary(x: torch.Tensor) -> torch.Tensor:
    """Encode x in {-1,+1} (sign decides, 0 counts as +1) into int32 bit
    planes along the last axis.  +1 -> 0, -1 -> 1."""
    return pack_bits(x < 0)


def unpack_binary(words: torch.Tensor, k: int,
                  dtype=torch.float32) -> torch.Tensor:
    return (1 - 2 * unpack_bits(words, k)).to(dtype)


# ---------------------------------------------------------------------------
# Ternary: {-1, 0, +1}
# ---------------------------------------------------------------------------

def pack_ternary(x: torch.Tensor):
    """Encode x in {-1,0,+1} into (plus, minus) int32 planes; values are
    classified by sign, |x| is ignored."""
    return pack_bits(x > 0), pack_bits(x < 0)


def unpack_ternary(plus: torch.Tensor, minus: torch.Tensor, k: int,
                   dtype=torch.float32) -> torch.Tensor:
    return (unpack_bits(plus, k) - unpack_bits(minus, k)).to(dtype)


# ---------------------------------------------------------------------------
# Test helpers (the reference's; a torch.Generator in place of a PRNG key)
# ---------------------------------------------------------------------------

def random_binary(generator: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """Uniform random {-1,+1} tensor on ``generator``'s device."""
    bits = torch.rand(shape, generator=generator, device=generator.device) < 0.5
    return (1 - 2 * bits.to(torch.int32)).to(dtype)


def random_ternary(generator: torch.Generator, shape, p_zero: float = 1 / 3,
                   dtype=torch.float32) -> torch.Tensor:
    """Random {-1,0,+1} tensor on ``generator``'s device: zero with
    probability ``p_zero``, else a uniform sign."""
    dev = generator.device
    nz = torch.rand(shape, generator=generator, device=dev) < 1.0 - p_zero
    neg = torch.rand(shape, generator=generator, device=dev) < 0.5
    return (nz.to(torch.int32) * (1 - 2 * neg.to(torch.int32))).to(dtype)
