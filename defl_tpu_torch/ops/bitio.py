"""Bitstream primitives for the port's plain PyTorch paths.

Counterpart of ``defl_tpu/ops/bitio.py``.  torch on the CPU has no
shifts, compares or gathers on ``torch.uint32``, so a u32 bit pattern
lives here in an int64 tensor masked to 32 bits.  The CUDA kernel takes
the same patterns as int32 tensors; ``u32_to_i32`` and ``i32_to_u32``
convert at that boundary.

Streams are packed as in the JAX package (``defl_tpu/runtime/pack.py``):
stream bit *i* (LSB-first, RFC 1951 §3.1.1) is bit ``i & 31`` of word
``i >> 5``.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 holding the u32 value."""
    return x.to(torch.int64) & MASK32


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a u32 value -> int32 with the same 32 bits."""
    return (((x & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def bitrev16(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse the low 16 bits of each element (5 masked shifts)."""
    x = ((x & 0x5555) << 1) | ((x >> 1) & 0x5555)
    x = ((x & 0x3333) << 2) | ((x >> 2) & 0x3333)
    x = ((x & 0x0F0F) << 4) | ((x >> 4) & 0x0F0F)
    return ((x & 0x00FF) << 8) | ((x >> 8) & 0x00FF)


def peek32(words: torch.Tensor, bitpos: torch.Tensor) -> torch.Tensor:
    """32-bit LSB-first window at a per-lane bit offset.

    words: int64 [N, W] u32 values, or [1, W] for one row that every
    lane reads; bitpos: int [N].  Word indices clamp to the row, as
    ``defl_tpu.ops.bitio.peek32`` clips them.  Returns int64 [N].
    """
    last = words.shape[1] - 1
    widx = (bitpos.to(torch.int64) >> 5).clamp(0, last)
    idx = torch.stack([widx, (widx + 1).clamp(max=last)], 1)
    if words.shape[0] == 1 and bitpos.shape[0] != 1:
        pair = words[0][idx]
    else:
        pair = words.gather(1, idx)
    # a 64-bit pair shifted right by < 32: the low 32 bits of the result
    # are the window; the sign fill of the arithmetic shift never reaches them
    return ((pair[:, 0] | (pair[:, 1] << 32)) >> (bitpos & 31)) & MASK32


def mask_bits(n: torch.Tensor) -> torch.Tensor:
    """(1 << n) - 1, for n in [0, 31]."""
    return (1 << n) - 1


def extract(peek: torch.Tensor, offset, n) -> torch.Tensor:
    """n bits of ``peek`` starting at bit ``offset`` (per lane)."""
    return (peek >> offset) & mask_bits(n)
