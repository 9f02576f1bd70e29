"""Batched adler32 on the device.

Counterpart of ``defl_tpu/ops/checksums.py``: the device inflate path
verifies zlib trailers (FLAG_VERIFY_ADLER32) without shipping outputs to
the host.  ``adler32_batch`` sends CUDA tensors to the hand-written
kernel (``ops/cuda/checksums_cu.py``) and CPU tensors to the plain
PyTorch version below, chosen by where ``data`` lies and by nothing else:
a failed build or launch raises.

A u32 checksum is returned the way the port carries u32 (``ops/bitio``):
an int64 tensor holding the value.
"""

from __future__ import annotations

import torch

from defl_tpu_torch.ops.bitio import i32_to_u32

ADLER_MOD = 65521
#: slab of the plain version (bounds its temporaries; in int64 the sums
#: 255 * SLAB * (SLAB + 1) / 2 plus the carried terms are far from overflow)
_SLAB = 4096


def adler32_batch_ref(data: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: data uint8 [N, C]; lengths int [N] valid
    bytes per lane (clipped to [0, C]).  Returns int64 [N] u32 values.

    The slab recurrence of the JAX function, in int64: per slab of m valid
    bytes,  B += m*A + sum((m - j) * d_j),  A += sum(d),  both mod 65521.
    """
    N, C = data.shape
    lengths = lengths.to(torch.int64).clamp(0, C)
    a = torch.ones(N, dtype=torch.int64, device=data.device)
    b = torch.zeros(N, dtype=torch.int64, device=data.device)
    for s0 in range(0, C, _SLAB):
        seg = data[:, s0:s0 + _SLAB].to(torch.int64)
        j = torch.arange(seg.shape[1], device=data.device)[None, :]
        m = (lengths - s0).clamp(0, seg.shape[1])
        w = (m[:, None] - j).clamp(min=0)   # 0 past the lane's end
        b = (b + a * m + (seg * w).sum(1)) % ADLER_MOD
        a = (a + (seg * (w > 0)).sum(1)) % ADLER_MOD
    return (b << 16) | a


def adler32_batch(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """data: uint8 [N, C]; lengths: int [N] valid bytes per lane.  Returns
    int64 [N] holding the u32 adler32 of each lane's first ``lengths[n]``
    bytes (1 for an empty lane).  CUDA tensors launch the kernel (or
    raise); CPU tensors run the plain version."""
    if data.device.type == "cpu":
        return adler32_batch_ref(data, lengths)
    from defl_tpu_torch.ops.cuda.checksums_cu import adler32_batch_cuda

    return i32_to_u32(adler32_batch_cuda(
        data, lengths.to(device=data.device, dtype=torch.int32)))
