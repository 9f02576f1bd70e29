"""Batched canonical-Huffman build for the lockstep decoder.

Counterpart of ``defl_tpu/ops/tables.py``: every lane builds in lockstep
the sorted-symbol form the tableless decode consumes,

    count[N,16], first_code[N,16], offset[N,16], sorted_syms[N,M]

A stable argsort over (length, symbol) keys gives the canonical symbol
order; a 15-step pass gives first codes and the Kraft oversubscription
flag.  Incomplete trees build fine (decode errors only if an unassigned
code is hit).
"""

from __future__ import annotations

import torch

from defl_tpu_torch.constants import MAX_CODE_LENGTH

# syms-bank layout: one bank serves all three alphabets, three 10-bit
# symbols per u32 word (bases and widths are multiples of 3)
CL_BASE = 0          # code-length alphabet: 19 symbols (pad 24)
LIT_BASE = 24        # literal/length: up to 288
DIST_BASE_ = 312     # distance: up to 32 (pad 36)
SYMS_BANK = 348
SYMS_WORDS = SYMS_BANK // 3


def pack_syms(sorted_syms: torch.Tensor, width: int) -> torch.Tensor:
    """[N, M] symbols -> int64 [N, width//3] u32 words, 3 x 10-bit each."""
    N, M = sorted_syms.shape
    s = sorted_syms.to(torch.int64)
    if M < width:
        s = torch.nn.functional.pad(s, (0, width - M))
    s3 = s.reshape(N, width // 3, 3)
    return s3[:, :, 0] | (s3[:, :, 1] << 10) | (s3[:, :, 2] << 20)


def build_canonical(lengths: torch.Tensor):
    """lengths: int [N, M] per-symbol code lengths (0 = unused).

    Returns (count [N,16], first [N,16], offs [N,16], sorted_syms [N,M],
    oversub [N] bool), int32 like the JAX build.  ``offs`` is local
    (0-based); callers add their bank base.  Entries of sorted_syms past
    the number of used symbols are never read.
    """
    N, M = lengths.shape
    lens = lengths.to(torch.int32)
    ls = torch.arange(MAX_CODE_LENGTH + 1, device=lens.device,
                      dtype=torch.int32)
    count = (lens[:, :, None] == ls).sum(1, dtype=torch.int32)
    count[:, 0] = 0

    # Kraft: left_l = 2*left_{l-1} - count_l; negative => oversubscribed
    left = torch.ones(N, dtype=torch.int32, device=lens.device)
    oversub = torch.zeros(N, dtype=torch.bool, device=lens.device)
    first = torch.zeros_like(count)
    offs = torch.zeros_like(count)
    code = torch.zeros_like(left)
    off = torch.zeros_like(left)
    for l in range(1, MAX_CODE_LENGTH + 1):
        left = (left << 1) - count[:, l]
        oversub |= left < 0
        code = (code + count[:, l - 1]) << 1
        first[:, l] = code
        offs[:, l] = off
        off = off + count[:, l]

    # canonical order: by (length, symbol), zero-length symbols last
    sym_ids = torch.arange(M, device=lens.device, dtype=torch.int32)
    key = torch.where(lens == 0, 1 << 24, lens * 512 + sym_ids)
    sorted_syms = torch.argsort(key, dim=1, stable=True).to(torch.int32)
    return count, first, offs, sorted_syms, oversub
