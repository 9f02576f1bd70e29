"""Canonical Huffman codes: validation and decode tables.

The port's own copy of the decode side of ``defl_tpu/core/huffman.py``.

The decode-side structures here are the *sorted-symbol / first-code* form —
``(count, first_code, offset, sorted_syms)`` — rather than the flat
expanded lookup tables the reference builds (`infl_ft_build`,
the reference's `src/infl/infl.c:452-578`).  On a CPU a big flat table wins
because random loads are cheap; the lockstep decoder is
*tableless*: bit-reverse the peeked window once, then 15 rounds of compare /
select against ``first_code[len]`` (pure vector ALU), with a single small
gather into ``sorted_syms`` at the end.  These structures are exactly what
that kernel consumes (see ``defl_tpu_torch.ops.inflate_batch``), and the host
oracle uses the same form so both sides share one validated table build.

Validation semantics match the reference:
- code length > 15 → error (infl.c:469)
- oversubscribed tree (Kraft sum exceeded) → error (infl.c:485-490)
- incomplete trees are *accepted at build time*; hitting an unassigned code
  during decode is the error (the reference leaves such entries invalid).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from defl_tpu_torch.constants import MAX_CODE_LENGTH


@dataclass
class CanonicalCode:
    """Decode-side canonical code description.

    Attributes
    ----------
    count : (16,) int32   — number of codes of each length (index = length)
    first_code : (16,) int32 — smallest (MSB-first) code of each length
    offset : (16,) int32  — index into ``sorted_syms`` of the first symbol
                            with that code length
    sorted_syms : (n,) int32 — symbols ordered by (code length, symbol)
    max_len : int         — longest assigned code length (0 if no codes)
    """

    count: np.ndarray
    first_code: np.ndarray
    offset: np.ndarray
    sorted_syms: np.ndarray
    max_len: int

    @property
    def num_symbols(self) -> int:
        return int(self.sorted_syms.shape[0])


def build_decode(lengths) -> CanonicalCode | None:
    """Build decode structures from per-symbol code lengths.

    Returns None for invalid inputs: any length > 15, or an oversubscribed
    tree.  Incomplete trees build successfully (decode flags the error only
    if an unassigned code is actually read), matching the reference.
    """
    lens = np.asarray(lengths, dtype=np.int32)
    if lens.size and int(lens.max(initial=0)) > MAX_CODE_LENGTH:
        return None

    count = np.zeros(MAX_CODE_LENGTH + 1, dtype=np.int32)
    for l in range(1, MAX_CODE_LENGTH + 1):
        count[l] = int(np.count_nonzero(lens == l))

    # Kraft check: `left` is the number of codes still available at each
    # length; going negative means the tree is oversubscribed.
    left = 1
    for l in range(1, MAX_CODE_LENGTH + 1):
        left = (left << 1) - int(count[l])
        if left < 0:
            return None

    first_code = np.zeros(MAX_CODE_LENGTH + 1, dtype=np.int32)
    offset = np.zeros(MAX_CODE_LENGTH + 1, dtype=np.int32)
    code = 0
    off = 0
    max_len = 0
    for l in range(1, MAX_CODE_LENGTH + 1):
        code = (code + int(count[l - 1])) << 1
        first_code[l] = code
        offset[l] = off
        off += int(count[l])
        if count[l]:
            max_len = l

    # Symbols sorted by (length, symbol): for each length, symbols in
    # ascending order — the canonical assignment of RFC 1951 §3.2.2.
    order = np.argsort(lens * 512 + np.arange(lens.size, dtype=np.int32),
                       kind="stable")
    nonzero = order[lens[order] > 0]
    sorted_syms = nonzero.astype(np.int32)

    return CanonicalCode(count, first_code, offset, sorted_syms, max_len)
