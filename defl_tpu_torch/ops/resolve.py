"""Token stream -> output bytes on the device (pass 2 of the device inflate).

Counterpart of ``defl_tpu/ops/resolve.py``, which is XLA code there and
plain tensor code here.  The resolution is data-parallel over every
output byte of every stream:

  1. token lengths -> output positions by exclusive cumsum,
  2. a scatter-max + cummax pass labels every output byte with its
     covering token,
  3. literals and stored runs resolve at once (stored bytes gather
     straight from the packed input),
  4. match bytes get a source pointer ``src[i] = i - dist`` — overlapping
     matches (dist < len) included — and a pointer-doubling loop
     (``val[i] <- val[src[i]]; src[i] <- src[src[i]]``) resolves every
     chain in ceil(log2(longest chain)) gather rounds.

A shared preset dictionary, or a per-lane ``prefix`` of prior output,
occupies a resolved region before position 0; matches may point into it.

Differences from the JAX function:
- ``torch.gather`` wants int64 indices and the function holds about ten
  ``[lanes, D + C]`` arrays, so lanes (which are independent) resolve in
  slabs of at most ``SLAB_ELEMS`` elements per array, and peak memory
  does not grow with the batch.
- The doubling loop asks the host once per round whether a pointer is
  left (one sync per round and slab).
"""

from __future__ import annotations

import numpy as np
import torch

from defl_tpu_torch.ops.bitio import i32_to_u32
from defl_tpu_torch.ops.inflate_batch import (TOK_LIT, TOK_LIT_PAIR_BIT,
                                              TOK_MATCH, TOK_STORED)

#: elements of one ``[lanes, D + C + 1]`` array per slab: 2**25 int64
#: elements are 268 MB, and about ten such arrays live at once
SLAB_ELEMS = 1 << 25


def _bytes_of(words, device) -> torch.Tensor:
    """Packed u32 words [..., W] (a uint32 ndarray as the packers make it,
    or an int32 tensor of the same bits) -> uint8 [..., 4W] on ``device``,
    in stream order (words are little-endian)."""
    if isinstance(words, np.ndarray):
        words = torch.tensor(np.ascontiguousarray(words).view(np.int32))
    if words.dtype != torch.int32:
        raise TypeError(f"packed words must be int32 bit patterns, got "
                        f"{words.dtype}")
    return words.to(device).contiguous().view(torch.uint8)


def _resolve_slab(toks, in_bytes, dst_len, C, D, head):
    """One slab of lanes.  toks: int64 [n, T] u32 token values; in_bytes:
    uint8 [n, 4W] packed input; dst_len: int64 [n]; head: None, uint8 [D]
    (shared dictionary) or uint8 [n, D] (per-lane prefix).  Returns uint8
    [n, C]."""
    n, T = toks.shape
    dev = toks.device
    CW = D + C

    kind = toks >> 30
    tlen = torch.where(
        kind == TOK_LIT, 1 + ((toks & TOK_LIT_PAIR_BIT) != 0).long(),
        torch.where(kind == TOK_MATCH, ((toks >> 21) & 0x1FF) + 3,
                    torch.where(kind == TOK_STORED,
                                ((toks >> 22) & 0xFF) + 1, 0)))
    pos = tlen.cumsum(1) - tlen  # exclusive prefix sum

    # label every output byte with its covering token; tokens that
    # produce nothing, or start past the row, land in the dump slot CW
    col = torch.where((tlen > 0) & (D + pos < CW), D + pos, CW)
    order = torch.arange(1, T + 1, dtype=torch.int32, device=dev)
    arr = torch.zeros((n, CW + 1), dtype=torch.int32, device=dev)
    arr.scatter_reduce_(1, col, order.expand(n, T), "amax")
    cover = arr.cummax(1).values[:, :CW] - 1  # -1 = no token
    del arr, col

    cov = cover.clamp(min=0).long()
    tok_at = toks.gather(1, cov)
    rel = torch.arange(CW, device=dev)[None, :] - (pos.gather(1, cov) + D)
    del cov
    kind_at = tok_at >> 30
    i = torch.arange(CW, device=dev)[None, :]
    in_out = (i >= D) & (i < D + dst_len[:, None]) & (cover >= 0)
    del cover

    # literals (pair tokens carry their second byte in bits [15:8])
    lit = torch.where(rel == 0, tok_at & 0xFF, (tok_at >> 8) & 0xFF)
    val = torch.where(in_out & (kind_at == TOK_LIT), lit, 0).to(torch.uint8)
    del lit

    # stored runs: gather source bytes straight from the packed input
    sb = (tok_at & 0x3FFFFF) + rel
    last_word = in_bytes.shape[1] // 4 - 1
    sidx = ((sb >> 2).clamp(0, last_word) << 2) | (sb & 3)
    val = torch.where(in_out & (kind_at == TOK_STORED),
                      in_bytes.gather(1, sidx), val)
    del sb, sidx, rel

    # prefix region: per-lane prior output or the shared dictionary
    if head is not None:
        val[:, :D] = head

    # matches: source pointer chains
    src = torch.where(in_out & (kind_at == TOK_MATCH),
                      i - ((tok_at & 0x7FFF) + 1), -1)
    del tok_at, kind_at, in_out
    while True:
        live = src >= 0
        if not bool(live.any()):
            break
        g = src.clamp(min=0)
        val, src = (torch.where(live, val.gather(1, g), val),
                    torch.where(live, src.gather(1, g), src))
    return val[:, D:]


def resolve_tokens(tokens, words, dst_len, *, C: int, dict_len: int = 0,
                   dict_words=None, prefix=None) -> torch.Tensor:
    """tokens: int32 [T, N] from decode_tokens (u32 token bits); words:
    the packed input [N, W] (uint32 ndarray or int32 tensor of its bits);
    dst_len: int [N] bytes produced per lane.  Everything runs where
    ``tokens`` lies.

    Returns uint8 [N, C]; bytes past dst_len are zero.

    ``dict_words`` (with ``dict_len``): the shared preset dictionary as
    ``pack_dictionary`` packs it.  ``prefix`` (uint8 [N, P], exclusive
    with dict_len) serves the incremental streaming resolve: each lane's
    prior window bytes, right-aligned, sit before position 0 and
    back-references may reach into them.
    """
    if tokens.dtype != torch.int32:
        raise TypeError(f"tokens must be int32 bit patterns, got "
                        f"{tokens.dtype}")
    dev = tokens.device
    T, N = tokens.shape
    head = None
    if prefix is not None:
        if dict_len:
            raise ValueError("prefix and dict_len are exclusive")
        head = torch.as_tensor(prefix, device=dev).to(torch.uint8)
        D = head.shape[1]
    else:
        D = int(dict_len)
        if D:
            head = _bytes_of(dict_words, dev)[:D]
    dst_len = torch.as_tensor(dst_len, device=dev).to(torch.int64)
    out = torch.empty((N, C), dtype=torch.uint8, device=dev)
    step = max(1, SLAB_ELEMS // (D + C + 1))
    for lo in range(0, N, step):
        hi = min(N, lo + step)
        out[lo:hi] = _resolve_slab(
            i32_to_u32(tokens[:, lo:hi].T).contiguous(),
            _bytes_of(words[lo:hi], dev), dst_len[lo:hi], C, D,
            head[lo:hi] if prefix is not None else head)
    return out
