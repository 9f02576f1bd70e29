"""Huffman bit-pack on the device: the card's half of the hybrid encoder.

Counterpart of ``defl_tpu/ops/huffman_pack.py``.  The encode splits the
way the decode does:

  host (csrc/defl_host.cc, ``dt_deflate_fields_batch``)
      LZ77 hash-chain matching, per-block Huffman trees and block layout,
      emitted as a lane-major array of FIELDS, each ``nbits << 16 | value``
      (nbits <= 16, value already bit-reversed for LSB-first emission
      where it is a canonical code).

  device (this module)
      lane-parallel concatenation of those fields: a prefix sum of
      ``nbits`` gives every field its start bit; each field adds its low
      part to word ``start >> 5`` and its carry-out to the next word;
      fields occupy disjoint bits, so ``scatter_add_`` assembles the words
      exactly (sum == OR).

Byte-identity with the serial C++ encoder is by construction: both
consume the same put() sequence, so tests hold the whole compressed byte
string equal, not just the round trip.

The JAX module has two packs.  ``pack_fields`` is the prefix sum and the
two scatter-adds.  ``pack_fields_scan`` there is a ``lax.scan`` over the
F fields through a two-word reservoir; F eager steps are no way to run
that here, and need not be: a field has at most 16 bits, so a lane
flushes at most once a step, and the scan's outputs are a closed form of
the same prefix sum.  Step t flushes iff ``ends[t] >> 5 > starts[t] >>
5``; its slot then holds word ``starts[t] >> 5`` of the packed row, else
0; and ``final_lo`` is word ``total_bits >> 5``.  So the scan on the
device is ``pack_fields`` plus a gather.  The reservoir loop itself stands
beside it as ``pack_fields_scan_ref``, field by field as the JAX module
writes it: the tests and the smoke run hold the closed form against it.

Values are u32 bit patterns: int64 tensors masked to 32 bits on the CPU
(see ``ops/bitio.py``), int32 tensors on a CUDA device, where additions
and shifts wrap to the same 32 bits.  ``to_u32`` turns either into a
numpy uint32 array.  Lanes go through in slabs so that the ``[lanes, F]``
intermediates (among them the int64 indices ``scatter_add_`` wants) stay
bounded.
"""

from __future__ import annotations

import numpy as np
import torch

from defl_tpu_torch.ops.bitio import MASK32, u32_to_i32

#: elements of one slab's [lanes, F] intermediates
SLAB_ELEMS = 1 << 24


def _work_dtype(device) -> torch.dtype:
    return torch.int64 if torch.device(device).type == "cpu" else torch.int32


def _as_fields(fields, n_fields):
    """(fields, n_fields) as tensors of the work dtype on fields' device;
    a numpy uint32 array is taken by its bits."""
    if isinstance(fields, np.ndarray):
        fields = torch.from_numpy(
            np.ascontiguousarray(fields, np.uint32).view(np.int32))
    dt = _work_dtype(fields.device)
    fields = fields.to(dt)
    if dt == torch.int64:
        fields = fields & MASK32
    n_fields = torch.as_tensor(n_fields, device=fields.device).to(dt)
    return fields, n_fields


def to_u32(t: torch.Tensor) -> np.ndarray:
    """A tensor of u32 bit patterns (either convention) -> numpy uint32
    on the host."""
    t = t.cpu()
    if t.dtype == torch.int32:
        return t.numpy().view(np.uint32)
    return (t & MASK32).numpy().astype(np.uint32)


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x & MASK32 if x.dtype == torch.int64 else x


def _spans(fields, n_fields):
    """Per field: its bit count (0 past the lane's live prefix), value,
    start bit and end bit."""
    F = fields.shape[1]
    live = torch.arange(F, device=fields.device)[None, :] < n_fields[:, None]
    nb = torch.where(live, (fields >> 16) & 0xFFFF, 0)
    val = torch.where(live, fields & 0xFFFF, 0)
    ends = torch.cumsum(nb, 1, dtype=fields.dtype)
    return nb, val, ends - nb, ends


def _pack_slab(val, starts, n_words: int):
    """Packed words [lanes, n_words] of one slab; what lies past n_words
    is dropped."""
    s = starts & 31
    lo = _u32(val << s)
    # value bits above the word boundary; (v >> 1) >> (31 - s) is
    # v >> (32 - s) without the shift by 32 at s == 0
    hi = (val >> 1) >> (31 - s)
    w = (starts >> 5).to(torch.int64)
    out = torch.zeros((val.shape[0], n_words + 1), dtype=val.dtype,
                      device=val.device)
    # column n_words takes what JAX's mode="drop" drops
    out.scatter_add_(1, w.clamp(max=n_words), lo)
    out.scatter_add_(1, (w + 1).clamp_(max=n_words), hi)
    return _u32(out[:, :n_words])


def _slabs(N: int, F: int):
    lanes = max(1, SLAB_ELEMS // max(F, 1))
    return [(a, min(a + lanes, N)) for a in range(0, N, lanes)]


def pack_fields(fields, n_fields, n_words: int):
    """Concatenate per-lane bit fields into packed little-endian words.

    fields: [N, F] u32 patterns, each ``nbits << 16 | value`` (nbits <=
    16, value < 2**nbits, already LSB-first).  n_fields: [N] live prefix
    per lane.  n_words: output width (words per lane).

    Returns (words [N, n_words] u32 patterns, total_bits [N]).
    """
    fields, n_fields = _as_fields(fields, n_fields)
    N, F = fields.shape
    words = torch.empty((N, n_words), dtype=fields.dtype,
                        device=fields.device)
    total = torch.empty(N, dtype=fields.dtype, device=fields.device)
    for a, b in _slabs(N, F):
        _, val, starts, ends = _spans(fields[a:b], n_fields[a:b])
        words[a:b] = _pack_slab(val, starts, n_words)
        total[a:b] = ends[:, -1] if F else 0
    return words, total


def pack_fields_scan(fields, n_fields):
    """The lockstep reservoir pack's outputs, in closed form.

    One slot a field and lane: the 32-bit word the reservoir emits at that
    step, 0 where it emits none.  The emission schedule is a pure function
    of the nbits sequence, so the host compactor (``dt_encode_compact``)
    finds the words without a flags plane.

    fields: [N, F] u32 patterns; n_fields: [N].
    Returns (slots [N, F] u32 patterns, final_lo [N], total_bits [N]).
    """
    fields, n_fields = _as_fields(fields, n_fields)
    N, F = fields.shape
    dev, dt = fields.device, fields.dtype
    slots = torch.empty((N, F), dtype=dt, device=dev)
    final_lo = torch.empty(N, dtype=dt, device=dev)
    total = torch.empty(N, dtype=dt, device=dev)
    # a field has at most 16 bits: F fields fill at most F / 2 words, and
    # one more holds what is left at the end
    n_words = F // 2 + 2
    for a, b in _slabs(N, F):
        nb, val, starts, ends = _spans(fields[a:b], n_fields[a:b])
        # the reservoir masks a value to its bit count
        words = _pack_slab(val & ((1 << nb) - 1), starts, n_words)
        w0 = (starts >> 5).to(torch.int64)
        flush = (ends >> 5) > (starts >> 5)
        slots[a:b] = torch.where(flush, words.gather(1, w0), 0)
        tb = ends[:, -1] if F else torch.zeros(b - a, dtype=dt, device=dev)
        last = (tb >> 5).to(torch.int64)[:, None]
        final_lo[a:b] = words.gather(1, last)[:, 0]
        total[a:b] = tb
    return slots, final_lo, total


def pack_fields_scan_ref(fields, n_fields):
    """The plain version of ``pack_fields_scan``: the reservoir loop, one
    field a step for all lanes, exactly as the JAX module's scan body
    writes it.  F eager steps: for tests and the smoke run only."""
    fields, n_fields = _as_fields(fields, n_fields)
    fields = fields.to(torch.int64) & MASK32
    n_fields = n_fields.to(torch.int64)
    N, F = fields.shape
    dev = fields.device
    lo = torch.zeros(N, dtype=torch.int64, device=dev)
    hi = torch.zeros_like(lo)
    nres = torch.zeros_like(lo)
    total = torch.zeros_like(lo)
    slots = torch.zeros((N, F), dtype=torch.int64, device=dev)
    for t in range(F):
        f = fields[:, t]
        nb = torch.where(t < n_fields, f >> 16, 0)
        v = (f & 0xFFFF) & ((1 << nb) - 1)
        lo = lo | ((v << nres) & MASK32)
        hi = hi | ((v >> 1) >> (31 - nres))
        n2 = nres + nb
        flush = n2 >= 32
        slots[:, t] = torch.where(flush, lo, 0)
        lo = torch.where(flush, hi, lo)
        hi = torch.where(flush, 0, hi)
        nres = torch.where(flush, n2 - 32, n2)
        total = total + nb
    dt = _work_dtype(dev)
    if dt == torch.int32:
        return u32_to_i32(slots), u32_to_i32(lo), total.to(dt)
    return slots, lo, total
