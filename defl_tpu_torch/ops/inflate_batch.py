"""Lockstep batched DEFLATE decoder: carry, format constants, table builds.

Counterpart of ``defl_tpu/ops/inflate_batch.py``.  N independent streams
advance in lockstep, one per lane; the per-lane state machine, the token
format and the carry keys are the JAX package's, so the two packages'
carries convert into each other (``defl_tpu_torch.convert``).

What the port leaves out, because it exists only to get around TPU costs:
the XLA step (the CUDA kernel and its twin in ``ops/cuda/decode_cu.py``
take its place), the chunk input window ``win``/``win_word``/``rr`` and
its one-hot refills (the kernel reads ``words`` straight from device
memory), and the where-chain multiplexers (indexed loads and gathers).

Dtypes: i32 carry fields are int32 tensors; the u32 fields (``cl_lo``,
``cl_hi``, ``lens_pk``, ``syms``) are int64 tensors masked to 32 bits
(see ``ops/bitio.py``).
"""

from __future__ import annotations

import torch

from defl_tpu_torch import constants as C
from defl_tpu_torch.core import huffman
from defl_tpu_torch.errors import Result
from defl_tpu_torch.ops import tables
from defl_tpu_torch.ops.bitio import extract

# ---- lane states (mirror of defl_tpu/ops/inflate_batch.py) -----------------
S_ZHDR = 0
S_DICTID = 1
S_BHDR = 2
S_STORED_HDR = 3    # byte-align after BTYPE
S_STORED_LEN = 4    # read LEN/NLEN
S_STORED = 5        # emit stored-run tokens
S_CLEN_HDR = 6      # HLIT/HDIST/HCLEN
S_CLEN_LENS = 7     # 3-bit codelen code lengths
S_LENS = 8          # codelen-coded litlen+dist lengths
S_WAIT = 9          # stalled until the between-chunk table build
S_SYM = 10          # symbol decode (litlen + same-step dist / 2nd literal)
S_DONE = 11
S_ERR = 12
S_FULL = 13

STATUS_RUNNING = 127

# ---- token encoding (u32) --------------------------------------------------
# kind in bits [31:30]: 0 NOP | 1 LIT | 2 MATCH | 3 STORED
# LIT:    byte in [7:0]; bit 16 set => second byte rides in [15:8]
# MATCH:  (len-3) in [29:21], (dist-1) in [14:0]
# STORED: (run-1) in [29:22], input byte offset in [21:0]  (=> streams <4MiB)
TOK_NOP = 0
TOK_LIT = 1
TOK_MATCH = 2
TOK_STORED = 3
TOK_LIT_PAIR_BIT = 1 << 16
STORED_MAX_RUN = 256

#: the JAX package's chunk input window (words).  The port has no window;
#: the value survives only so that ``convert.carry_to_numpy`` can hand the
#: JAX decoder a window position that forces its refill.
WIN = 512

#: litlen+dist code lengths, nibble-packed: 320 lengths x 4 bits = 40 u32
LENS_WORDS = 40


def step_budget(dst_capacity: int) -> int:
    """Default decode-step budget for a given output capacity (same
    formula as the JAX package, so both give a batch the same T)."""
    return dst_capacity * 5 // 8 + 4096


# ---- fixed-Huffman tables (NumPy, built by the host tier) ------------------
_fx_lit = huffman.build_decode(C.FIXED_LITLEN_LENGTHS)
_fx_dist = huffman.build_decode(C.FIXED_DIST_LENGTHS)


def _fixed_row(values, width=None):
    t = torch.as_tensor(values, dtype=torch.int64)
    if width is not None:
        t = tables.pack_syms(t[None], width)[0]
    return t


_FX_LIT = (_fixed_row(_fx_lit.count), _fixed_row(_fx_lit.first_code),
           _fixed_row(_fx_lit.offset + tables.LIT_BASE),
           _fixed_row(_fx_lit.sorted_syms, 288))
_FX_DIST = (_fixed_row(_fx_dist.count), _fixed_row(_fx_dist.first_code),
            _fixed_row(_fx_dist.offset + tables.DIST_BASE_),
            _fixed_row(_fx_dist.sorted_syms, 36))


# ---- carry -----------------------------------------------------------------
SCAN_KEYS = ("state", "bitpos", "final", "hlit", "hdist", "hclen", "idx",
             "prev", "dst_pos", "need_build", "resume_state", "cl_lo",
             "cl_hi", "lens_pk", "status")
CHUNK_KEYS = ("count", "first", "offs", "syms", "maxlen")
U32_KEYS = ("cl_lo", "cl_hi", "lens_pk", "syms")


def _init_scan_state(N: int, device) -> dict[str, torch.Tensor]:
    """Small per-lane carry: [N] scalars plus the nibble-packed lens
    (word-major [LENS_WORDS, N], as in the JAX package)."""
    st = {k: torch.zeros(N, dtype=torch.int32, device=device)
          for k in SCAN_KEYS}
    st["cl_lo"] = torch.zeros(N, dtype=torch.int64, device=device)
    st["cl_hi"] = torch.zeros(N, dtype=torch.int64, device=device)
    st["lens_pk"] = torch.zeros((LENS_WORDS, N), dtype=torch.int64,
                                device=device)
    st["status"].fill_(STATUS_RUNNING)
    return st


def _init_chunk_state(N: int, device) -> dict[str, torch.Tensor]:
    """Per-lane Huffman tables, touched only between chunks."""
    z = lambda: torch.zeros((N, 3, 16), dtype=torch.int32, device=device)
    return dict(
        count=z(), first=z(), offs=z(),          # [N,3,16] CL/LIT/DIST
        syms=torch.zeros((N, tables.SYMS_WORDS), dtype=torch.int64,
                         device=device),         # 3 x 10-bit per word
        # longest assigned code length per table: the invalid-vs-need-input
        # decision point (≙ oracle._decode_symbol)
        maxlen=torch.full((N, 3), C.MAX_CODE_LENGTH, dtype=torch.int32,
                          device=device),
    )


def _unpack_lens(lens_pk: torch.Tensor, width: int) -> torch.Tensor:
    """[LENS_WORDS, N] packed nibbles -> int32 [N, width] lengths."""
    p = torch.arange(width, device=lens_pk.device)
    return ((lens_pk[p >> 3].T >> (4 * (p & 7))) & 0xF).to(torch.int32)


def _unpack_cl(cl_lo: torch.Tensor, cl_hi: torch.Tensor) -> torch.Tensor:
    """Two packed u32 lane scalars -> int32 [N, 19] code-length lengths."""
    j = torch.arange(19, device=cl_lo.device)
    src = torch.where(j[None, :] < 10, cl_lo[:, None], cl_hi[:, None])
    return ((src >> (3 * torch.where(j < 10, j, j - 10))) & 7).to(torch.int32)


def _write_lens_run(lens_pk, mask, start, end, val):
    """OR value nibbles into positions [start, end) of the packed lens
    ([LENS_WORDS, N]) for masked lanes."""
    w8 = 8 * torch.arange(LENS_WORDS, device=lens_pk.device)[:, None]
    lo = (start[None, :] - w8).clamp(0, 8)
    hi = (end[None, :] - w8).clamp(0, 8)
    n = hi - lo
    m = torch.where(n >= 8, 0xFFFFFFFF, ((1 << (4 * n)) - 1) << (4 * lo))
    m = torch.where(mask[None, :] & (n > 0), m, 0)
    return lens_pk | ((val * 0x11111111)[None, :] & m)


def _ord_arith(idx: torch.Tensor) -> torch.Tensor:
    """RFC 1951 code-length order as closed-form arithmetic; idx in [0, 19)."""
    j = idx - 4
    paired = torch.where((j & 1) == 1, 8 - ((j + 1) >> 1), 8 + (j >> 1))
    return torch.where(idx < 3, 16 + idx, torch.where(idx == 3, 0, paired))


def _length_from_sym(sym, peek, off):
    """Closed-form RFC 1951 length-code expansion -> (length, extra bits)."""
    eb = ((sym - 261) >> 2).clamp(0, 5)
    base = torch.where(sym <= 264, sym - 254,
                       ((((sym - 261) & 3) + 4) << eb) + 3)
    eb = torch.where(sym >= 285, 0, eb)
    base = torch.where(sym >= 285, 258, base)
    return base + extract(peek, off, eb), eb


def _dist_from_sym(dsym, peek, off):
    """Closed-form distance expansion -> (distance, extra bits)."""
    eb = ((dsym >> 1) - 1).clamp(0, 13)
    base = torch.where(dsym < 4, dsym + 1, ((2 + (dsym & 1)) << eb) + 1)
    eb = torch.where(dsym < 4, 0, eb)
    return base + extract(peek, off, eb), eb


# ---------------------------------------------------------------------------
# between-chunk table builds
# ---------------------------------------------------------------------------

def _chunk_gate(st):
    """The chunk loop's one host sync per chunk (the loop is the plain
    version of the stream kernel, which builds its tables itself).

    Returns (any lane still RUNNING, builds) where builds is None when no
    table build runs before this chunk, else the (CL, LIT/DIST, fixed)
    flags of the builds that have waiting lanes.  Builds are batched: they
    run once N//16 lanes wait (those sit in S_WAIT meanwhile), or when
    every runnable lane is waiting — amortised, and never a deadlock
    (the gate of defl_tpu/ops/inflate_batch.py:637-644).
    """
    nb = st["need_build"]
    running = st["status"] == STATUS_RUNNING
    runnable = running & (st["state"] != S_WAIT)
    any_run, n_wait, any_runnable, b1, b2, b3 = torch.stack([
        running.any(), (nb > 0).sum(), runnable.any(),
        (nb == 1).any(), (nb == 2).any(), (nb == 3).any()]).tolist()
    do_build = n_wait > 0 and (n_wait >= nb.shape[0] // 16
                               or not any_runnable)
    return bool(any_run), ((bool(b1), bool(b2), bool(b3)) if do_build
                           else None)


def _set_table(ck, tbl, mask, count, first, offs, syms_packed, syms_base):
    """Write one table kind for masked lanes.  syms_packed: [N, W/3] or a
    [W/3] constant row; syms_base is the symbol-index base."""
    m = mask[:, None]
    ck = dict(ck)
    for key, val in (("count", count), ("first", first), ("offs", offs)):
        t = ck[key].clone()
        t[:, tbl] = torch.where(m, val.to(t.dtype), t[:, tbl])
        ck[key] = t
    wb = syms_base // 3
    w = syms_packed.shape[-1]
    syms = ck["syms"].clone()
    syms[:, wb:wb + w] = torch.where(m, syms_packed, syms[:, wb:wb + w])
    ck["syms"] = syms
    ls = torch.arange(16, device=mask.device)
    ml = (ls * (count > 0)).amax(-1).to(torch.int32)
    maxlen = ck["maxlen"].clone()
    maxlen[:, tbl] = torch.where(mask, ml, maxlen[:, tbl])
    ck["maxlen"] = maxlen
    return ck


def _build_cl(ck, st):
    mask = st["need_build"] == 1
    cnt, first, offs, syms, oversub = tables.build_canonical(
        _unpack_cl(st["cl_lo"], st["cl_hi"]))
    ck = _set_table(ck, 0, mask, cnt, first, offs + tables.CL_BASE,
                    tables.pack_syms(syms, 24), tables.CL_BASE)
    bad = mask & oversub
    ok = mask & ~oversub
    st = dict(st)
    st["status"] = torch.where(bad, int(Result.ERR), st["status"])
    st["state"] = torch.where(bad, S_ERR,
                              torch.where(ok, S_LENS, st["state"]))
    st["idx"] = torch.where(ok, 0, st["idx"])
    st["prev"] = torch.where(ok, 0, st["prev"])
    st["lens_pk"] = torch.where(mask[None, :], 0, st["lens_pk"])
    return ck, st


def _build_litdist(ck, st):
    mask = st["need_build"] == 2
    lens = _unpack_lens(st["lens_pk"], 320)
    hlit = st["hlit"].to(torch.int64)
    pos = torch.arange(288, device=lens.device)
    lit_lens = torch.where(pos[None, :] < hlit[:, None], lens[:, :288], 0)
    cnt, first, offs, syms, over_l = tables.build_canonical(lit_lens)
    ck = _set_table(ck, 1, mask, cnt, first, offs + tables.LIT_BASE,
                    tables.pack_syms(syms, 288), tables.LIT_BASE)

    # distance lengths start at per-lane hlit: nibble hlit+k, read with a
    # gather (the JAX package uses a 40-word one-hot there)
    k32 = torch.arange(32, device=lens.device)
    nib = hlit[:, None] + k32[None, :]
    word = st["lens_pk"].T.gather(1, nib >> 3)
    dist_lens = ((word >> (4 * (nib & 7))) & 0xF).to(torch.int32)
    dist_lens = torch.where(k32[None, :] < st["hdist"][:, None], dist_lens, 0)
    cntd, firstd, offsd, symsd, over_d = tables.build_canonical(dist_lens)
    ck = _set_table(ck, 2, mask, cntd, firstd, offsd + tables.DIST_BASE_,
                    tables.pack_syms(symsd, 36), tables.DIST_BASE_)

    no_eob = lens[:, 256] == 0  # a block needs a real EOB code
    bad = mask & (over_l | over_d | no_eob)
    ok = mask & ~bad
    st = dict(st)
    st["status"] = torch.where(bad, int(Result.ERR), st["status"])
    st["state"] = torch.where(bad, S_ERR,
                              torch.where(ok, S_SYM, st["state"]))
    return ck, st


def _build_fixed(ck, st):
    mask = st["need_build"] == 3
    dev = mask.device
    lit = [t.to(dev) for t in _FX_LIT]
    dist = [t.to(dev) for t in _FX_DIST]
    ck = _set_table(ck, 1, mask, *lit, tables.LIT_BASE)
    ck = _set_table(ck, 2, mask, *dist, tables.DIST_BASE_)
    st = dict(st)
    st["state"] = torch.where(mask, S_SYM, st["state"])
    return ck, st


def _apply_builds(ck, st, builds):
    """Convert lanes waiting on a Huffman build; vectorised and masked.
    ``builds`` is the second value of ``_chunk_gate``."""
    if builds is None:
        return ck, st
    for run, build in zip(builds, (_build_cl, _build_litdist, _build_fixed)):
        if run:
            ck, st = build(ck, st)
    st = dict(st)
    st["need_build"] = torch.zeros_like(st["need_build"])
    return ck, st


def revive_carry(carry, new_cap=None):
    """Prepare a decoder carry for resumption: UNFINISHED lanes (and, when
    ``new_cap`` raises their budget, EFULL lanes via their saved
    resume_state — ≙ infl_resize_output-then-continue) go back to
    RUNNING."""
    carry = dict(carry)
    status = carry["status"]
    carry["status"] = torch.where(status == int(Result.UNFINISHED),
                                  STATUS_RUNNING, status)
    if new_cap is not None:
        efull = status == int(Result.EFULL)
        carry["status"] = torch.where(efull, STATUS_RUNNING, carry["status"])
        carry["state"] = torch.where(efull, carry["resume_state"],
                                     carry["state"])
    return carry
