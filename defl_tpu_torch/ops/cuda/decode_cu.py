"""The decode kernels' wrappers, their plain PyTorch versions, the comparator.

Counterpart of ``defl_tpu/ops/pallas/decode_pl.py``.  The source
``csrc/decode_stream.cu`` holds two kernels over one step function:

- ``decode_tokens`` (≙ ``decode_tokens_pl``) is the whole decode.  For
  tensors on a CUDA device it launches the stream kernel once (or raises):
  every lane runs to a fixed point or the end of its step budget and
  builds its Huffman tables itself; the host reads one small tensor, and
  that is the call's only sync.  Each launch is counted in ``launches``,
  and its totals ride in the carry as ``stream_stats``.
  For tensors on the CPU it runs the kernel's plain version: the chunk
  loop over ``decode_chunk_ref`` with ``ib._apply_builds`` between chunks.
  ``_chunk=`` selects that loop on any device.
- ``decode_chunk`` is one K-step chunk with tables the caller built: the
  chunk kernel for CUDA tensors (counted in ``chunk_launches``), the twin
  ``decode_chunk_ref`` for CPU tensors.  The two agree bit for bit, slot
  for slot: tokens, state rows and lens.
- ``checked=True`` on either (CUDA tensors only) launches the checked
  build of the same source (``build.load(checked=True)``): every access
  checked against its extent, the stream kernel's shared memory also
  against a shadow of what the launch wrote; a fault raises
  ``build.KernelFault`` after the call's sync.  ``inject=(site, lane)``
  makes that lane take one access out of its extent at ``site`` (a name
  of ``build.SITES``), so that a caller can see each check fire.  Checked
  launches are counted in ``checked_launches`` and
  ``checked_chunk_launches``, never in the counts above; no entry point
  of the port passes ``checked``.
- ``compare_decodes`` says whether two complete decodes are equal: per
  lane the same end state, the same tokens in order, and for a resumable
  lane the same tables.  Token slots may differ (a lane of the chunk loop
  idles while it waits for a build), so tokens are compacted first.
  ``identical_decodes`` holds two stream decodes bit for bit, slots and
  totals too (a checked launch against the unchecked one).
- ``stream_order`` is the order in which the stream kernel's threads take
  the lanes, so a caller can tell which block and slot a lane runs in.

Kernel-facing layout (all int32; lane-minor rows so that a warp's loads
of one row coalesce, lane-major where the kernel reads a lane's row as a
run of 16-byte vectors):

    st_pk  [NROWS, N]  state rows R_* (u32 rows as bit patterns)
    lens   [40, N]     nibble-packed code lengths (u32 bits)
    words  [N, W]      packed input (u32 bits), >= 5 zero words past nbits;
                       decode_tokens pads W to a multiple of 4 so that
                       every row starts on a 16-byte boundary
        or [1, W]      shared input: one body that every lane reads (the
                       split decode of one huge stream, runtime/large.py);
                       bitpos, nbits and limit are then positions in the
                       whole stream and in_base (bytes) is the lane's
                       segment start, which a stored run's offset is taken
                       from
    tok    [rows, N]   two token slots per step (u32 bits), NOP = 0
  decode_chunk only:
    bound  [48, N]     left-justified code-space boundaries, kind*16+len
    adjoff [48, N]     offs[len] - first[len], kind*16+len
    maxlen [3, N]
    syms   [116, N]    symbol bank, 3 x 10-bit per word (u32 bits)
  the stream kernel only (the carry's own layout):
    count, first, offs [N, 3, 16];  maxlen [N, 3];  syms [N, 116]

``st_pk``, ``lens`` and the stream kernel's tables are updated in place:
they are this call's own copies of the carry.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

from defl_tpu_torch import constants as C
from defl_tpu_torch.errors import Result
from defl_tpu_torch.ops import inflate_batch as ib
from defl_tpu_torch.ops import tables
from defl_tpu_torch.ops.bitio import (bitrev16, extract, i32_to_u32, peek32,
                                      u32_to_i32)
from defl_tpu_torch.ops.cuda import build
from defl_tpu_torch.ops.inflate_batch import (
    S_BHDR, S_CLEN_HDR, S_CLEN_LENS, S_DICTID, S_DONE, S_ERR, S_FULL,
    S_LENS, S_STORED, S_STORED_HDR, S_STORED_LEN, S_SYM, S_WAIT, S_ZHDR,
    STORED_MAX_RUN, TOK_LIT, TOK_LIT_PAIR_BIT, TOK_MATCH, TOK_STORED)

# state rows (mirror of defl_tpu/ops/pallas/decode_pl.py:68-71); the port
# has no input window, so R_WINWORD rides along unused
(R_STATE, R_BITPOS, R_FINAL, R_HLIT, R_HDIST, R_HCLEN, R_IDX, R_PREV,
 R_DSTPOS, R_NEEDB, R_RESUME, R_STATUS, R_CLLO, R_CLHI, R_NBITS, R_CAP,
 R_WINWORD, R_LIMIT, R_REACH, R_INBASE) = range(20)
NROWS = 20
ST_KEYS = ("state", "bitpos", "final", "hlit", "hdist", "hclen", "idx",
           "prev", "dst_pos", "need_build", "resume_state", "status",
           "cl_lo", "cl_hi")

#: zero words decode_tokens appends to each input row: a step reads at most
#: 131 bits from its word-aligned cursor, i.e. five words (csrc header)
PAD_WORDS = 8

#: launches of the stream kernel (one per decode_tokens call on CUDA) and
#: of the chunk kernel, since import or since a caller reset them; raised
#: under a lock, since the shards of a sharded decode launch from threads
launches = 0
chunk_launches = 0
#: launches of the checked builds of the two kernels (``checked=True``)
checked_launches = 0
checked_chunk_launches = 0
_count_lock = threading.Lock()
#: the stream kernel's block (threads) and how many threads of each warp
#: own a lane; a block's lanes share its shared memory
STREAM_THREADS = 128
STREAM_LANES_PER_WARP = 8
#: int64 words of a stream launch's totals, read with the call's one sync
META_WORDS = 8
#: int32 words of a lane's shadow in the checked stream kernel: one bit per
#: shared word and lookup entry (csrc/decode_stream.cu SHADOW_WORDS)
SHADOW_WORDS = 49

_OK, _ERR, _UNF, _EFULL = (int(Result.OK), int(Result.ERR),
                           int(Result.UNFINISHED), int(Result.EFULL))


def _words_rows(words, N: int) -> int:
    """Rows a ``words`` tensor must have for N lanes: N, or 1 when it is
    one shared body (for one lane the two are the same thing)."""
    return 1 if words.dim() == 2 and words.shape[0] == 1 else N


def _check(st_pk, lens_pk, words, bound, adjoff, maxlen, syms, tok_out, K):
    """Refuse what the kernel does not take: one device, int32, the
    layout above, contiguous."""
    if K < 1:
        raise ValueError(f"K must be >= 1, got {K}")
    N = st_pk.shape[1] if st_pk.dim() == 2 else -1
    want = {"st_pk": (st_pk, (NROWS, N)),
            "lens": (lens_pk, (ib.LENS_WORDS, N)),
            "words": (words, (_words_rows(words, N), words.shape[-1])),
            "bound": (bound, (48, N)), "adjoff": (adjoff, (48, N)),
            "maxlen": (maxlen, (3, N)), "syms": (syms, (tables.SYMS_WORDS, N))}
    if tok_out is not None:
        want["tok_out"] = (tok_out, (2 * K, N))
    dev = st_pk.device
    for name, (t, shape) in want.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, st_pk on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if words.shape[1] < 1:
        raise ValueError("words has no columns")


def decode_chunk(st_pk, lens_pk, words, bound, adjoff, maxlen, syms,
                 tok_out=None, *, K: int, has_dict: bool = False,
                 checked: bool = False, inject=None):
    """One K-step chunk over all lanes (≙ decode_chunk_pl, whose static
    ``dict_len`` rides here per lane in row R_REACH).  Returns (tok [2K,
    N], st_pk, lens_pk); st_pk and lens_pk are updated in place, tokens
    land in ``tok_out`` (allocated when None).

    CUDA tensors launch the kernel (or raise); CPU tensors run the twin.
    ``checked``/``inject``: the checked build (module doc); it syncs to
    read its fault record.
    """
    _check(st_pk, lens_pk, words, bound, adjoff, maxlen, syms, tok_out, K)
    dev = st_pk.device
    if (checked or inject) and dev.type != "cuda":
        raise ValueError("the checked build runs on a CUDA card only")
    if dev.type == "cpu":
        return decode_chunk_ref(st_pk, lens_pk, words, bound, adjoff, maxlen,
                                syms, tok_out, K=K, has_dict=has_dict)
    if dev.type != "cuda":
        raise ValueError(f"decode_chunk runs on cuda or cpu, not {dev}")
    checked = bool(checked or inject)
    lib = build.load(checked)
    N = st_pk.shape[1]
    if tok_out is None:
        tok_out = torch.empty((2 * K, N), dtype=torch.int32, device=dev)
    extra = ()
    if checked:
        fault = torch.zeros(build.FAULT_WORDS, dtype=torch.int64, device=dev)
        site, lane = inject or (None, -1)
        extra = (fault.data_ptr(), build.site_id(site), int(lane))
    rc = lib.decode_chunk_launch(
        st_pk.data_ptr(), lens_pk.data_ptr(), words.data_ptr(),
        words.shape[1], int(words.shape[0] != N), bound.data_ptr(),
        adjoff.data_ptr(),
        maxlen.data_ptr(), syms.data_ptr(), tok_out.data_ptr(), N, K,
        int(bool(has_dict)), torch.cuda.current_stream(dev).cuda_stream,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        *extra)
    if rc != 0:
        raise RuntimeError(f"decode_chunk kernel launch failed: CUDA error "
                           f"{rc}")
    global chunk_launches, checked_chunk_launches
    with _count_lock:
        if checked:
            checked_chunk_launches += 1
        else:
            chunk_launches += 1
    if checked:
        build.raise_fault("decode_chunk", fault.tolist())
    return tok_out, st_pk, lens_pk


# ---------------------------------------------------------------------------
# the plain PyTorch twin
# ---------------------------------------------------------------------------

def _canon(tabs, kind, peek):
    """Boundary-sum canonical decode (≙ decode_pl._canon_pl).

    kind: a table kind (0 CL, 1 LIT, 2 DIST) or an int64 [N] of kinds.
    The code length is 1 + #{l : rev15 >= bound[l]}; found iff it is at
    most 15; symidx = adjoff[clen] + (rev15 >> (15 - clen)) indexes the
    symbol bank.  Returns (sym, clen, found, maxlen); sym and clen are 0
    where nothing was found.
    """
    bound, adjoff, maxlen, syms = tabs
    rv = bitrev16(peek & 0x7FFF) >> 1
    if isinstance(kind, int):
        b = bound[kind * 16 + 1: kind * 16 + 16]
        ml = maxlen[kind]
    else:
        ls = torch.arange(1, 16, device=peek.device)
        b = bound.gather(0, kind[None, :] * 16 + ls[:, None])
        ml = maxlen.gather(0, kind[None, :])[0]
    nge = (rv[None, :] >= b).sum(0)
    found = nge < C.MAX_CODE_LENGTH
    clen = torch.where(found, nge + 1, 0)
    adj = adjoff.gather(0, (kind * 16 + clen)[None, :])[0]
    symidx = torch.where(found, adj + (rv >> (15 - clen)), 0)
    symidx = symidx.clamp(0, tables.SYMS_BANK - 1)
    q = symidx // 3
    word = syms.gather(0, q[None, :])[0]
    sym = torch.where(found, (word >> (10 * (symidx - 3 * q))) & 0x3FF, 0)
    return sym, clen, found, ml


def _ref_step(st, lens, words, tabs, nbits, cap, limit, reach, in_base,
              has_dict):
    """One lockstep step for every lane (all values int64 [N]).

    The same state machine as defl_tpu/ops/pallas/decode_pl.py `step`,
    with every lane's bits available (no FIFO, no dry lanes).  A step
    that lacks bits leaves bitpos, state and tokens untouched and marks
    the lane UNFINISHED; only fully successful branches consume.
    """
    s = st["state"]
    bitpos = st["bitpos"]
    avail = nbits - bitpos
    peek = peek32(words, bitpos)
    zero = torch.zeros_like(s)
    consume = zero
    nstate = s
    token = zero
    token2 = zero
    status = st["status"]
    final = st["final"]
    hlit, hdist, hclen = st["hlit"], st["hdist"], st["hclen"]
    idx, prev = st["idx"], st["prev"]
    dst_pos = st["dst_pos"]
    need_build = st["need_build"]
    cl_lo, cl_hi = st["cl_lo"], st["cl_hi"]
    resume_state = st["resume_state"]
    stalled = torch.zeros_like(s, dtype=torch.bool)

    if bool(((s <= S_CLEN_LENS) & (s != S_STORED)).any()):
        # ---- S_ZHDR ----
        m = s == S_ZHDR
        cmf = peek & 0xFF
        flg = (peek >> 8) & 0xFF
        zok = ((cmf & 0xF) == C.ZLIB_CM_DEFLATE) \
            & ((cmf >> 4) <= C.ZLIB_MAX_CINFO) \
            & ((((cmf << 8) + flg) % 31) == 0)
        fdict = (flg & C.ZLIB_FLAG_FDICT) != 0
        zh_next = torch.where(~zok, S_ERR, torch.where(
            fdict, S_DICTID if has_dict else S_ERR, S_BHDR))
        enough = avail >= 16
        nstate = torch.where(m & enough, zh_next, nstate)
        consume = torch.where(m & enough & zok, 16, consume)
        stalled = stalled | (m & ~enough)

        # ---- S_DICTID ----
        m = s == S_DICTID
        enough = avail >= 32
        nstate = torch.where(m & enough, S_BHDR, nstate)
        consume = torch.where(m & enough, 32, consume)
        stalled = stalled | (m & ~enough)

        # ---- S_BHDR (the split-decode limit completes a segment) ----
        at_lim = (s == S_BHDR) & (bitpos >= limit)
        m = (s == S_BHDR) & ~at_lim
        nstate = torch.where(at_lim, S_DONE, nstate)
        enough = avail >= 3
        bt = (peek >> 1) & 3
        bh_next = torch.where(bt == 0, S_STORED_HDR, torch.where(
            bt == 1, S_WAIT, torch.where(bt == 2, S_CLEN_HDR, S_ERR)))
        ok = m & enough
        nstate = torch.where(ok, bh_next, nstate)
        consume = torch.where(ok & (bt != 3), 3, consume)
        final = torch.where(ok, peek & 1, final)
        need_build = torch.where(ok & (bt == 1), 3, need_build)
        stalled = stalled | (m & ~enough)

        # ---- S_STORED_HDR: byte-align (reads no content) ----
        m = s == S_STORED_HDR
        nstate = torch.where(m, S_STORED_LEN, nstate)
        consume = torch.where(m, (-bitpos) & 7, consume)

        # ---- S_STORED_LEN ----
        m = s == S_STORED_LEN
        enough = avail >= 32
        slen = peek & 0xFFFF
        lok = slen == (~(peek >> 16) & 0xFFFF)   # ≙ infl.c:118
        end_nx = torch.where(final > 0, S_DONE, S_BHDR)
        nstate = torch.where(m & enough, torch.where(
            ~lok, S_ERR, torch.where(slen == 0, end_nx, S_STORED)), nstate)
        consume = torch.where(m & enough & lok, 32, consume)
        idx = torch.where(m & enough & lok, slen, idx)
        stalled = stalled | (m & ~enough)

        # ---- S_CLEN_HDR ----
        m = s == S_CLEN_HDR
        enough = avail >= 14
        h_lit = 257 + (peek & 31)
        h_dist = 1 + ((peek >> 5) & 31)
        h_clen = 4 + ((peek >> 10) & 15)
        hok = (h_lit <= 286) & (h_dist <= 30)
        ok = m & enough
        okh = ok & hok
        nstate = torch.where(ok, torch.where(hok, S_CLEN_LENS, S_ERR), nstate)
        consume = torch.where(okh, 14, consume)
        hlit = torch.where(okh, h_lit, hlit)
        hdist = torch.where(okh, h_dist, hdist)
        hclen = torch.where(okh, h_clen, hclen)
        idx = torch.where(okh, 0, idx)
        cl_lo = torch.where(okh, 0, cl_lo)
        cl_hi = torch.where(okh, 0, cl_hi)
        stalled = stalled | (m & ~enough)

        # ---- S_CLEN_LENS ----
        m = s == S_CLEN_LENS
        enough = avail >= 3
        ok = m & enough
        ordi = ib._ord_arith(idx.clamp(0, 18))
        v3 = peek & 7
        sh3 = 3 * ordi
        cl_lo = torch.where(ok & (ordi < 10),
                            cl_lo | ((v3 << (sh3 & 31)) & 0xFFFFFFFF), cl_lo)
        cl_hi = torch.where(ok & (ordi >= 10),
                            cl_hi | ((v3 << ((sh3 - 30) & 31)) & 0xFFFFFFFF),
                            cl_hi)
        fin_cl = ok & (idx + 1 >= hclen)
        consume = torch.where(ok, 3, consume)
        idx = torch.where(ok, idx + 1, idx)
        need_build = torch.where(fin_cl, 1, need_build)
        nstate = torch.where(fin_cl, S_WAIT, nstate)
        stalled = stalled | (m & ~enough)

    end_next = torch.where(final > 0, S_DONE, S_BHDR)

    # ---- S_STORED: input-offset tokens (reads no bits) ----
    m = s == S_STORED
    if bool(m.any()):
        space = cap - dst_pos
        run = torch.minimum(idx.clamp(max=STORED_MAX_RUN), space)
        run_avail = torch.minimum(run, avail >> 3)
        is_full = m & (space == 0)
        can = m & (space > 0) & (run_avail > 0)
        starv = m & (space > 0) & (run_avail <= 0)
        # segment-relative offsets (≙ inflate_batch S_STORED)
        off_bytes = ((bitpos >> 3) - in_base) & 0xFFFFFFFF
        token = torch.where(
            can, ((TOK_STORED << 30) | ((run_avail - 1) << 22) | off_bytes)
            & 0xFFFFFFFF, token)
        consume = torch.where(can, run_avail << 3, consume)
        dst_pos = torch.where(can, dst_pos + run_avail, dst_pos)
        idx = torch.where(can, idx - run_avail, idx)
        nstate = torch.where(can & (idx == 0), end_next, nstate)
        nstate = torch.where(is_full, S_FULL, nstate)
        status = torch.where(is_full, _EFULL, status)
        resume_state = torch.where(is_full, s, resume_state)
        stalled = stalled | starv

    # ---- primary canonical decode: CL table for S_LENS, LIT for S_SYM ----
    dec_mask = (s == S_LENS) | (s == S_SYM)
    if bool(dec_mask.any()):
        is_lens = s == S_LENS
        kind = torch.where(is_lens, 0, 1)
        sym, clen, found, ml1 = _canon(tabs, kind, peek)
        dec_stall = dec_mask & ((~found & (avail < ml1))
                                | (found & (clen > avail)))
        dec_err = dec_mask & ~found & (avail >= ml1)
        dec_ok = dec_mask & found & (clen <= avail)
        stalled = stalled | dec_stall
        nstate = torch.where(dec_err, S_ERR, nstate)

        # ---- S_LENS: one code-length symbol -> packed lens nibbles ----
        m = is_lens & dec_ok
        if bool(m.any()):
            is_lit_len = sym < 16
            is16 = sym == 16
            is17 = sym == 17
            is18 = sym == 18
            ebits = torch.where(is16, 2, torch.where(
                is17, 3, torch.where(is18, 7, 0)))
            # a repeat with nothing before it is an error before its extra
            # bits are read (≙ the oracle; the JAX step stalls on them)
            no_prev = m & is16 & (idx == 0)
            nstate = torch.where(no_prev, S_ERR, nstate)
            m = m & ~no_prev
            lens_stall = m & (clen + ebits > avail)
            stalled = stalled | lens_stall
            m = m & ~lens_stall
            ev = extract(peek, clen, ebits)
            rep = torch.where(is_lit_len, 1, torch.where(
                is16 | is17, 3 + ev, 11 + ev))
            wval = torch.where(is_lit_len, sym, torch.where(is16, prev, 0))
            bad = idx + rep > hlit + hdist
            lok = m & ~bad
            nstate = torch.where(m & bad, S_ERR, nstate)
            lens = ib._write_lens_run(lens, lok & (wval > 0), idx, idx + rep,
                                      wval)
            consume = torch.where(lok, clen + ebits, consume)
            prev = torch.where(lok & is_lit_len, sym, torch.where(
                lok & (is17 | is18), 0, prev))
            idx = torch.where(lok, idx + rep, idx)
            fin = lok & (idx == hlit + hdist)
            need_build = torch.where(fin, 2, need_build)
            nstate = torch.where(fin, S_WAIT, nstate)

        # ---- S_SYM: literal (pair) / EOB / whole match ----
        m = (s == S_SYM) & dec_ok
        if bool(m.any()):
            is_lit1 = m & (sym < 256)
            is_eob = m & (sym == 256)
            is_len = m & (sym > 256) & (sym <= 285)
            sym_err = m & (sym > 285)

            len_v, leb = ib._length_from_sym(sym, peek, clen)
            consumed1 = clen + torch.where(is_len, leb, 0)
            peek2 = peek32(words, bitpos + consumed1)
            avail2 = avail - consumed1
            sym2, clen2, found2, ml2 = _canon(tabs, 2, peek2)
            symL2, clenL2, foundL2, _ = _canon(tabs, 1, peek2)

            dv, deb = ib._dist_from_sym(sym2, peek2, clen2)
            consumed2 = clen2 + deb
            # the code first: a hole or a distance code of 30 or 31 is an
            # error before any extra bits are read (≙ the oracle; the JAX
            # step stalls on the 13 extra bits such a code would have)
            code_stall = (~found2 & (avail2 < ml2)) | (found2
                                                       & (clen2 > avail2))
            bad_code = ~found2 | (sym2 > 29)
            d_stall = is_len & (code_stall
                                | (~bad_code & (consumed2 > avail2)))
            d_err = is_len & ~code_stall & bad_code
            md = is_len & ~d_stall & ~d_err
            too_far = md & (dv > dst_pos + reach)   # ≙ infl.c:1286
            m_full = md & ~too_far & (dst_pos + len_v > cap)
            m_ok = md & ~too_far & ~m_full
            stalled = stalled | d_stall
            token = torch.where(m_ok, (TOK_MATCH << 30) | ((len_v - 3) << 21)
                                | (dv - 1), token)
            consume = torch.where(m_ok, consumed1 + consumed2, consume)
            dst_pos = torch.where(m_ok, dst_pos + len_v, dst_pos)
            nstate = torch.where(m_full, S_FULL, nstate)
            status = torch.where(m_full, _EFULL, status)
            resume_state = torch.where(m_full, s, resume_state)
            nstate = torch.where(sym_err | d_err | too_far, S_ERR, nstate)

            lit_full = is_lit1 & (dst_pos >= cap)
            lit1_ok = is_lit1 & ~lit_full
            lit2_ok = lit1_ok & foundL2 & (symL2 < 256) \
                & (clenL2 <= avail2) & (dst_pos + 1 < cap)
            token = torch.where(
                lit1_ok, (TOK_LIT << 30) | sym | torch.where(
                    lit2_ok, TOK_LIT_PAIR_BIT | (symL2 << 8), 0), token)
            consume = torch.where(lit1_ok, clen + torch.where(
                lit2_ok, clenL2, 0), consume)
            dst_pos = torch.where(lit1_ok, dst_pos + 1 + lit2_ok.long(),
                                  dst_pos)
            nstate = torch.where(lit_full, S_FULL, nstate)
            status = torch.where(lit_full, _EFULL, status)
            resume_state = torch.where(lit_full, s, resume_state)

            consume = torch.where(is_eob, clen, consume)
            nstate = torch.where(is_eob, end_next, nstate)

            # ---- opportunistic second token: defer-only, no error paths;
            # whatever does not fit is decoded next step as a primary ----
            t2 = m_ok | lit1_ok
            if bool(t2.any()):
                b3 = consume
                peek3 = peek32(words, bitpos + b3)
                avail3 = avail - consume
                sym3, clen3, found3, _ = _canon(tabs, 1, peek3)
                t2v = t2 & found3 & (clen3 <= avail3)
                is_lit3 = t2v & (sym3 < 256)
                is_eob3 = t2v & (sym3 == 256)
                is_len3 = t2v & (sym3 > 256) & (sym3 <= 285)

                lit3_ok = is_lit3 & (dst_pos < cap)
                token2 = torch.where(lit3_ok, (TOK_LIT << 30) | sym3, token2)
                consume = torch.where(lit3_ok, consume + clen3, consume)
                dst_pos = torch.where(lit3_ok, dst_pos + 1, dst_pos)

                consume = torch.where(is_eob3, consume + clen3, consume)
                nstate = torch.where(is_eob3, end_next, nstate)

                len3, leb3 = ib._length_from_sym(sym3, peek3, clen3)
                c31 = clen3 + torch.where(is_len3, leb3, 0)
                peek4 = peek32(words, bitpos + b3 + c31)
                sym4, clen4, found4, _ = _canon(tabs, 2, peek4)
                dv4, deb4 = ib._dist_from_sym(sym4, peek4, clen4)
                c42 = clen4 + deb4
                m4_ok = (is_len3 & found4 & (c42 <= avail3 - c31)
                         & (sym4 <= 29) & (dv4 <= dst_pos + reach)
                         & (dst_pos + len3 <= cap))
                token2 = torch.where(m4_ok, (TOK_MATCH << 30)
                                     | ((len3 - 3) << 21) | (dv4 - 1), token2)
                consume = torch.where(m4_ok, consume + c31 + c42, consume)
                dst_pos = torch.where(m4_ok, dst_pos + len3, dst_pos)

    # ---- terminals ----
    status = torch.where(stalled, _UNF, status)
    status = torch.where(nstate == S_ERR, _ERR, status)
    status = torch.where(nstate == S_DONE, _OK, status)

    nst = dict(state=nstate, bitpos=bitpos + consume, final=final,
               hlit=hlit, hdist=hdist, hclen=hclen, idx=idx, prev=prev,
               dst_pos=dst_pos, need_build=need_build,
               resume_state=resume_state, status=status,
               cl_lo=cl_lo, cl_hi=cl_hi)
    return nst, lens, token, token2


def decode_chunk_ref(st_pk, lens_pk, words, bound, adjoff, maxlen, syms,
                     tok_out=None, *, K: int, has_dict: bool = False):
    """Plain PyTorch twin of the CUDA kernel: the same inputs, outputs and
    in-place updates as ``decode_chunk``, on any device.  Values are held
    as int64 (u32 fields masked to 32 bits) and converted back to int32
    bit patterns at the end."""
    _check(st_pk, lens_pk, words, bound, adjoff, maxlen, syms, tok_out, K)
    N = st_pk.shape[1]
    if tok_out is None:
        tok_out = torch.empty((2 * K, N), dtype=torch.int32,
                              device=st_pk.device)
    rows = st_pk.to(torch.int64)
    st = {k: rows[r] for r, k in enumerate(ST_KEYS)}
    st["cl_lo"] = st["cl_lo"] & 0xFFFFFFFF
    st["cl_hi"] = st["cl_hi"] & 0xFFFFFFFF
    lens = i32_to_u32(lens_pk)
    w64 = i32_to_u32(words)
    tabs = (bound.to(torch.int64), adjoff.to(torch.int64),
            maxlen.to(torch.int64), i32_to_u32(syms))
    fixed = (rows[R_NBITS], rows[R_CAP], rows[R_LIMIT], rows[R_REACH],
             rows[R_INBASE])
    for k in range(K):
        st, lens, t1, t2 = _ref_step(st, lens, w64, tabs, *fixed,
                                     has_dict=has_dict)
        tok_out[2 * k] = u32_to_i32(t1)
        tok_out[2 * k + 1] = u32_to_i32(t2)
    for r, key in enumerate(ST_KEYS):
        st_pk[r] = u32_to_i32(st[key])
    lens_pk.copy_(u32_to_i32(lens))
    return tok_out, st_pk, lens_pk


# ---------------------------------------------------------------------------
# carry <-> kernel rows
# ---------------------------------------------------------------------------

def _pack_state(st, nbits, cap, limit, dict_reach, in_base):
    """The carry's per-lane scalars and the call's per-lane constants ->
    st_pk [NROWS, N] and lens [40, N], int32 (layout in the module doc)."""
    i32 = lambda x: x.to(torch.int32)
    rows = [st["state"], st["bitpos"], st["final"], st["hlit"], st["hdist"],
            st["hclen"], st["idx"], st["prev"], st["dst_pos"],
            st["need_build"], st["resume_state"], st["status"],
            u32_to_i32(st["cl_lo"]), u32_to_i32(st["cl_hi"]), nbits, cap,
            torch.zeros_like(nbits), limit, dict_reach, in_base]
    return (torch.stack([i32(r) for r in rows]),
            u32_to_i32(st["lens_pk"]).contiguous())


def _state_from_rows(st_pk, lens):
    """st_pk rows and lens -> the carry's SCAN_KEYS (rows are views)."""
    st = {key: (i32_to_u32(st_pk[r]) if key in ("cl_lo", "cl_hi")
                else st_pk[r]) for r, key in enumerate(ST_KEYS)}
    st["lens_pk"] = i32_to_u32(lens)
    return st


def _kernel_inputs(st, ck, nbits, cap, limit, dict_reach, in_base):
    """Carry dicts -> decode_chunk's rows (layout in the module doc).

    bound[l] = (first[l] + count[l]) << (15 - l) and adjoff[l] = offs[l] -
    first[l]: the same build, in the layout the boundary-sum decode reads
    (≙ decode_pl.py:808-817)."""
    N = nbits.shape[0]
    st_pk, lens = _pack_state(st, nbits, cap, limit, dict_reach, in_base)
    sh = (15 - torch.arange(16, device=nbits.device, dtype=torch.int32))
    bound = ((ck["first"] + ck["count"]) << sh).permute(1, 2, 0)
    adjoff = (ck["offs"] - ck["first"]).permute(1, 2, 0)
    return (st_pk, lens, bound.reshape(48, N).contiguous(),
            adjoff.reshape(48, N).contiguous(), ck["maxlen"].T.contiguous(),
            u32_to_i32(ck["syms"].T).contiguous())


def _unpack_state(st, st_pk, lens):
    return {**st, **_state_from_rows(st_pk, lens)}


# ---------------------------------------------------------------------------
# the stream kernel
# ---------------------------------------------------------------------------

def _launch_stream(st_pk, lens, count, first, offs, maxlen, syms, words,
                   tok, meta, order, n_steps, has_dict, check=None):
    """Launch the stream kernel on tensors this call owns, at the launch
    shape ``STREAM_THREADS`` x ``STREAM_LANES_PER_WARP``; raise when the
    card refuses the launch.  Every launch adds one to ``launches``.

    ``check``: (fault [FAULT_WORDS] int64, shadow [N, SHADOW_WORDS] int32,
    both zeroed, injected site id, injected lane) launches the checked
    build instead, counted in ``checked_launches``."""
    dev = st_pk.device
    N = st_pk.shape[1]
    want = {"st_pk": (st_pk, (NROWS, N)), "lens": (lens, (ib.LENS_WORDS, N)),
            "count": (count, (N, 3, 16)), "first": (first, (N, 3, 16)),
            "offs": (offs, (N, 3, 16)), "maxlen": (maxlen, (N, 3)),
            "syms": (syms, (N, tables.SYMS_WORDS)),
            "words": (words, (_words_rows(words, N), words.shape[-1])),
            "tok": (tok, (2 * n_steps, N)), "meta": (meta, (META_WORDS,)),
            "order": (order, (N,))}
    extra = ()
    if check is not None:
        fault, shadow, site, lane = check
        want.update(fault=(fault, (build.FAULT_WORDS,)),
                    shadow=(shadow, (N, SHADOW_WORDS)))
        extra = (fault.data_ptr(), shadow.data_ptr(), meta.numel(),
                 int(site), int(lane))
    for name, (t, shape) in want.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the stream kernel "
                             f"takes tensors of one CUDA device")
        dtype = torch.int64 if name in ("meta", "fault") else torch.int32
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    threads, lanes_per_warp = STREAM_THREADS, STREAM_LANES_PER_WARP
    rc = build.load(check is not None).decode_stream_launch(
        st_pk.data_ptr(), lens.data_ptr(), count.data_ptr(),
        first.data_ptr(), offs.data_ptr(), maxlen.data_ptr(),
        syms.data_ptr(), words.data_ptr(), words.shape[1],
        int(words.shape[0] != N), tok.data_ptr(), meta.data_ptr(),
        order.data_ptr(), N,
        n_steps, int(bool(has_dict)), int(threads), int(lanes_per_warp),
        torch.cuda.current_stream(dev).cuda_stream,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        *extra)
    if rc != 0:
        raise RuntimeError(f"decode_stream kernel launch failed: CUDA error "
                           f"{rc} ({threads} threads a block, "
                           f"{lanes_per_warp} lanes a warp)")
    global launches, checked_launches
    with _count_lock:
        if check is None:
            launches += 1
        else:
            checked_launches += 1


def _read_meta(meta):
    """The call's one sync with the host: the launch's totals (and, behind
    them, a checked launch's fault record)."""
    return meta.tolist()


def pad_body(body: np.ndarray) -> np.ndarray:
    """A shared body (uint8 ndarray) with at least ``PAD_WORDS`` zero words
    behind it, up to a multiple of 16 bytes: what the kernels read past a
    stream's end, added on the host so that no pass on the device copies
    the body."""
    n = body.size
    out = np.zeros(-(-(n + 4 * PAD_WORDS) // 16) * 16, np.uint8)
    out[:n] = body
    return out


def stream_order(nbits, limit=None, bitpos=None, running=None):
    """The order in which the stream kernel's threads take the lanes (its
    ``order``): by the input bits each lane has left, most first, ties in
    lane order, lanes not ``running`` last.  A warp's lanes then have alike
    work (and alike data), so they branch alike and end together, and the
    longest lanes start first.  A lane of a split decode ends at its
    ``limit``, not at the shared body's end.  All [N], tensors or arrays;
    a fresh carry's ``bitpos`` is its start bit.  Returns int32 [N] on
    ``nbits``' device (the CPU for an array)."""
    dev = nbits.device if torch.is_tensor(nbits) else None
    lanes = lambda x: x.to(dev, torch.int64) if torch.is_tensor(x) else \
        torch.as_tensor(np.asarray(x, np.int64), device=dev)
    left = lanes(nbits)
    if limit is not None:
        left = torch.minimum(left, lanes(limit))
    if bitpos is not None:
        left = left - lanes(bitpos)
    if running is not None:
        left = torch.where(lanes(running) != 0, left, -1)
    return torch.argsort(left, descending=True, stable=True).to(torch.int32)


def _decode_stream(words, nbits, cap, limit, dict_reach, in_base, st, ck,
                   n_steps, has_dict, checked=False, inject=None):
    """One decode on the card: pack the carry once, one launch, one sync.

    The carry it returns also holds ``stream_stats``, the launch's totals
    over all lanes: token rows used, steps run, tokens stored, table
    builds, symbols the builds sorted, and the builds' share of the lanes'
    cycles.  ``checked``/``inject``: the checked build, whose fault record
    is read with the totals and raised (module doc)."""
    dev = words.device
    st_pk, lens = _pack_state(st, nbits, cap, limit, dict_reach, in_base)
    own = lambda t: t.to(torch.int32, copy=True).contiguous()
    count, first, offs = own(ck["count"]), own(ck["first"]), own(ck["offs"])
    maxlen = own(ck["maxlen"])
    syms = u32_to_i32(ck["syms"]).contiguous()
    # zero-filled here; the kernel stores real tokens only
    tok = torch.zeros((2 * n_steps, nbits.shape[0]), dtype=torch.int32,
                      device=dev)
    checked = bool(checked or inject)
    fault_words = build.FAULT_WORDS if checked else 0
    meta = torch.zeros(META_WORDS + fault_words, dtype=torch.int64,
                       device=dev)
    order = stream_order(nbits, limit, st_pk[R_BITPOS],
                         st_pk[R_STATUS] == ib.STATUS_RUNNING)
    check = None
    if checked:
        site, lane = inject or (None, -1)
        shadow = torch.zeros((nbits.shape[0], SHADOW_WORDS),
                             dtype=torch.int32, device=dev)
        check = (meta[META_WORDS:], shadow, build.site_id(site), lane)
    _launch_stream(st_pk, lens, count, first, offs, maxlen, syms, words, tok,
                   meta[:META_WORDS], order, n_steps, has_dict, check=check)
    totals = _read_meta(meta)
    if checked:
        build.raise_fault("decode_stream", totals[META_WORDS:])
    (rows, steps, builds, sorted_syms, t_build, t_lanes,
     stored) = totals[:7]
    stats = {"tok_rows": rows, "steps": steps, "tokens": stored,
             "builds": builds, "sorted_symbols": sorted_syms,
             "build_share": t_build / t_lanes if t_lanes else 0.0}
    carry = _state_from_rows(st_pk, lens)
    carry.update(count=count, first=first, offs=offs, maxlen=maxlen,
                 syms=i32_to_u32(syms), tok_rows=rows, stream_stats=stats)
    return tok, carry


# ---------------------------------------------------------------------------
# the decode
# ---------------------------------------------------------------------------

def decode_tokens(words, nbits, zflag, cap, *, T: int, K: int | None = None,
                  dict_len: int = 0, has_dict: bool = False, carry=None,
                  limit=None, start_bit=None, dict_reach=None,
                  shared_input: bool = False, in_base=None, device=None,
                  checked: bool = False, inject=None, _chunk=None):
    """Run the decoder for up to max(K, T // 2) steps a lane (≙
    decode_tokens_pl).

    words: packed streams [N, W], a uint32 ndarray (as pack_streams
    makes it) or an int32 tensor of the same bits; nbits/zflag/cap: [N].
    shared_input: every lane reads the same stream: words is [W] or
    [1, W]; bitpos, start_bit, limit and nbits are then positions in the
    whole stream, a lane stops at the first block boundary at or past its
    ``limit``, ``dict_reach`` [N] is each lane's back-reference reach
    before its own start, and ``in_base`` [N] (bytes) rebases stored-run
    token offsets to the lane's segment (runtime/large.py).  An ndarray
    body (uint32 words, or the uint8 bytes themselves) is padded on the
    host before it goes up; a tensor is taken as it
    is when its length is a multiple of 4 words (the caller pads before
    the upload: a pad here would copy the whole body on the device).
    Everything runs on ``device``: by default where a ``words`` tensor
    lies, and on CUDA for an ndarray, like every other entry point.
    Returns (tokens int32 [rows, N] holding u32 token bits, carry dict);
    carry["tok_rows"] (an int) bounds the rows written.  A carry from an
    earlier call resumes where it stopped; token buffers of successive
    calls concatenate along axis 0.

    On CUDA the stream kernel runs the whole call in one launch, builds
    included, and the host syncs once, for tok_rows; a lane spends a step
    of its budget only where it does one.  On the CPU, or with
    ``_chunk`` (tests and the smoke run pass ``decode_chunk_ref`` to drive
    the plain version on the card), the chunk loop runs: per chunk the
    batched table builds, one ``_chunk`` call of K steps and one host sync
    (``ib._chunk_gate``); a lane that waits for a build idles meanwhile.
    K defaults to 512 on CUDA and 128 on the CPU, where the twin pays for
    every step whether or not a lane still works.  ``checked`` and
    ``inject`` launch the stream kernel's checked build (module doc): on
    CUDA only, and not with ``_chunk``.
    """
    if isinstance(words, np.ndarray):
        words = np.ascontiguousarray(words)
        if shared_input:    # the body's bytes, whatever its dtype
            words = pad_body(words.reshape(-1).view(np.uint8))
        words = torch.from_numpy(words.view(np.int32))
        dev = torch.device("cuda" if device is None else device)
    else:
        dev = torch.device(device) if device is not None else words.device
    if K is None:
        K = 512 if dev.type == "cuda" else 128
    N = nbits.shape[0]
    as32 = lambda x: torch.as_tensor(x, device=dev).to(torch.int32)
    if shared_input:
        words = words.reshape(1, -1).to(dev)
        if words.shape[1] % 4:
            words = F.pad(words, (0, (-words.shape[1]) % 4))
    else:
        # >= PAD_WORDS zero words, up to a row length that is a multiple
        # of 4
        pad = PAD_WORDS + (-(words.shape[1] + PAD_WORDS)) % 4
        words = F.pad(words.to(dev), (0, pad))
    nbits, zflag, cap = as32(nbits), as32(zflag), as32(cap)
    limit = (torch.full((N,), 1 << 30, dtype=torch.int32, device=dev)
             if limit is None else as32(limit))
    dict_reach = (torch.full((N,), dict_len, dtype=torch.int32, device=dev)
                  if dict_reach is None else as32(dict_reach))
    in_base = (torch.zeros(N, dtype=torch.int32, device=dev)
               if in_base is None else as32(in_base))
    if carry is None:
        st = ib._init_scan_state(N, dev)
        ck = ib._init_chunk_state(N, dev)
        st["state"] = torch.where(zflag > 0, S_ZHDR, S_BHDR).to(torch.int32)
        if start_bit is not None:
            st["bitpos"] = as32(start_bit)
    else:
        st = {k: carry[k] for k in ib.SCAN_KEYS}
        ck = {k: carry[k] for k in ib.CHUNK_KEYS}

    n_steps = max(K, T // 2)
    if (checked or inject) and (_chunk is not None or dev.type != "cuda"):
        raise ValueError("the checked build is the stream kernel's, on a "
                         "CUDA card")
    if _chunk is None and dev.type == "cuda":
        return _decode_stream(words, nbits, cap, limit, dict_reach, in_base,
                              st, ck, n_steps, has_dict, checked, inject)
    if _chunk is None and dev.type != "cpu":
        raise ValueError(f"decode_tokens runs on cuda or cpu, not {dev}")

    # the plain version: the chunk loop
    chunk = _chunk or decode_chunk_ref
    n_chunks = (n_steps + K - 1) // K
    # every chunk writes all of its slots; the rows no chunk reached are
    # cleared once at the end
    tokbuf = torch.empty((n_chunks * 2 * K, N), dtype=torch.int32, device=dev)
    ci = 0
    while ci < n_chunks:
        running, builds = ib._chunk_gate(st)
        if not running:
            break
        ck, st = ib._apply_builds(ck, st, builds)
        st_pk, lens, bound, adjoff, maxlen, syms = _kernel_inputs(
            st, ck, nbits, cap, limit, dict_reach, in_base)
        chunk(st_pk, lens, words, bound, adjoff, maxlen, syms,
              tokbuf[ci * 2 * K:(ci + 1) * 2 * K], K=K, has_dict=has_dict)
        st = _unpack_state(st, st_pk, lens)
        ci += 1
    tokbuf[ci * 2 * K:].zero_()
    return tokbuf, {**st, **ck, "tok_rows": ci * 2 * K}


# ---------------------------------------------------------------------------
# the comparator
# ---------------------------------------------------------------------------

#: a lane's end state, compared for every lane
_LANE_KEYS = ("status", "state", "bitpos", "dst_pos", "final", "resume_state")
_RESUMABLE = (_UNF, _EFULL, ib.STATUS_RUNNING)


def compact_tokens(parts) -> tuple[torch.Tensor, torch.Tensor]:
    """Token parts [(tokbuf, tok_rows), ...] of successive calls -> (int64
    [N, M] each lane's non-NOP tokens in order as u32 values, zero after
    them; int64 [N] their number)."""
    toks = torch.cat([t[:rows] for t, rows in parts], 0)
    lanes = i32_to_u32(toks.T)
    live = lanes != 0
    n = live.sum(1)
    order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
    width = int(n.max()) if n.numel() else 0
    return lanes.gather(1, order[:, :width]), n


def select_lanes(run, lanes):
    """(parts, carry) of a decode -> the same run reduced to ``lanes``."""
    parts, carry = run
    if torch.is_tensor(parts):
        parts = [(parts, carry["tok_rows"])]
    idx = torch.as_tensor(lanes, device=carry["status"].device)
    out = {k: (v if not torch.is_tensor(v) else
               v[:, idx] if k == "lens_pk" else v[idx])
           for k, v in carry.items()}
    return [(t[:rows, idx], rows) for t, rows in parts], out


#: a stream decode's totals that do not count cycles
_STATS_EXACT = ("tok_rows", "steps", "tokens", "builds", "sorted_symbols")


def identical_decodes(a, b) -> list[str]:
    """What differs between two stream decodes of the same inputs that must
    agree bit for bit, such as a checked launch and the unchecked one: an
    empty list when nothing does.

    a, b: (parts, carry) as ``compare_decodes`` takes them.  Compared: each
    call's token rows up to its ``tok_rows``, every tensor of the last
    carry (state rows, lens, count/first/offs/maxlen/syms) and its totals
    but the clock's."""
    (pa, ca), (pb, cb) = a, b
    if torch.is_tensor(pa):
        pa, pb = [(pa, ca["tok_rows"])], [(pb, cb["tok_rows"])]
    differ = []
    if [r for _, r in pa] != [r for _, r in pb]:
        differ.append("tok_rows")
    elif not all(torch.equal(ta[:r], tb[:r])
                 for (ta, r), (tb, _) in zip(pa, pb)):
        differ.append("tokens")
    if ca.keys() != cb.keys():
        differ.append("carry keys")
    differ += [k for k, v in ca.items() if torch.is_tensor(v)
               and not (torch.is_tensor(cb.get(k)) and torch.equal(v, cb[k]))]
    sa, sb = ca.get("stream_stats", {}), cb.get("stream_stats", {})
    differ += [f"stream_stats.{k}" for k in _STATS_EXACT
               if sa.get(k) != sb.get(k)]
    return differ


def compare_decodes(a, b, lanes=None) -> int:
    """Whether two complete decodes of the same lanes are equal: the
    largest absolute difference found, so 0 means equal.

    a, b: (parts, carry), each run's token parts [(tokbuf, tok_rows), ...]
    in call order (or one (tokbuf, carry) pair for a single call) and its
    last carry, both run until no lane is RUNNING.  Compared, for every
    lane (or the rows ``lanes`` of both): status, state, bitpos, dst_pos,
    final, resume_state, and the lane's non-NOP tokens in order; and for a
    lane that a later call can resume (UNFINISHED, EFULL, or out of
    budget) the rest of its state rows, its lens and its tables.  Token
    slots are not compared: they depend on when a lane waited.
    """
    runs = []
    for parts, carry in (a, b):
        if torch.is_tensor(parts):
            parts = [(parts, carry["tok_rows"])]
        runs.append((parts, carry) if lanes is None
                    else select_lanes((parts, carry), lanes))
    (pa, ca), (pb, cb) = runs
    dev = ca["status"].device

    def lane_rows(c, key):
        t = c[key].to(dev)
        if key == "lens_pk":
            t = t.T
        return t.to(torch.int64).reshape(t.shape[0], -1)

    err = 0

    def hold(x, y, rows=None):
        nonlocal err
        if x.shape != y.shape:
            err = max(err, 1 << 32)
            return
        d = (x - y).abs()
        if rows is not None:
            d = d[rows]
        if d.numel():
            err = max(err, int(d.max()))

    for key in _LANE_KEYS:
        hold(lane_rows(ca, key), lane_rows(cb, key))
    status = lane_rows(ca, "status")[:, 0]
    resumable = torch.isin(status, torch.tensor(_RESUMABLE, device=dev))
    for key in (*ST_KEYS, "lens_pk", *ib.CHUNK_KEYS):
        if key not in _LANE_KEYS:
            hold(lane_rows(ca, key), lane_rows(cb, key), resumable)
    (ta, na), (tb, nb) = (compact_tokens([(t.to(dev), rows) for t, rows in p])
                          for p in (pa, pb))
    hold(na, nb)
    width = max(ta.shape[1], tb.shape[1])
    hold(F.pad(ta, (0, width - ta.shape[1])),
         F.pad(tb, (0, width - tb.shape[1])))
    return err
