"""Host reference inflate engine (the framework's oracle); the port's own
copy of ``defl_tpu/core/oracle.py``.

A single resumable DEFLATE/zlib decoder that backs all three host entry
points of the reference API surface — one-shot (`infl`,
the reference's `src/infl/infl.c:1507-1675`), non-contiguous chunked input
(`infl_include`, `mem.c:114-216`), and byte-granular streaming
(`infl_stream`, `stream.c:468-794`).  Where the reference implements three
specialised C decode paths plus a hand-rolled resumable state machine, this
engine is one Python generator: every point at which the C code can return
``UNZ_UNFINISHED`` or ``UNZ_EFULL`` is a ``yield`` here, which gives the
same byte-granular resumability (including resuming mid back-reference copy
and mid codelen-repeat, `stream.c:714-744`) for free.

This code is the correctness oracle that the device path
(``defl_tpu_torch.ops``) and the C++ host engine are tested against, alongside
CPython's zlib.

Reference behavioural parity notes:
- zlib header rules: CM==8, CINFO<=7, (CMF<<8|FLG)%31==0 (zlib.h:70-86).
- FDICT streams are rejected with ERR unless a dictionary is supplied
  (zlib.h:88-93; dictionary support itself is a north-star extension).
- The adler32 trailer is NOT verified unless FLAG_VERIFY_ADLER32 is set
  (the reference has no adler code at all); decode stops at the final
  block's end-of-block symbol.
- Output overflow yields EFULL mid-copy; `resize_output` then continuing
  resumes exactly where it stopped (infl.h:50-58, stream.c:57-65).
- `input_pos` counts whole consumed bytes, treating a partially consumed
  byte as consumed (infl.h:180-184, mem.c:296-329).
"""

from __future__ import annotations

from defl_tpu_torch.constants import (
    BTYPE_DYNAMIC,
    BTYPE_FIXED,
    BTYPE_STORED,
    CODELEN_ORDER,
    DIST_BASE,
    DIST_EXTRA,
    FIXED_DIST_LENGTHS,
    FIXED_LITLEN_LENGTHS,
    LENGTH_BASE,
    LENGTH_EXTRA,
    MAX_CODELEN_CODES,
    ZLIB_CM_DEFLATE,
    ZLIB_FLAG_FDICT,
    ZLIB_MAX_CINFO,
)
from defl_tpu_torch.core import huffman
from defl_tpu_torch.core.checksums import adler32 as _adler32
from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result


class _ChunkBitReader:
    """LSB-first bit reader over a list of byte chunks.

    Chunk-seam handling is the host analog of the reference's REFILL
    crossing the chunk linked list (infl.c:1121-1127): `_pull_byte` simply
    advances ``(chunk_index, offset)`` through ``chunks``.
    """

    __slots__ = ("chunks", "ci", "off", "bitbuf", "nbits")

    def __init__(self):
        self.chunks: list[bytes] = []
        self.ci = 0
        self.off = 0
        self.bitbuf = 0
        self.nbits = 0

    def append(self, data: bytes):
        if data:
            self.chunks.append(data)

    def _pull_byte(self) -> int:
        while self.ci < len(self.chunks):
            c = self.chunks[self.ci]
            if self.off < len(c):
                b = c[self.off]
                self.off += 1
                return b
            self.ci += 1
            self.off = 0
        return -1

    def try_fill(self, n: int) -> bool:
        """Ensure >= n bits buffered (n <= 57). False if input exhausted."""
        while self.nbits < n:
            b = self._pull_byte()
            if b < 0:
                return False
            self.bitbuf |= b << self.nbits
            self.nbits += 8
        return True

    def peek(self, n: int) -> int:
        return self.bitbuf & ((1 << n) - 1)

    def drop(self, n: int):
        self.bitbuf >>= n
        self.nbits -= n

    def take(self, n: int) -> int:
        v = self.bitbuf & ((1 << n) - 1)
        self.drop(n)
        return v

    def align_byte(self):
        self.drop(self.nbits & 7)

    def take_aligned_bytes(self, n: int) -> bytes:
        """Bulk byte read; requires byte alignment (nbits % 8 == 0).

        Drains buffered whole bytes first, then slices chunks directly —
        the host analog of the reference's chunk-aware bulk stored copy
        (infl_raw, infl.c:1443-1496)."""
        res = bytearray()
        while n and self.nbits:
            res.append(self.bitbuf & 0xFF)
            self.drop(8)
            n -= 1
        while n and self.ci < len(self.chunks):
            c = self.chunks[self.ci]
            avail = len(c) - self.off
            if avail == 0:
                self.ci += 1
                self.off = 0
                continue
            take = avail if avail < n else n
            res += c[self.off : self.off + take]
            self.off += take
            n -= take
        return bytes(res)

    @property
    def whole_bytes_pulled(self) -> int:
        total = sum(len(self.chunks[i]) for i in range(self.ci))
        return total + self.off

    def consumed_bytes(self) -> int:
        """Reference input_pos semantics (infl.h:180-184): whole unread
        bytes sitting in the bit buffer don't count; a partially consumed
        byte counts as consumed."""
        pulled = self.whole_bytes_pulled
        unread_whole = self.nbits // 8
        # pulled minus whole buffered bytes; a partially consumed byte is
        # naturally included because only whole bytes are subtracted.
        return pulled - unread_whole


class InflateEngine:
    """Resumable inflate over a growable chunk list and bounded output."""

    def __init__(self, dst_capacity: int, flags: int = FLAG_ZLIB,
                 dictionary: bytes | None = None):
        self.flags = flags
        self.capacity = int(dst_capacity)
        self.dictionary = bytes(dictionary) if dictionary else b""
        self.out = bytearray()
        self.reader = _ChunkBitReader()
        self._gen = self._run()
        self._finished: Result | None = None
        self._started = False
        self._input_pos_override: int | None = None

    # -- input management (≙ infl_include, mem.c:114-216) --------------------
    def include(self, data) -> Result:
        if self._finished is not None and self._finished is not Result.EFULL:
            return Result.EPERM
        self.reader.append(bytes(data))
        return Result.OK

    def resize_output(self, new_capacity: int) -> Result:
        """≙ infl_resize_output (mem.c:277-288): grow/swap the output
        buffer after EFULL without resetting decode state."""
        if new_capacity < len(self.out):
            return Result.EPERM
        self.capacity = int(new_capacity)
        if self._finished is Result.EFULL:
            self._finished = None
        return Result.OK

    @property
    def output_pos(self) -> int:
        return len(self.out)

    @property
    def input_pos(self) -> int:
        if self._input_pos_override is not None:
            return self._input_pos_override
        return self.reader.consumed_bytes()

    def adopt_native_result(self, out: bytes, in_pos: int) -> None:
        """Install a completed decode produced by the C++ fast path
        (api.InflateStream.run routes fresh contiguous one-shot decodes
        through dt_inflate_pos, ≙ infl_buf being the reference's fastest
        path, infl.h:125-145).  Only ever called on a fresh engine with a
        successful (OK) result; resumable and error cases stay on the
        generator."""
        if self._started or self._finished is not None:
            raise RuntimeError("adopt_native_result needs a fresh engine")
        self.out.extend(out)
        self._input_pos_override = int(in_pos)
        self._finished = Result.OK
        self._started = True

    # -- decode loop ---------------------------------------------------------
    def step(self) -> Result:
        """Advance until completion, input exhaustion, or output full."""
        if self._finished is not None:
            return self._finished
        self._started = True
        try:
            r = next(self._gen)
        except StopIteration as stop:  # pragma: no cover - defensive
            r = stop.value if stop.value is not None else Result.ERR
        r = Result(r)
        if r in (Result.OK, Result.ERR, Result.EFOUND, Result.EFULL):
            self._finished = r
        return r

    # -- generator helpers ---------------------------------------------------
    def _need(self, n: int):
        while not self.reader.try_fill(n):
            yield Result.UNFINISHED

    def _emit(self, b: int):
        while len(self.out) >= self.capacity:
            yield Result.EFULL
        self.out.append(b)

    # -- the decoder ---------------------------------------------------------
    def _run(self):
        r = self.reader
        out = self.out

        if self.flags & FLAG_ZLIB:
            yield from self._need(16)
            cmf = r.take(8)
            flg = r.take(8)
            cm = cmf & 0xF
            cinfo = cmf >> 4
            if cm != ZLIB_CM_DEFLATE or cinfo > ZLIB_MAX_CINFO:
                return Result.ERR
            if ((cmf << 8) | flg) % 31 != 0:
                return Result.ERR
            if flg & ZLIB_FLAG_FDICT:
                if not self.dictionary:
                    return Result.ERR  # reference parity (zlib.h:88-93)
                yield from self._need(32)
                r.take(32)  # DICTID; accepted as-is (extension)

        # The LZ77 window: dictionary bytes conceptually precede the output.
        dict_ = self.dictionary
        dlen = len(dict_)

        while True:
            yield from self._need(3)
            bfinal = r.take(1)
            btype = r.take(2)

            if btype == BTYPE_STORED:
                r.align_byte()
                yield from self._need(32)
                length = r.take(16)
                nlen = r.take(16)
                if length != (~nlen & 0xFFFF):
                    return Result.ERR
                remaining = length
                while remaining:
                    space = self.capacity - len(out)
                    if space == 0:
                        yield Result.EFULL
                        continue
                    got = r.take_aligned_bytes(min(remaining, space))
                    if not got:
                        yield Result.UNFINISHED
                        continue
                    out.extend(got)
                    remaining -= len(got)

            elif btype in (BTYPE_FIXED, BTYPE_DYNAMIC):
                if btype == BTYPE_FIXED:
                    lit = _FIXED_LITLEN
                    dst = _FIXED_DIST
                else:
                    res = yield from self._dynamic_header()
                    if isinstance(res, Result):
                        return res
                    lit, dst = res

                while True:
                    sym = yield from self._decode_symbol(lit)
                    if sym < 0:
                        return Result.ERR
                    if sym < 256:
                        if len(out) < self.capacity:
                            out.append(sym)
                        else:
                            yield from self._emit(sym)
                        continue
                    if sym == 256:
                        break
                    if sym > 285:
                        return Result.ERR
                    eb = LENGTH_EXTRA[sym - 257]
                    yield from self._need(eb)
                    length = LENGTH_BASE[sym - 257] + (r.take(eb) if eb else 0)

                    dsym = yield from self._decode_symbol(dst)
                    if dsym < 0 or dsym > 29:
                        return Result.ERR
                    eb = DIST_EXTRA[dsym]
                    yield from self._need(eb)
                    dist = DIST_BASE[dsym] + (r.take(eb) if eb else 0)
                    # distance must not reach past start of (dict + output)
                    # (reference check at infl.c:1286)
                    if dist > len(out) + dlen:
                        return Result.ERR
                    remaining = length
                    while remaining:
                        space = self.capacity - len(out)
                        if space == 0:
                            yield Result.EFULL
                            continue
                        n = min(remaining, space)
                        start = len(out) - dist
                        if start < 0:
                            # Source (partially) inside the preset dictionary.
                            take = min(n, -start)
                            out.extend(dict_[dlen + start : dlen + start + take])
                            remaining -= take
                            continue
                        if n <= dist:
                            out.extend(out[start : start + n])
                        else:
                            # Overlapping copy: the last `dist` bytes repeat.
                            pat = bytes(out[start : start + dist])
                            reps, tail = divmod(n, dist)
                            out.extend(pat * reps)
                            out.extend(pat[:tail])
                        remaining -= n
            else:
                return Result.ERR

            if bfinal:
                break

        if (self.flags & FLAG_ZLIB) and (self.flags & FLAG_VERIFY_ADLER32):
            r.align_byte()
            yield from self._need(32)
            stored = 0
            for _ in range(4):  # big-endian trailer
                stored = (stored << 8) | r.take(8)
            if stored != _adler32(bytes(out)):
                return Result.ERR
        return Result.OK

    def _decode_symbol(self, code: huffman.CanonicalCode):
        """Canonical decode, one length at a time (MSB-first compare form) —
        the same algorithm the device kernel vectorises."""
        r = self.reader
        first, cnt, off_, syms = _py_tables(code)
        if r.try_fill(code.max_len):
            # Fast path: enough bits buffered, no resumption needed.
            buf = r.bitbuf
            cand = 0
            for l in range(1, code.max_len + 1):
                cand = (cand << 1) | ((buf >> (l - 1)) & 1)
                off = cand - first[l]
                if 0 <= off < cnt[l]:
                    r.drop(l)
                    return syms[off_[l] + off]
            return -1
        # Slow path: near end of input — extend bit by bit, resumable.
        cand = 0
        for l in range(1, code.max_len + 1):
            yield from self._need(l)
            cand = (cand << 1) | ((r.bitbuf >> (l - 1)) & 1)
            off = cand - first[l]
            if 0 <= off < cnt[l]:
                r.drop(l)
                return syms[off_[l] + off]
        return -1

    def _dynamic_header(self):
        """Parse a dynamic block header (RFC 1951 §3.2.7).

        ≙ infl_ft_dynamic (infl.c:903-1000) / streaming variant
        (stream.c:630-776).  Resumable at every bit read.
        """
        r = self.reader
        yield from self._need(14)
        hlit = r.take(5) + 257
        hdist = r.take(5) + 1
        hclen = r.take(4) + 4
        if hlit > 286 or hdist > 30:
            return Result.ERR

        cl_lens = [0] * MAX_CODELEN_CODES
        for i in range(hclen):
            yield from self._need(3)
            cl_lens[CODELEN_ORDER[i]] = r.take(3)
        cl_code = huffman.build_decode(cl_lens)
        if cl_code is None or cl_code.num_symbols == 0:
            return Result.ERR

        lens = [0] * (hlit + hdist)
        i = 0
        prev = 0
        while i < hlit + hdist:
            sym = yield from self._decode_symbol(cl_code)
            if sym < 0:
                return Result.ERR
            if sym < 16:
                lens[i] = sym
                prev = sym
                i += 1
            elif sym == 16:
                if i == 0:
                    return Result.ERR
                yield from self._need(2)
                rep = 3 + r.take(2)
                if i + rep > hlit + hdist:
                    return Result.ERR
                for _ in range(rep):
                    lens[i] = prev
                    i += 1
            elif sym == 17:
                yield from self._need(3)
                rep = 3 + r.take(3)
                if i + rep > hlit + hdist:
                    return Result.ERR
                i += rep
                prev = 0
            else:  # 18
                yield from self._need(7)
                rep = 11 + r.take(7)
                if i + rep > hlit + hdist:
                    return Result.ERR
                i += rep
                prev = 0

        if lens[256] == 0:
            return Result.ERR  # a block must have a real EOB code
        lit = huffman.build_decode(lens[:hlit])
        dst = huffman.build_decode(lens[hlit:])
        if lit is None or dst is None:
            return Result.ERR
        return lit, dst


def _py_tables(code: huffman.CanonicalCode):
    """Cache plain-Python list views of a CanonicalCode (NumPy scalar
    indexing is too slow for the per-symbol hot loop)."""
    cached = getattr(code, "_py_cache", None)
    if cached is None:
        cached = (
            code.first_code.tolist(),
            code.count.tolist(),
            code.offset.tolist(),
            code.sorted_syms.tolist(),
        )
        code._py_cache = cached
    return cached


_FIXED_LITLEN = huffman.build_decode(FIXED_LITLEN_LENGTHS)
_FIXED_DIST = huffman.build_decode(FIXED_DIST_LENGTHS)


def inflate_oracle(data: bytes, flags: int = FLAG_ZLIB,
                   dst_capacity: int | None = None,
                   dictionary: bytes | None = None) -> tuple[Result, bytes]:
    """One-shot oracle inflate (≙ infl_buf, include/defl/infl.h:125-145).

    With ``dst_capacity=None`` the output grows as needed (capacity doubles
    on EFULL, using the same resize-and-continue protocol user code would).
    """
    grow = dst_capacity is None
    cap = 1 << 16 if grow else dst_capacity
    eng = InflateEngine(cap, flags, dictionary)
    eng.include(data)
    while True:
        res = eng.step()
        if res is Result.EFULL and grow:
            eng.resize_output(max(eng.capacity * 2, 1))
            continue
        # Truncated input surfaces as UNFINISHED, matching the reference's
        # one-shot infl() behaviour on exhausted chunk lists.
        return res, bytes(eng.out)
