"""ctypes bindings for the port's C++ host engine (csrc/defl_host.cc, a
copy of the JAX package's, with the batched entries of csrc/defl_batch.cc).

Counterpart of ``defl_tpu/runtime/native.py``.  The library builds with
g++ at first use from ``csrc/defl_batch.cc``, which includes the engine,
into ``csrc/build/``, named by a hash of every C++ source there, so an
edited source builds anew and a stale library is never loaded.  A
failed build raises with g++'s own message: the port has no resolver or
host engine to carry on with instead.

Every entry point of the library is bound, under the names of the JAX
package's bindings; ``get_lib`` and ``available`` are that package's
names for the loader, and neither returns or answers around a failed
build.  Out buffers are checked and refused with ``ValueError``.
``native_deflate_fields`` hands each call a pinned
buffer of its own (PyTorch's caching host allocator keeps the pages for
the next call), so concurrent encodes never share field storage.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

from defl_tpu_torch.errors import Result

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(_CSRC, "build")
#: the one translation unit g++ builds; it includes ``defl_host.cc``
SOURCE = "defl_batch.cc"
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
#: wall seconds of this process's g++ build; 0.0 when the library was
#: already there
build_seconds = 0.0

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i64p = ctypes.POINTER(ctypes.c_int64)
_pptr = ctypes.POINTER(ctypes.c_void_p)


def lib_path() -> str:
    h = hashlib.sha256()
    for name in sorted(n for n in os.listdir(_CSRC) if n.endswith(".cc")):
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(_BUILD, f"libdefl_host_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    global build_seconds
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, "-o", tmp, os.path.join(_CSRC, SOURCE)]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found; the host engine builds from "
                           f"csrc/{SOURCE} at first use") from e
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed ({r.returncode}):\n{' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees a partial
    build_seconds = time.perf_counter() - t0


def load():
    """The loaded library, building it first if needed; raises when the
    build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.dt_adler32.restype = ctypes.c_uint32
        lib.dt_adler32.argtypes = [_u8p, ctypes.c_uint64, ctypes.c_uint32]
        lib.dt_resolve_tokens.restype = ctypes.c_int
        lib.dt_resolve_tokens.argtypes = [
            _u32p, ctypes.c_int64, ctypes.c_int64,
            _u8p, ctypes.c_uint64, ctypes.c_int64,
            _u8p, ctypes.c_uint64, ctypes.c_uint64,
            _i32p, _i32p, _u8p, ctypes.c_uint32, ctypes.c_int]
        lib.dt_crc32.restype = ctypes.c_uint32
        lib.dt_crc32.argtypes = [_u8p, ctypes.c_uint64, ctypes.c_uint32]
        lib.dt_inflate.restype = ctypes.c_int
        lib.dt_inflate.argtypes = [_u8p, ctypes.c_uint64, _u8p,
                                   ctypes.c_uint64, _u64p, ctypes.c_int]
        lib.dt_inflate_pos.restype = ctypes.c_int
        lib.dt_inflate_pos.argtypes = [_u8p, ctypes.c_uint64, _u8p,
                                       ctypes.c_uint64, _u64p, _u64p,
                                       ctypes.c_int]
        lib.dt_deflate.restype = ctypes.c_int
        lib.dt_deflate.argtypes = [_u8p, ctypes.c_uint64, _u8p,
                                   ctypes.c_uint64, _u64p, ctypes.c_int,
                                   ctypes.c_int]
        lib.dt_inflate_batch.restype = ctypes.c_int
        lib.dt_inflate_batch.argtypes = [
            _pptr, _u64p, _pptr, _u64p, _u64p, _i32p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int]
        lib.dt_deflate_batch.restype = ctypes.c_int
        lib.dt_deflate_batch.argtypes = [
            _pptr, _u64p, _pptr, _u64p, _u64p, _i32p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.dt_find_block_start.restype = ctypes.c_int64
        lib.dt_find_block_start.argtypes = [_u8p, ctypes.c_uint64,
                                            ctypes.c_int64, ctypes.c_int64]
        lib.dt_find_block_starts.restype = None
        lib.dt_find_block_starts.argtypes = [
            _u8p, _i64p, _i64p, _i64p, _i64p, ctypes.c_int64, _i64p,
            ctypes.c_int]
        lib.dt_inflate_span.restype = ctypes.c_int
        lib.dt_inflate_span.argtypes = [
            _u8p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
            _u8p, ctypes.c_uint64, ctypes.c_uint64, _u64p, _i64p]
        lib.dt_stitch.restype = ctypes.c_int
        lib.dt_stitch.argtypes = [
            _u8p, ctypes.c_uint64, _i64p, ctypes.c_int64,
            _u32p, ctypes.c_int64, _i32p, _i32p, _i32p, _i64p,
            _u8p, ctypes.c_uint64, _u64p, _i64p]
        lib.dt_stitch_many.restype = None
        lib.dt_stitch_many.argtypes = [
            _u8p, _i64p, _i64p, _i64p, _i64p, ctypes.c_int64, _i64p,
            _u32p, ctypes.c_int64, _i32p, _i32p, _i32p, _i64p, _pptr, _u64p,
            _i32p, _u64p, _i64p, _i32p, ctypes.c_int]
        lib.dt_deflate_fields_batch.restype = ctypes.c_int
        lib.dt_deflate_fields_batch.argtypes = [
            _pptr, _u64p, _u32p, ctypes.c_int64, _i64p, _i64p, _u32p, _i32p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.dt_encode_compact.restype = ctypes.c_int
        lib.dt_encode_compact.argtypes = [
            _u32p, _u32p, ctypes.c_int64, ctypes.c_int64, _i64p, _u32p,
            _pptr, _u64p, _u64p, ctypes.c_int]
        lib.dt_inflate_large.restype = ctypes.c_int
        lib.dt_inflate_large.argtypes = [
            _u8p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int,
            _u8p, ctypes.c_uint64, _u64p, _i64p, _pptr]
        lib.dt_large_free.restype = None
        lib.dt_large_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def get_lib():
    """The loaded library (the JAX package's name for ``load``).  Unlike
    that package's, it never returns None: a build that fails raises with
    g++'s message, and so does a missing g++ or source (``available``
    asks first)."""
    return load()


def available() -> bool:
    """Whether the library is there to load: False only when its source
    or g++ is absent, so that nothing can build it.  A source that does
    not compile is no answer of False: the build runs and raises, as
    ``load`` does (a swallowed build failure would hide a broken engine
    behind the callers' slower paths)."""
    if _lib is None:
        if not os.path.exists(os.path.join(_CSRC, SOURCE)):
            return False
        if not os.path.exists(lib_path()) and shutil.which("g++") is None:
            return False
    load()
    return True


def _default_threads() -> int:
    return min(16, os.cpu_count() or 1)


def _u8(buf):
    return (ctypes.c_uint8 * len(buf)).from_buffer_copy(bytes(buf)) \
        if len(buf) else (ctypes.c_uint8 * 1)()


def native_resolve_tokens(tokens, input_words, dst_len, C: int,
                          dictionary: bytes | None = None,
                          n_threads: int | None = None,
                          out=None, dst_start=None):
    """Multithreaded pass-2 token resolution (device decode + host resolve).

    tokens: uint32 [N, T] C-contiguous (lane-major);
    input_words: the packed uint32 [N, W] input (stored-run source bytes);
    dst_len: int32 [N].  Returns uint8 [N, C].

    For incremental streaming resolve, pass `out` preloaded with each
    lane's prior window bytes in out[i, :dst_start[i]]; resolution starts
    at dst_start and back-references read the preloaded prefix.
    """
    lib = load()
    tokens = np.ascontiguousarray(tokens, dtype=np.uint32)
    inputs = np.ascontiguousarray(input_words, dtype=np.uint32)
    dst_len = np.ascontiguousarray(dst_len, dtype=np.int32)
    N, T = tokens.shape
    if out is None:
        out = np.zeros((N, C), dtype=np.uint8)
    elif not (isinstance(out, np.ndarray) and out.shape == (N, C)
              and out.dtype == np.uint8 and out.flags.c_contiguous
              and out.flags.writeable):
        raise ValueError(f"out must be a writable C-contiguous uint8 "
                         f"[{N}, {C}] array")
    if dst_start is not None:
        dst_start = np.ascontiguousarray(dst_start, dtype=np.int32)
        start_p = dst_start.ctypes.data_as(_i32p)
    else:
        start_p = ctypes.cast(None, _i32p)
    d = bytes(dictionary) if dictionary else b""
    lib.dt_resolve_tokens(
        tokens.ctypes.data_as(_u32p), N, T,
        inputs.ctypes.data_as(_u8p), inputs.strides[0], inputs.strides[0],
        out.ctypes.data_as(_u8p), C, C,
        dst_len.ctypes.data_as(_i32p), start_p,
        _u8(d), len(d),
        _default_threads() if n_threads is None else n_threads)
    return out


def _threads(n_threads) -> int:
    return _default_threads() if n_threads is None else int(n_threads)


def _out_u8(out, what: str = "out"):
    """A caller-owned output buffer as (pointer, size); refuses what the
    library cannot write into."""
    if not (isinstance(out, np.ndarray) and out.dtype == np.uint8
            and out.ndim == 1 and out.flags.c_contiguous
            and out.flags.writeable):
        raise ValueError(f"{what} must be a writable C-contiguous 1-D uint8 "
                         f"array")
    return out.ctypes.data_as(_u8p), out.size


def _in_u8(body):
    """A read-only uint8 ndarray as a pointer (no copy)."""
    if not (isinstance(body, np.ndarray) and body.dtype == np.uint8
            and body.ndim == 1 and body.flags.c_contiguous):
        raise ValueError("body must be a C-contiguous 1-D uint8 array")
    return ctypes.cast(body.ctypes.data, _u8p)


def native_inflate(data: bytes, dst_capacity: int, flags: int = 1,
                   out=None):
    """One-shot native inflate; (Result, output).

    With ``out`` (a writable uint8 ndarray, the caller-owned output
    buffer, ≙ the reference's ``infl_init(dst, dstlen)`` contract) the
    decode writes in place and returns (Result, bytes_written) with no
    copy and no allocation."""
    lib = load()
    src = _u8(data)
    outlen = ctypes.c_uint64(0)
    if out is not None:
        ptr, size = _out_u8(out)
        cap = min(int(dst_capacity), size)
        r = lib.dt_inflate(src, len(data), ptr, cap, ctypes.byref(outlen),
                           flags)
        return Result(r), int(outlen.value)
    dst = (ctypes.c_uint8 * max(dst_capacity, 1))()
    r = lib.dt_inflate(src, len(data), dst, dst_capacity,
                       ctypes.byref(outlen), flags)
    return Result(r), ctypes.string_at(dst, outlen.value)


def native_inflate_pos(data: bytes, dst_capacity: int,
                       flags: int = 1) -> tuple[Result, bytes, int]:
    """One-shot native inflate reporting the consumed input position
    (reference infl_input_pos semantics); (Result, output, in_pos)."""
    lib = load()
    src = _u8(data)
    dst = (ctypes.c_uint8 * max(dst_capacity, 1))()
    outlen = ctypes.c_uint64(0)
    in_pos = ctypes.c_uint64(0)
    r = lib.dt_inflate_pos(src, len(data), dst, dst_capacity,
                           ctypes.byref(outlen), ctypes.byref(in_pos), flags)
    return Result(r), ctypes.string_at(dst, outlen.value), int(in_pos.value)


def native_deflate(data: bytes, level: int = 6, flags: int = 1) -> bytes:
    lib = load()
    src = _u8(data)
    cap = len(data) + len(data) // 2 + 1024
    dst = (ctypes.c_uint8 * cap)()
    outlen = ctypes.c_uint64(0)
    r = lib.dt_deflate(src, len(data), dst, cap, ctypes.byref(outlen),
                       level, flags)
    if r != 0:
        raise RuntimeError(f"native deflate failed: {Result(r).name}")
    return ctypes.string_at(dst, outlen.value)


def _src_arrays(payloads):
    """payloads -> (keepalive arrays, pointer array, length array)."""
    n = len(payloads)
    srcs = [np.frombuffer(bytes(p), np.uint8) if len(p) else
            np.zeros(1, np.uint8) for p in payloads]
    ptrs = (ctypes.c_void_p * n)(*[s.ctypes.data for s in srcs])
    lens = (ctypes.c_uint64 * n)(*[len(p) for p in payloads])
    return srcs, ptrs, lens


def _batch_call(fn, payloads, caps, *extra, n_threads=None):
    n = len(payloads)
    srcs, src_ptrs, srclens = _src_arrays(payloads)
    dsts = [np.zeros(max(c, 1), np.uint8) for c in caps]
    dst_ptrs = (ctypes.c_void_p * n)(*[d.ctypes.data for d in dsts])
    dstcaps = (ctypes.c_uint64 * n)(*[len(d) for d in dsts])
    dstlens = (ctypes.c_uint64 * n)()
    results = (ctypes.c_int32 * n)()
    fn(src_ptrs, srclens, dst_ptrs, dstcaps, dstlens, results, n, *extra,
       _threads(n_threads))
    del srcs
    outs = [dsts[i][: dstlens[i]].tobytes() for i in range(n)]
    return [Result(int(r)) for r in results], outs


def native_deflate_batch(payloads, level: int = 6, flags: int = 1,
                         n_threads=None):
    """Multithreaded batch compress; (list of Result, list of bytes)."""
    caps = [len(p) + len(p) // 2 + 1024 for p in payloads]
    return _batch_call(load().dt_deflate_batch, payloads, caps, level, flags,
                       n_threads=n_threads)


def native_inflate_batch(payloads, dst_capacities, flags: int = 1,
                         n_threads=None):
    """Multithreaded batch host inflate; (list of Result, list of bytes)."""
    caps = ([int(dst_capacities)] * len(payloads)
            if isinstance(dst_capacities, int) else list(dst_capacities))
    return _batch_call(load().dt_inflate_batch, payloads, caps, flags,
                       n_threads=n_threads)


def fields_width(payloads) -> int:
    """The field budget F of a batch: one field per input byte at worst
    (all literals, or stored) plus the block headers, in multiples of
    8192 (rows past ``n_fields`` are never read)."""
    worst = max((len(p) for p in payloads), default=0) + 512
    return max(1024, -(-worst // 8192) * 8192)


def native_deflate_fields(payloads, level: int = 6, F: int | None = None,
                          n_threads=None, pin: bool = False):
    """Host half of the hybrid encode (dt_deflate_fields_batch): LZ77
    matching, Huffman trees and block layout per payload, exported as
    (value, nbits) field arrays for the bit-pack on the card
    (ops/huffman_pack.py).

    Returns (fields u32 [N, F], n_fields i64 [N], total_bits i64 [N],
    adlers u32 [N], results); results[i] is EFULL when payload i
    overflowed F (that lane goes to the serial encoder).

    ``fields`` is this call's own buffer.  With ``pin`` it is page-locked
    memory from PyTorch's caching host allocator: the upload can be
    asynchronous, and a later call reuses the pages instead of faulting
    fresh ones in.  The array keeps the buffer alive.
    """
    lib = load()
    n = len(payloads)
    if F is None:
        F = fields_width(payloads)
    if pin:
        import torch

        fields = torch.empty((n, F), dtype=torch.int32,
                             pin_memory=True).numpy().view(np.uint32)
    else:
        fields = np.empty((n, F), np.uint32)
    n_fields = np.zeros(n, np.int64)
    total_bits = np.zeros(n, np.int64)
    adlers = np.zeros(n, np.uint32)
    results = (ctypes.c_int32 * n)()
    srcs, src_ptrs, srclens = _src_arrays(payloads)
    lib.dt_deflate_fields_batch(
        src_ptrs, srclens, fields.ctypes.data_as(_u32p), F,
        n_fields.ctypes.data_as(_i64p), total_bits.ctypes.data_as(_i64p),
        adlers.ctypes.data_as(_u32p), results, n, level, _threads(n_threads))
    del srcs
    return (fields, n_fields, total_bits, adlers,
            [Result(int(r)) for r in results])


def native_encode_compact(fields, slots, n_fields, final_lo, total_bits,
                          n_threads=None):
    """Gather the used word slots of the lockstep pack into dense per-lane
    compressed bodies (dt_encode_compact).  Returns a list of bytes (raw
    deflate bodies, no zlib framing)."""
    lib = load()
    fields = np.ascontiguousarray(fields, dtype=np.uint32)
    slots = np.ascontiguousarray(slots, dtype=np.uint32)
    n_fields = np.ascontiguousarray(n_fields, dtype=np.int64)
    final_lo = np.ascontiguousarray(final_lo, dtype=np.uint32)
    N, F = fields.shape
    if slots.shape != (N, F) or n_fields.shape != (N,) \
            or final_lo.shape != (N,) or len(total_bits) != N:
        raise ValueError(f"slots must be [{N}, {F}] and n_fields, final_lo, "
                         f"total_bits [{N}]")
    caps = [(int(tb) + 7) // 8 for tb in total_bits]
    dsts = [np.empty(max(c, 1), np.uint8) for c in caps]
    dst_ptrs = (ctypes.c_void_p * N)(*[d.ctypes.data for d in dsts])
    dstcaps = (ctypes.c_uint64 * N)(*[len(d) for d in dsts])
    dstlens = (ctypes.c_uint64 * N)()
    r = lib.dt_encode_compact(
        fields.ctypes.data_as(_u32p), slots.ctypes.data_as(_u32p), N, F,
        n_fields.ctypes.data_as(_i64p), final_lo.ctypes.data_as(_u32p),
        dst_ptrs, dstcaps, dstlens, _threads(n_threads))
    if r != 0:
        raise RuntimeError("encode compact overflow")
    return [dsts[i][: dstlens[i]].tobytes() for i in range(N)]


def _u8_view(data):
    """(pointer, length, keepalive) of an ndarray's bytes, without a copy
    when it is contiguous, or of bytes-like data."""
    if isinstance(data, np.ndarray):
        a = np.ascontiguousarray(data.reshape(-1).view(np.uint8))
        return ctypes.cast(a.ctypes.data, _u8p), a.size, a
    b = bytes(data)
    return _u8(b), len(b), b


def native_adler32(data, start: int = 1) -> int:
    """adler32 of bytes-like data or of an ndarray's bytes."""
    p, n, keep = _u8_view(data)
    return int(load().dt_adler32(p, n, start))


def native_crc32(data, start: int = 0) -> int:
    """crc32 of bytes-like data or of an ndarray's bytes."""
    p, n, keep = _u8_view(data)
    return int(load().dt_crc32(p, n, start))


# ---- speculative large-stream helpers (runtime/large.py) ------------------

def find_block_start(lib, body, bit_lo: int, bit_hi: int) -> int:
    """First validated dynamic-block header bit offset in [bit_lo, bit_hi)
    of ``body`` (uint8 ndarray), or -1."""
    return int(lib.dt_find_block_start(_in_u8(body), body.size,
                                       bit_lo, bit_hi))


def find_args(body_bytes: int, offs, lens, lo, hi) -> list[np.ndarray]:
    """Many finds' arguments as four int64 [n] arrays (offs, lens, lo,
    hi), each stream inside a body of ``body_bytes``; raises ValueError
    otherwise."""
    args = [np.ascontiguousarray(a, dtype=np.int64)
            for a in (offs, lens, lo, hi)]
    n = args[0].size
    if any(a.shape != (n,) for a in args):
        raise ValueError("offs, lens, lo and hi must be [n] each")
    if n and (int(args[0].min()) < 0 or int(args[1].min()) < 0
              or int((args[0] + args[1]).max()) > body_bytes):
        raise ValueError("a stream lies outside the body")
    return args


def find_block_starts(lib, body, offs, lens, lo, hi,
                      n_threads: int | None = None) -> np.ndarray:
    """Many finds in one call, on ``n_threads`` native threads: find k
    looks between bits ``lo[k]`` and ``hi[k]`` of the stream of ``lens[k]``
    bytes at byte ``offs[k]`` of ``body`` (uint8 ndarray), and reads
    nothing outside it.  Returns int64 [n]: each find's bit offset in its
    own stream, or -1, as ``find_block_start``."""
    args = find_args(body.size, offs, lens, lo, hi)
    n = args[0].size
    out = np.empty(n, np.int64)
    lib.dt_find_block_starts(_in_u8(body), *(a.ctypes.data_as(_i64p)
                                             for a in args),
                             n, out.ctypes.data_as(_i64p), _threads(n_threads))
    return out


def inflate_span(lib, body, bit_start: int, bit_limit: int, out, out_pos: int):
    """Serial raw-deflate decode from an arbitrary bit position with
    out[:out_pos] as the back-reference window; stops at the first block
    boundary at/after bit_limit or after the final block.

    Returns (Result, new_out_pos, end_bit); end_bit < 0 encodes "final
    block consumed" as -(bit + 1)."""
    ptr, size = _out_u8(out)
    dl = ctypes.c_uint64(out_pos)
    eb = ctypes.c_int64(bit_start)
    r = lib.dt_inflate_span(_in_u8(body), body.size, bit_start, bit_limit,
                            ptr, size, out_pos, ctypes.byref(dl),
                            ctypes.byref(eb))
    return Result(r), int(dl.value), int(eb.value)


def resolve_tokens_into(lib, lane_tokens, lane_input, out, start: int,
                        end: int) -> None:
    """Resolve one lane's token stream into out[start:end) with
    out[:start] as its back-reference window (segment chaining).
    lane_input: the lane's compressed bytes (stored-run source), any
    dtype, read as raw bytes at the lane's token-offset base."""
    ptr, size = _out_u8(out)
    if not 0 <= start <= end <= size:
        raise ValueError(f"[{start}, {end}) does not lie in out "
                         f"({size} bytes)")
    toks = np.ascontiguousarray(lane_tokens, dtype=np.uint32)
    inp = np.ascontiguousarray(lane_input)
    dst_len = np.array([end], np.int32)
    dst_start = np.array([start], np.int32)
    lib.dt_resolve_tokens(
        toks.ctypes.data_as(_u32p), 1, toks.size,
        ctypes.cast(inp.ctypes.data, _u8p), 0, inp.nbytes,
        ptr, 0, size, dst_len.ctypes.data_as(_i32p),
        dst_start.ctypes.data_as(_i32p), ctypes.cast(None, _u8p), 0, 1)


def inflate_large_parallel(lib, body, out, seg_bytes: int = 16384,
                           n_threads: int | None = None, state=None):
    """Parallel large-stream inflate (dt_inflate_large): worker threads
    find block boundaries and token-decode their segments while the
    calling thread stitches and resolves behind them.

    body: uint8 ndarray of the raw-deflate body; out: uint8 output array.
    Returns (Result, total_bytes, end_bit, state).  On EFULL, grow ``out``
    and call again passing ``state`` back (tokens are reused, only the
    stitch re-runs); free the state with ``large_free``."""
    if n_threads is None:
        # one worker per core: the stitcher steals the segment it waits for
        n_threads = min(16, max(1, os.cpu_count() or 2))
    ptr, size = _out_u8(out)
    total = ctypes.c_uint64(0)
    end_bit = ctypes.c_int64(0)
    if state is None:
        state = ctypes.c_void_p(None)
    r = lib.dt_inflate_large(_in_u8(body), body.size, seg_bytes, n_threads,
                             ptr, size, ctypes.byref(total),
                             ctypes.byref(end_bit), ctypes.byref(state))
    return Result(r), int(total.value), int(end_bit.value), state


def large_free(lib, state) -> None:
    if state:
        lib.dt_large_free(state)


def stitch(lib, body, cands, lane_info, out):
    """One-call native stitch of the speculative lane chain (dt_stitch):
    resolve validated lanes, span-decode gaps, all inside the library.
    ``lane_info`` is (tokens u32 [M, T], dst_pos, status, final, bit_end)
    or None, which span-decodes everything.  Writes at most ``out.size``
    bytes.  Returns (Result, total_bytes, end_bit)."""
    ptr, size = _out_u8(out)
    cands_a = np.ascontiguousarray(cands, dtype=np.int64)
    M = cands_a.size
    if lane_info is not None:
        toks_nt, dst_pos, status, final, bit_end = lane_info
        toks_a = np.ascontiguousarray(toks_nt, dtype=np.uint32)
        if toks_a.ndim != 2 or toks_a.shape[0] != M:
            raise ValueError(f"tokens must be [{M}, T], got {toks_a.shape}")
        toks_p = toks_a.ctypes.data_as(_u32p)
        T = toks_a.shape[1]
        dst_pos_a = np.ascontiguousarray(dst_pos, dtype=np.int32)
        status_a = np.ascontiguousarray(status, dtype=np.int32)
        final_a = np.ascontiguousarray(final, dtype=np.int32)
        bit_end_a = np.ascontiguousarray(bit_end, dtype=np.int64)
        for name, a in (("dst_pos", dst_pos_a), ("status", status_a),
                        ("final", final_a), ("bit_end", bit_end_a)):
            if a.shape != (M,):
                raise ValueError(f"{name} must be [{M}], got {a.shape}")
    else:
        toks_p = ctypes.cast(None, _u32p)
        T = 0
        dst_pos_a = status_a = final_a = np.zeros(1, np.int32)
        bit_end_a = np.zeros(1, np.int64)
    total = ctypes.c_uint64(0)
    end_bit = ctypes.c_int64(0)
    r = lib.dt_stitch(
        _in_u8(np.ascontiguousarray(body)), body.size,
        cands_a.ctypes.data_as(_i64p), M, toks_p, T,
        dst_pos_a.ctypes.data_as(_i32p), status_a.ctypes.data_as(_i32p),
        final_a.ctypes.data_as(_i32p), bit_end_a.ctypes.data_as(_i64p),
        ptr, size, ctypes.byref(total), ctypes.byref(end_bit))
    return Result(r), int(total.value), int(end_bit.value)


#: ``stitch_many``'s modes, a chain each: ``dt_stitch``'s walk, one chain
#: a task; the two passes of one chain on every thread; and those passes
#: giving the chain back to that walk (an error, EFULL, or lanes that do
#: not resolve), which stitched it then
STITCH_TASK, STITCH_PARALLEL, STITCH_FALLBACK = 0, 1, 2


def stitch_many(lib, body, offs, lens, first, count, cands, lane_info, outs,
                n_threads: int | None = None):
    """Many chains stitched in one call (``dt_stitch_many``) on
    ``n_threads`` native threads.  Chain s is the stream of ``lens[s]``
    bytes at byte ``offs[s]`` of ``body``; its lanes are ``count[s]`` lanes
    from lane ``first[s]`` of ``cands`` and ``lane_info`` = (tokens u32
    [M, T], dst_pos, status, final, bit_end), whose bit positions
    (``cands``, ``bit_end``) are in its own stream; it goes into ``outs[s]``
    (a writable uint8 array a chain) with the result, total and end bit
    that ``stitch`` gives it.  With as many chains as threads or more, one
    chain a task; with fewer, each chain of 16 lanes or more in turn on
    every thread (``STITCH_PARALLEL``), the others one a task.  Returns
    (Results, totals, end bits, modes), one each a chain."""
    geo = [np.ascontiguousarray(a, dtype=np.int64)
           for a in (offs, lens, first, count)]
    S = geo[0].size
    cands_a = np.ascontiguousarray(cands, dtype=np.int64)
    M = cands_a.size
    toks_nt, dst_pos, status, final, bit_end = lane_info
    toks_a = np.ascontiguousarray(toks_nt, dtype=np.uint32)
    lanes = [np.ascontiguousarray(a, dtype=t) for a, t in (
        (dst_pos, np.int32), (status, np.int32), (final, np.int32),
        (bit_end, np.int64))]
    if any(a.shape != (S,) for a in geo) or len(outs) != S:
        raise ValueError("offs, lens, first, count and outs must be [S]")
    if toks_a.ndim != 2 or toks_a.shape[0] != M or \
            any(a.shape != (M,) for a in lanes):
        raise ValueError(f"tokens must be [{M}, T] and the lane arrays "
                         f"[{M}]")
    if S and (int(geo[0].min()) < 0 or int(geo[1].min()) < 0
              or int((geo[0] + geo[1]).max()) > body.size
              or int(geo[2].min()) < 0 or int(geo[3].min()) < 0
              or int((geo[2] + geo[3]).max()) > M):
        raise ValueError("a chain lies outside the body or the lanes")
    for o in outs:
        _out_u8(o, "outs[s]")
    out_ptrs = (ctypes.c_void_p * max(S, 1))(*[o.ctypes.data for o in outs])
    caps = (ctypes.c_uint64 * max(S, 1))(*[o.size for o in outs])
    results = np.zeros(S, np.int32)
    totals = np.zeros(S, np.uint64)
    end_bits = np.zeros(S, np.int64)
    modes = np.zeros(S, np.int32)
    i64 = lambda a: a.ctypes.data_as(_i64p)
    lib.dt_stitch_many(
        _in_u8(body), *(i64(a) for a in geo), S, i64(cands_a),
        toks_a.ctypes.data_as(_u32p), toks_a.shape[1],
        *(a.ctypes.data_as(_i32p) for a in lanes[:3]), i64(lanes[3]),
        out_ptrs, caps, results.ctypes.data_as(_i32p),
        totals.ctypes.data_as(_u64p), i64(end_bits),
        modes.ctypes.data_as(_i32p), _threads(n_threads))
    return ([Result(int(r)) for r in results], totals.astype(np.int64),
            end_bits, modes)

