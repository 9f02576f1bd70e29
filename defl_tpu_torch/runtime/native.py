"""ctypes bindings for the port's C++ host engine (csrc/defl_host.cc).

Counterpart of ``defl_tpu/runtime/native.py``.  The library builds with
g++ at first use into ``csrc/build/``, named by a hash of its source, so
an edited source builds anew and a stale library is never loaded.  A
failed build raises with g++'s own message: the port has no resolver or
host engine to carry on with instead.

Only the entry points the port calls are bound: ``dt_resolve_tokens``
(pass 2 of the device inflate), ``dt_inflate_batch`` (host retry of lanes
that ran out of steps) and ``dt_adler32``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

from defl_tpu_torch.errors import Result

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_BUILD = os.path.join(_CSRC, "build")
SOURCE = "defl_host.cc"
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
_pptr = ctypes.POINTER(ctypes.c_void_p)


def lib_path() -> str:
    h = hashlib.sha256()
    with open(os.path.join(_CSRC, SOURCE), "rb") as f:
        h.update(f.read())
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
        lib.dt_inflate_batch.restype = ctypes.c_int
        lib.dt_inflate_batch.argtypes = [
            _pptr, _u64p, _pptr, _u64p, _u64p, _i32p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


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


def native_inflate_batch(payloads, dst_capacities, flags: int = 1,
                         n_threads=None):
    """Multithreaded batch host inflate; (list of Result, list of bytes)."""
    lib = load()
    n = len(payloads)
    caps = ([int(dst_capacities)] * n if isinstance(dst_capacities, int)
            else list(dst_capacities))
    srcs = [np.frombuffer(bytes(p), np.uint8) if p else
            np.zeros(1, np.uint8) for p in payloads]
    dsts = [np.zeros(max(c, 1), np.uint8) for c in caps]
    src_ptrs = (ctypes.c_void_p * n)(
        *[s.ctypes.data_as(ctypes.c_void_p).value for s in srcs])
    dst_ptrs = (ctypes.c_void_p * n)(
        *[d.ctypes.data_as(ctypes.c_void_p).value for d in dsts])
    srclens = (ctypes.c_uint64 * n)(*[len(p) for p in payloads])
    dstcaps = (ctypes.c_uint64 * n)(*[len(d) for d in dsts])
    dstlens = (ctypes.c_uint64 * n)()
    results = (ctypes.c_int32 * n)()
    lib.dt_inflate_batch(src_ptrs, srclens, dst_ptrs, dstcaps, dstlens,
                         results, n, flags,
                         _default_threads() if n_threads is None
                         else n_threads)
    outs = [dsts[i][: dstlens[i]].tobytes() for i in range(n)]
    return [Result(int(r)) for r in results], outs


def native_adler32(data, start: int = 1) -> int:
    """adler32 of bytes-like data or of an ndarray's bytes (no copy when
    the array is contiguous)."""
    lib = load()
    if isinstance(data, np.ndarray):
        a = np.ascontiguousarray(data.reshape(-1).view(np.uint8))
        return int(lib.dt_adler32(a.ctypes.data_as(_u8p), a.size, start))
    b = bytes(data)
    return int(lib.dt_adler32(_u8(b), len(b), start))
