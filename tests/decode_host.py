"""The decode kernel's per-lane code built for the host, and the decode
around it as the CUDA route runs it (no jax here, so that a subprocess can
load it under a sanitizer's runtime).

``csrc/decode_stream.cu`` is plain C++ apart from a few intrinsics, which
the shim defines; it runs the lanes one after the other.  ``build`` makes
the library with g++ (``sanitize=True``: AddressSanitizer and
UndefinedBehaviorSanitizer, every lane in its own allocation of exactly
its shared memory); ``_host_stream`` and ``_host_split_decode`` put it in
place of the stream kernel's launch inside ``decode_cu``.
"""

import ctypes
import os
import subprocess

import numpy as np
import torch

from defl_tpu_torch.ops import inflate_batch as tib
from defl_tpu_torch.ops.cuda import decode_cu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(REPO, "defl_tpu_torch", "csrc", "decode_stream.cu")
T = 4096

#: what ``sanitize=True`` adds to the build: the first report ends the run
SANITIZE_FLAGS = ("-fsanitize=address,undefined", "-fno-sanitize-recover=all",
                  "-fno-omit-frame-pointer", "-g", "-DSMEM_PER_LANE")

_HOST_SHIM = r"""
#include <algorithm>
#include <cstdint>
#include <vector>
#define __device__
#define __forceinline__ inline
#define __constant__ static const
#define __noinline__
struct uint4 { uint32_t x, y, z, w; };
using std::max;
using std::min;
static inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (s & 31u));
}
static inline long long clock64() { return 0; }
typedef unsigned long long u64;
static inline u64 atomicAdd(u64* p, u64 v) { u64 o = *p; *p += v; return o; }
static inline u64 atomicMax(u64* p, u64 v) {
  u64 o = *p; *p = std::max(o, v); return o;
}
#include "decode_stream.cu"

static int vectorise(const void* words, int W) {
  return (W & 3) == 0 && (reinterpret_cast<uintptr_t>(words) & 15) == 0;
}

// one "thread" after the other: no lane reads another lane's shared words
extern "C" void decode_stream_host(
    int32_t* st, uint32_t* lens, int32_t* count, int32_t* first,
    int32_t* offs, int32_t* maxlen, uint32_t* syms, const uint32_t* words,
    int W, int shared, uint32_t* tok, u64* meta, const int32_t* order, int N,
    int n_steps, int has_dict, int lanes) {
#ifdef SMEM_PER_LANE
  // each lane its own allocation of exactly LANE_BYTES, filled with junk:
  // a sanitizer sees any access past the lane's shared memory
  for (int i = 0; i < N; ++i) {
    std::vector<uint32_t> smem(LANE_BYTES / 4, 0xDEADBEEFu);
    stream_lane(smem.data(), 0, 1, order[i], st, lens, count, first, offs,
                maxlen, syms, words, shared ? 0 : (size_t)W, W,
                vectorise(words, W), tok, meta, N, n_steps, has_dict);
  }
#else
  std::vector<uint32_t> smem((size_t)LANE_BYTES * lanes / 4 + 1, 0xDEADBEEFu);
  for (int i = 0; i < N; ++i)
    stream_lane(smem.data(), i % lanes, lanes, order[i], st, lens, count,
                first, offs, maxlen, syms, words, shared ? 0 : (size_t)W, W,
                vectorise(words, W), tok, meta, N, n_steps, has_dict);
#endif
}

extern "C" void decode_chunk_host(
    int32_t* st, uint32_t* lens, const uint32_t* words, int W, int shared,
    const int32_t* bound, const int32_t* adjoff, const int32_t* maxlen,
    const uint32_t* syms, uint32_t* tok, int N, int K, int has_dict) {
  for (int lane = 0; lane < N; ++lane)
    chunk_lane(lane, st, lens, words, shared ? 0 : (size_t)W, W,
               vectorise(words, W), bound, adjoff, maxlen, syms, tok, N, K,
               has_dict);
}
"""


def build(directory, sanitize: bool = False):
    """g++ the shim into ``directory``; the loaded library (with
    ``sanitize``, load it only where the sanitizers' runtime is preloaded:
    see tests/test_torch_fuzz_asan.py)."""
    src = os.path.join(str(directory), "host.cc")
    with open(src, "w") as f:
        f.write(_HOST_SHIM)
    name = "libdecode_stream_host_asan.so" if sanitize else \
        "libdecode_stream_host.so"
    lib = os.path.join(str(directory), name)
    r = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", *(SANITIZE_FLAGS if sanitize else ()),
         "-I", os.path.dirname(CU), "-o", lib, src],
        capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ failed: {r.stderr}")
    return lib


def _ptr(t, dtype=torch.int32):
    assert t.dtype == dtype and t.is_contiguous()
    return ctypes.c_void_p(t.data_ptr())


def _host_stream(lib, monkeypatch, threads=4):
    """decode_tokens with the stream kernel's launch replaced by the host
    build: everything around the launch is the CUDA route's own code."""
    def launch(st_pk, lens, count, first, offs, maxlen, syms, words, tok,
               meta, order, n_steps, has_dict):
        assert sorted(order.tolist()) == list(range(st_pk.shape[1]))
        lib.decode_stream_host(
            _ptr(st_pk), _ptr(lens), _ptr(count), _ptr(first), _ptr(offs),
            _ptr(maxlen), _ptr(syms), _ptr(words),
            ctypes.c_int(words.shape[1]),
            ctypes.c_int(int(words.shape[0] != st_pk.shape[1])), _ptr(tok),
            _ptr(meta, torch.int64),
            _ptr(order), ctypes.c_int(st_pk.shape[1]), ctypes.c_int(n_steps),
            ctypes.c_int(int(has_dict)), ctypes.c_int(threads))

    monkeypatch.setattr(decode_cu, "_launch_stream", launch)

    def decode(words, nbits, zflag, cap, carry=None, T=T, **kw):
        kw.setdefault("K", 512)
        w = torch.from_numpy(np.ascontiguousarray(words).view(np.int32))
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.int32))
        pad = decode_cu.PAD_WORDS + (-(w.shape[1] + decode_cu.PAD_WORDS)) % 4
        w = torch.nn.functional.pad(w, (0, pad))
        n = w.shape[0]
        nb, zf, cp = as_t(nbits), as_t(zflag), as_t(cap)
        if carry is None:
            st = tib._init_scan_state(n, "cpu")
            ck = tib._init_chunk_state(n, "cpu")
            st["state"] = torch.where(zf > 0, tib.S_ZHDR,
                                      tib.S_BHDR).to(torch.int32)
        else:
            st = {k: carry[k] for k in tib.SCAN_KEYS}
            ck = {k: carry[k] for k in tib.CHUNK_KEYS}
        full = lambda v: torch.full((n,), v, dtype=torch.int32)
        return decode_cu._decode_stream(
            w, nb, cp, full(1 << 30), full(kw.get("dict_len", 0)), full(0),
            st, ck, max(kw["K"], T // 2), kw.get("has_dict", False))
    return decode


def _host_split_decode(lib, monkeypatch, body, kw):
    """The shared-input decode as the CUDA route runs it, its launch
    replaced by the host build."""
    _host_stream(lib, monkeypatch)       # installs the launch
    kw = dict(kw)
    n = len(kw["nbits"])
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.int32))
    st = tib._init_scan_state(n, "cpu")
    ck = tib._init_chunk_state(n, "cpu")
    st["state"].fill_(tib.S_BHDR)
    st["bitpos"] = as_t(kw["start_bit"])
    words = torch.from_numpy(decode_cu.pad_body(body)).view(torch.int32)
    return decode_cu._decode_stream(
        words[None, :], as_t(kw["nbits"]), as_t(kw["cap"]), as_t(kw["limit"]),
        as_t(kw["dict_reach"]), as_t(kw["in_base"]), st, ck,
        max(512, kw["T"] // 2), False)
