// Hopper block finder: for many bit windows of DEFLATE streams at once,
// the first bit in each window at which a dynamic block's header starts.
//
// It replaces no TPU kernel.  The JAX package and the port's host tier find
// block starts on the host (csrc/defl_host.cc: find_block_start_impl, many
// at once through csrc/defl_batch.cc: dt_find_block_starts).  The split
// decode of runtime/large.py and runtime/split.py uploads the body to the
// card anyway, so this kernel runs a call's finds there
// (large.find_lane_starts) and the host no longer scans while the card
// waits.  Its plain PyTorch version is find_block_starts_ref in
// defl_tpu_torch/ops/cuda/find_cu.py; the kernel, the plain version and the
// host finder give the same bit for every find.
//
// Find k scans the stream of lens[k] bytes at byte offs[k] of the body,
// bits [lo[k], hi[k]) of it with hi clamped to 8 * lens[k] - 144 and lo to
// 0, as the host finder clamps them, and reads no byte outside that stream.
// A bit b passes, as there: (1) BTYPE at b+1 is 2, HLIT <= 29 and HDIST <=
// 29 (one 64-bit window gives these masks for 32 positions at once);
// (2) the HCLEN code-length lengths at b+17 form a complete code (their
// Kraft sum, 2^(7-len) over the non-zero lengths, is 2^7); (3) the whole
// header decodes as validate_dyn_header decodes it, its reader bounded by
// the stream's end: a symbol is read only while 14 bits or more are left,
// and then only real bits of the stream.  The result is the first bit that
// passes, or -1.
//
// What bounds it on the card: neither bytes nor operations.  The bytes a
// call's finds must read (each from lo up to its hit) take microseconds at
// 3.35 TB/s; the filter is a few operations a position.  The time goes to
// how far each find walks before its hit, and to the rare position that
// passes (1) and (2): its header decode is a serial chain of some 280
// symbol decodes in one thread.  What the design does about it: one block
// a find walks its window in tiles of THREADS x 32 positions, a thread 32
// neighbouring positions from one 128-bit window of four words; the block
// stops at the first tile that holds a pass (the least of its threads'
// first passes), so its work stays near the host's first-hit scan and not
// the whole window; and many finds' blocks share each SM, so one thread's
// header decode hides behind the others' filters.
//
// The per-find code is plain C++ apart from a few intrinsics, so a host
// build of this file (tests/test_torch_find_cu.py) runs it find by find,
// group by group in order, on the CPU.
//
// The checked build (-DDEFL_CHECKED, checked.cuh) checks every read of a
// stream's bytes against its length, and each argument and result against
// the finds' count, at site SITE_FIND; without it, `in` is true.
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif
#include "checked.cuh"

namespace {

constexpr int THREADS = 256;
// positions a thread tests in a tile, one bit of a 32-bit mask each
constexpr int GROUP_BITS = 32;
constexpr int TILE_BITS = THREADS * GROUP_BITS;
// the host finder stays this many bits clear of a stream's end (its
// deepest fixed load is at bit + 71)
constexpr int TAIL_BITS = 144;
// a symbol of the code-length code is read only while this many bits are
// left (validate_dyn_header's `b.n < 14`)
constexpr int SYMBOL_BITS = 14;

__constant__ int kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                 11, 4, 12, 3, 13, 2, 14, 1, 15};

__device__ __forceinline__ int lowest_bit(uint64_t m) {
#ifdef __CUDA_ARCH__
  return __ffsll((long long)m) - 1;
#else
  return __builtin_ctzll(m);
#endif
}

// One find's stream: its first byte in the body and its length, and, in
// the checked build, whose reads are checked.
struct Stream {
  const uint8_t* p;
  long long len;
#ifdef DEFL_CHECKED
  Checks ck;
  __device__ __forceinline__ bool in(long long i) const {
    return ck.in(SITE_FIND, i, len);
  }
#else
  __device__ __forceinline__ bool in(long long) const { return true; }
#endif

  // byte i of the stream; 0, and nothing read, outside it
  __device__ __forceinline__ uint32_t byte(long long i) const {
    return i >= 0 && i < len && in(i) ? (uint32_t)__ldg(p + i) : 0u;
  }
  // bytes 4j .. 4j + 3 of the stream as a little-endian word: two aligned
  // loads where both lie inside the stream, else byte by byte
  __device__ __forceinline__ uint32_t word(long long j) const {
    const long long b = 4 * j;
    const int mis = (int)(reinterpret_cast<uintptr_t>(p + b) & 3);
    const long long a = b - mis;
    if (a >= 0 && a + 8 <= len && in(a) && in(a + 7)) {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(p + a);
      return mis ? __funnelshift_r(__ldg(q), __ldg(q + 1), 8 * mis)
                 : __ldg(q);
    }
    return byte(b) | byte(b + 1) << 8 | byte(b + 2) << 16 | byte(b + 3) << 24;
  }
  // k <= 7 bits at bit c (all inside the stream where it is called)
  __device__ __forceinline__ uint32_t bits(long long c, int k) const {
    const long long i = c >> 3;
    return ((byte(i) | byte(i + 1) << 8) >> (c & 7)) & ((1u << k) - 1);
  }
};

// The window a find scans, clamped as find_block_start_impl clamps it.
__device__ __forceinline__ void clamp_window(long long len, long long& lo,
                                             long long& hi) {
  const long long maxbit = 8 * len - TAIL_BITS;
  if (hi > maxbit) hi = maxbit;
  if (lo < 0) lo = 0;
}

// The code-length code as defl_host.cc's MiniCanon holds it: canonical
// decode without a table over the 19-symbol alphabet.
struct CodeLengthCode {
  int count[8], firstcode[8], offs[8];
  int syms[19];

  __device__ bool init(const int* lens) {
    for (int l = 0; l < 8; ++l) count[l] = 0;
    for (int s = 0; s < 19; ++s) count[lens[s]]++;
    int code = 0, idx = 0, left = 1;
    for (int l = 1; l <= 7; ++l) {
      left = (left << 1) - count[l];
      if (left < 0) return false;
      firstcode[l] = code;
      offs[l] = idx;
      idx += count[l];
      code = (code + count[l]) << 1;
    }
    if (left != 0) return false;
    int k[8];
    for (int l = 0; l < 8; ++l) k[l] = offs[l];
    for (int s = 0; s < 19; ++s)
      if (lens[s]) syms[k[lens[s]]++] = s;
    return true;
  }
  // the symbol the 7 bits `peek` start with (sets *used), or -1
  __device__ int decode(uint32_t peek, int* used) const {
    const int rev = (int)(__brev(peek & 0x7Fu) >> 25);
    for (int l = 1; l <= 7; ++l) {
      const int c = rev >> (7 - l);
      if (c - firstcode[l] < count[l] && c >= firstcode[l]) {
        *used = l;
        return syms[offs[l] + c - firstcode[l]];
      }
    }
    return -1;
  }
};

// validate_dyn_header at `bit`, which passed the filter: v holds the
// stream's bits from `bit` (at least 17 of them), h those from bit + 17
// (the 3 * hclen bits of the code-length lengths).
template <typename S>
__device__ bool header_valid(const S& s, long long bit, uint64_t v,
                             uint64_t h, int hclen) {
  const int hlit = 257 + (int)((v >> 3) & 31);
  const int hdist = 1 + (int)((v >> 8) & 31);
  int cl[19] = {0};
  for (int q = 0; q < hclen; ++q) cl[kClOrder[q]] = (int)((h >> (3 * q)) & 7);
  CodeLengthCode mc;
  if (!mc.init(cl)) return false;

  long long c = bit + 17 + 3 * hclen;
  const long long end = 8 * s.len;
  const int total = hlit + hdist;
  // how many litlen and distance lengths have each value, and the length
  // of symbol 256 (end of block)
  int cnt[16] = {0}, dcnt[16] = {0};
  int i = 0, prev = 0, eob = 0;
  while (i < total) {
    if (end - c < SYMBOL_BITS) return false;  // cut by the stream's end
    int used;
    const int sym = mc.decode(s.bits(c, 7), &used);
    if (sym < 0) return false;
    c += used;
    int rep = 1, val = sym;
    if (sym < 16) {
      prev = sym;
    } else {
      const int eb = sym == 16 ? 2 : sym == 17 ? 3 : 7;
      rep = (sym == 18 ? 11 : 3) + (int)s.bits(c, eb);
      c += eb;
      if (sym == 16) {
        if (i == 0) return false;
        val = prev;
      } else {
        val = 0;
        prev = 0;
      }
      if (i + rep > total) return false;
    }
    // lengths i .. i + rep - 1: litlen below hlit, distance from it
    const int lit = i < hlit ? (i + rep < hlit ? i + rep : hlit) - i : 0;
    cnt[val] += lit;
    dcnt[val] += rep - lit;
    if (i <= 256 && 256 < i + rep) eob = val;
    i += rep;
  }
  if (eob == 0) return false;
  // the litlen code must be complete; the distance code may be incomplete
  // but not oversubscribed
  int left = 1, dleft = 1;
  for (int l = 1; l <= 15; ++l) {
    left = (left << 1) - cnt[l];
    dleft = (dleft << 1) - dcnt[l];
    if (left < 0 || dleft < 0) return false;
  }
  return left == 0;
}

// The first bit of [gb, gb + 32) inside [lo, hi) that passes, or -1; gb is
// a multiple of 32, so the group's bits are the stream's words gb / 32 ..
// gb / 32 + 3 (bit gb + i + 105 at most is read by the filter).
template <typename S>
__device__ long long group_first(const S& s, long long gb, long long lo,
                                 long long hi) {
  const long long j = gb >> 5;
  const uint64_t w0 = s.word(j) | (uint64_t)s.word(j + 1) << 32;
  const uint64_t w1 = s.word(j + 2) | (uint64_t)s.word(j + 3) << 32;
  // BTYPE == 2 (bit i+1 clear, bit i+2 set), HLIT and HDIST <= 29
  uint64_t m = ~(w0 >> 1) & (w0 >> 2) & 0xFFFFFFFFull;
  m &= ~((w0 >> 4) & (w0 >> 5) & (w0 >> 6) & (w0 >> 7));
  m &= ~((w0 >> 9) & (w0 >> 10) & (w0 >> 11) & (w0 >> 12));
  if (lo > gb) m &= lo - gb >= GROUP_BITS ? 0 : ~0ull << (lo - gb);
  if (hi - gb < GROUP_BITS) m &= hi <= gb ? 0 : (1ull << (hi - gb)) - 1;
  while (m) {
    const int i = lowest_bit(m);
    m &= m - 1;
    const int hclen = 4 + (int)((w0 >> (i + 13)) & 15);
    const int f = i + 17;  // 17 .. 48: h's 57 bits lie in w0:w1
    const uint64_t h = (w0 >> f) | (w1 << (64 - f));
    int kraft = 0;
#pragma unroll
    for (int q = 0; q < 19; ++q) {
      const int cl = (int)((h >> (3 * q)) & 7);
      kraft += q < hclen && cl ? 128 >> cl : 0;
    }
    if (kraft == 128 && header_valid(s, gb + i, w0 >> i, h, hclen))
      return gb + i;
  }
  return -1;
}

#ifdef __CUDACC__

// Block k: find k.  args: int64 [4, n], the rows offs, lens, lo, hi.
__global__ void __launch_bounds__(THREADS)
find_starts_kernel(const uint8_t* __restrict__ body,
                   const long long* __restrict__ args, int n,
                   long long* __restrict__ out
#ifdef DEFL_CHECKED
                   , fault_t* __restrict__ fault, int inject_find
#endif
                   ) {
  const int k = blockIdx.x;
  const int t = threadIdx.x;
#ifdef DEFL_CHECKED
  const Checks ck{fault, k, k, t, 0};
  if (!ck.in(SITE_FIND, k, n)) return;  // the whole block: no barrier left
  // an injection moves thread 0's first read of its stream (the thread
  // whose group holds the window's start, so it reads wherever the window
  // is not empty)
  const Stream s{body + args[k], args[n + k],
                 {fault, k, k, t, k == inject_find && t == 0 ? SITE_FIND : 0}};
#else
  const Stream s{body + args[k], args[n + k]};
#endif
  long long lo = args[2 * n + k], hi = args[3 * n + k];
  clamp_window(s.len, lo, hi);
  __shared__ int best;  // the least passing offset in the tile
  if (t == 0) best = TILE_BITS;
  __syncthreads();
  for (long long tb = lo & ~(long long)(GROUP_BITS - 1); tb < hi;
       tb += TILE_BITS) {
    const long long hit = group_first(s, tb + (long long)GROUP_BITS * t, lo,
                                      hi);
    if (hit >= 0) atomicMin(&best, (int)(hit - tb));
    if (__syncthreads_or(hit >= 0)) {
      if (t == 0) out[k] = tb + best;
      return;
    }
  }
  if (t == 0) out[k] = -1;
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// Plain C entry for ctypes: pointers to device memory, the caller's stream,
// and ints.  body: the bytes the streams lie in; args: int64 [4, n] (offs,
// lens, lo, hi), each stream inside the body (the wrapper checks);
// out: int64 [n].  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when the launch was accepted); the calling thread's
// current device is set to `device` for the launch and given back after
// it.  The checked build also takes the fault record [FAULT_WORDS], zeroed,
// and the find whose thread 0's first read is moved out of its stream (-1:
// none).
extern "C" int find_starts_launch(const void* body, const void* args, int n,
                                  void* out, void* stream, int device
#ifdef DEFL_CHECKED
                                  , void* fault, int inject_find
#endif
                                  ) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0)
    find_starts_kernel<<<n, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)body, (const long long*)args, n, (long long*)out
#ifdef DEFL_CHECKED
        , (fault_t*)fault, inject_find
#endif
        );
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

#endif  // __CUDACC__
