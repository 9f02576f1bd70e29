// Hopper adler32 kernel: the RFC 1950 checksum of each lane's first
// lengths[n] bytes, for a batch of lanes at once.
//
// Replaces the TPU kernel defl_tpu/ops/pallas/checksums_pl.py:
// adler32_batch_pallas (body: _kernel).  Its plain PyTorch version is
// adler32_batch_ref in defl_tpu_torch/ops/checksums.py; the two agree
// exactly (a checksum has no tolerance).
//
// What bounds it on the card: bytes.  Every byte of a lane is read once
// (N*C at most, sum(lengths) in fact) and 4*N bytes are written; the
// arithmetic is two multiply-adds per four bytes.  What the design does
// about it: one thread block per lane, the block's threads stride over
// the lane in 16-byte loads (neighbouring threads on neighbouring
// addresses), and each 32-bit word is folded with two dp4a instructions
// (sum of its bytes, and sum of byte index times byte), so a thread
// spends few instructions per load and many loads are in flight.
//
// The TPU kernel walks slabs of 3072 bytes because its sums live in
// int32.  Here the sums are closed forms over the whole lane, with
// 0-based byte positions i and len = lengths[n] clipped to [0, C]:
//     A = (1 + S1) mod 65521                 S1 = sum d_i
//     B = (len + len*S1 - S2) mod 65521      S2 = sum i*d_i
// Overflow: a thread keeps S1 and S2 of its own bytes in 64 bits.  With
// len <= 2^30 (the wrapper refuses a wider C) and 256 threads a thread
// sees at most 2^22 + 32 bytes, so its S2 <= 255 * 2^30 * (2^22 + 32)
// < 2^61.  Each thread reduces both sums mod 65521 before the block
// reduction, whose totals are then < 256 * 65521 < 2^24 and fit 32 bits.
//
// Rows need no alignment: bytes before the first 16-byte boundary and
// after the last whole vector are read one by one.
//
// The checked build (-DDEFL_CHECKED, checked.cuh) checks each read of a
// lane's bytes against its min(max(len, 0), C) bytes and each checksum
// store against N, at site SITE_ADLER; without it, `in` is true.
#include <cstdint>
#include <cuda_runtime.h>

#include "checked.cuh"

namespace {

constexpr uint32_t MOD = 65521;
constexpr int THREADS = 256;

#ifdef DEFL_CHECKED
// a thread's checks (checked.cuh's Checks: its lane is the block, its slot
// the thread; an injection moves thread 0's first access) and the lanes
struct AdlerChk : Checks {
  int N;
  __device__ __forceinline__ bool in(long long i, long long extent) const {
    return Checks::in(SITE_ADLER, i, extent);
  }
  // lane i's checksum, stored only for a lane of the batch
  __device__ __forceinline__ void store(uint32_t* out, int i,
                                        uint32_t v) const {
    if (in(i, N)) out[i] = v;
  }
};
#else
struct AdlerChk {
  __device__ __forceinline__ bool in(long long, long long) const {
    return true;
  }
  __device__ __forceinline__ void store(uint32_t* out, int i,
                                        uint32_t v) const {
    out[i] = v;
  }
};
#endif

__global__ void __launch_bounds__(THREADS)
adler32_batch_kernel(const uint8_t* __restrict__ data, long long row_stride,
                     int C, const int32_t* __restrict__ lengths,
                     uint32_t* __restrict__ out
#ifdef DEFL_CHECKED
                     , int N, fault_t* __restrict__ fault, int inject_lane
#endif
                     ) {
  const int lane = blockIdx.x;
  const int t = threadIdx.x;
#ifdef DEFL_CHECKED
  AdlerChk ck{{fault, lane, lane, t, 0}, N};
  if (!ck.in(lane, N)) return;  // the whole block: the barrier stays whole
  ck.inject = lane == inject_lane && t == 0 ? SITE_ADLER : 0;
#else
  const AdlerChk ck{};
#endif
  const uint8_t* row = data + (size_t)lane * (size_t)row_stride;
  int len = lengths[lane];
  len = len < 0 ? 0 : (len > C ? C : len);

  uint64_t s1 = 0, s2 = 0;

  // head: bytes up to the first 16-byte boundary
  int head = (int)((16 - ((uintptr_t)row & 15)) & 15);
  if (head > len) head = len;
  if (t < head) {
    const uint32_t d = ck.in(t, len) ? row[t] : 0u;
    s1 += d;
    s2 += (uint64_t)t * d;
  }

  // body: whole 16-byte vectors
  const int nvec = (len - head) >> 4;
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);
  for (int v = t; v < nvec; v += THREADS) {
    const uint4 q = ck.in(head + 16ll * v + 15, len) ? __ldg(vec + v)
                                                     : make_uint4(0, 0, 0, 0);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    uint32_t sum = 0, wsum = 0;  // sum d, sum k*d for k in [0, 16)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t sw = __dp4a(w[j], 0x01010101u, 0u);
      wsum += 4u * j * sw + __dp4a(w[j], 0x03020100u, 0u);
      sum += sw;
    }
    const uint64_t p = (uint64_t)head + ((uint64_t)v << 4);
    s1 += sum;
    s2 += p * sum + wsum;
  }

  // tail: bytes after the last whole vector
  const int tail0 = head + (nvec << 4);
  if (t < len - tail0) {
    const uint32_t d = ck.in(tail0 + t, len) ? row[tail0 + t] : 0u;
    s1 += d;
    s2 += (uint64_t)(tail0 + t) * d;
  }

  uint32_t r1 = (uint32_t)(s1 % MOD), r2 = (uint32_t)(s2 % MOD);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    r1 += __shfl_down_sync(0xffffffffu, r1, o);
    r2 += __shfl_down_sync(0xffffffffu, r2, o);
  }
  __shared__ uint32_t sh1[THREADS / 32], sh2[THREADS / 32];
  if ((t & 31) == 0) {
    sh1[t >> 5] = r1;
    sh2[t >> 5] = r2;
  }
  __syncthreads();
  if (t == 0) {
    uint64_t S1 = 0, S2 = 0;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) {
      S1 += sh1[i];
      S2 += sh2[i];
    }
    S1 %= MOD;
    S2 %= MOD;
    const uint64_t lm = (uint64_t)len % MOD;
    const uint32_t a = (uint32_t)((1 + S1) % MOD);
    const uint32_t b = (uint32_t)((lm + lm * S1 % MOD + MOD - S2) % MOD);
    ck.store(out, lane, (b << 16) | a);
  }
}

}  // namespace

// Plain C entry for ctypes: pointers to device memory, the caller's
// stream, and ints.  data: uint8 rows of C bytes, row n at data +
// n*row_stride; lengths: int32 [N]; out: uint32 [N].  Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 when
// the launch was accepted).  The calling thread's current device is set
// to `device` for the launch and given back after it, as in
// decode_stream.cu.  The checked build also takes the fault record
// [FAULT_WORDS], zeroed, and the lane of one injected fault (-1: none).
extern "C" int adler32_batch_launch(const void* data, long long row_stride,
                                    int N, int C, const void* lengths,
                                    void* out, void* stream, int device
#ifdef DEFL_CHECKED
                                    , void* fault, int inject_lane
#endif
                                    ) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  if (N > 0)
    adler32_batch_kernel<<<N, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, row_stride, C, (const int32_t*)lengths,
        (uint32_t*)out
#ifdef DEFL_CHECKED
        , N, (fault_t*)fault, inject_lane
#endif
        );
  err = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}
