// The checked build of the port's kernels (-DDEFL_CHECKED): what
// decode_stream.cu, adler32_batch.cu and find_starts.cu share.
//
// In a checked build every access of a kernel to device and shared memory
// is checked against the extent its launch was given, at one of the sites
// below.  A fault is recorded and the access is not performed: a read
// gives 0 and a store is dropped, so the launch still ends.  The record is
// FAULT_WORDS int64 words in device memory, zeroed by the wrapper: the
// number of faults, then the launch's first fault in full.  The wrapper
// reads it after its one sync and raises (defl_tpu_torch/ops/cuda/build.py:
// SITES names the sites in this order).  Without DEFL_CHECKED nothing here
// is compiled but the constants.
#pragma once

namespace {

// the sites an access is checked at
constexpr int SITE_SHARED = 1,  // a lane's word of shared memory
    SITE_LUT = 2,               // a lane's lookup entry in shared memory
    SITE_INPUT = 3,             // the lane's input row, or the shared body
    SITE_TOKEN = 4,             // a token slot
    SITE_CARRY = 5,             // the carry's rows, the tables, the lane order
    SITE_META = 6,              // the launch's totals
    SITE_UNINIT = 7,            // a shared word or lookup entry read before
                                // this launch wrote it
    SITE_ADLER = 8,             // adler32: a lane's bytes, its checksum
    SITE_FIND = 9;              // find_starts: a find's stream bytes, its
                                // arguments and result
// the fault record: faults counted, then the first one's site, lane, block,
// slot (the thread's place in its block), index and extent
constexpr int F_COUNT = 0, F_SITE = 1, F_LANE = 2, F_BLOCK = 3, F_SLOT = 4,
              F_INDEX = 5, F_EXTENT = 6;
constexpr int FAULT_WORDS = 8;

#ifdef DEFL_CHECKED
typedef unsigned long long fault_t;

// Count a fault; the first one claims the record with an atomicCAS on the
// count and writes itself into it.
__device__ __noinline__ void record_fault(fault_t* rec, int site, int lane,
                                          int block, int slot,
                                          long long index, long long extent) {
  if (atomicCAS(rec + F_COUNT, 0ull, 1ull) == 0ull) {
    rec[F_SITE] = (fault_t)site;
    rec[F_LANE] = (fault_t)(long long)lane;
    rec[F_BLOCK] = (fault_t)(long long)block;
    rec[F_SLOT] = (fault_t)(long long)slot;
    rec[F_INDEX] = (fault_t)index;
    rec[F_EXTENT] = (fault_t)extent;
  } else {
    atomicAdd(rec + F_COUNT, 1ull);
  }
}

// Whose faults are recorded where (its lane, block and slot in the
// block), and the site whose next access is moved out of its extent
// (0: none): a fault injected to show that the check fires.
struct Checks {
  fault_t* rec;
  int lane, block, slot;
  mutable int inject;

  // index i of `extent`
  __device__ __forceinline__ bool in(int site, long long i,
                                     long long extent) const {
    if (inject == site) {
      i += extent;
      inject = 0;
    }
    if (i >= 0 && i < extent) return true;
    record_fault(rec, site, lane, block, slot, i, extent);
    return false;
  }
};
#endif  // DEFL_CHECKED

}  // namespace
