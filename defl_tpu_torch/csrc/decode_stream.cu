// Hopper decode kernels: the per-lane DEFLATE state machine, bits -> tokens.
//
// Two entries share one step function:
//
//   decode_stream_launch  one launch for a whole decode_tokens call.  Each
//       lane runs until it reaches a fixed point (DONE, ERR, FULL, stalled
//       for input) or has spent its step budget, and builds its canonical
//       Huffman tables itself, so no lane ever parks for the host.
//   decode_chunk_launch   K lockstep steps with tables the caller built;
//       a lane that needs a table parks in S_WAIT.  This is the form that
//       is held bit for bit, slot for slot, against the plain PyTorch twin
//       decode_chunk_ref (defl_tpu_torch/ops/cuda/decode_cu.py).
//
// Together they replace the TPU kernel
// defl_tpu/ops/pallas/decode_pl.py:decode_chunk_pl (body: _make_kernel) and
// the between-chunk table builds of defl_tpu/ops/inflate_batch.py
// (_build_cl, _build_litdist, _build_fixed over ops/tables.build_canonical).
// The plain PyTorch version of decode_stream is the chunk loop of
// decode_cu.decode_tokens over decode_chunk_ref with ib._apply_builds.
//
// What bounds the work on the card: neither bytes nor operations, but
// instruction latency.  One thread owns one lane; a step is a
// chain of dependent operations (bits -> code length -> symbol -> next
// bits) through branches that differ from lane to lane, so a warp runs
// every branch its lanes take, one after the other; and the call lasts as
// long as its longest lane (~19,000 steps for 64 KiB of literals).  What
// the stream kernel does about it:
//   - a direct lookup table per lane in shared memory answers a literal/
//     length code of up to LIT_LUT_BITS bits and a distance code of up to
//     DIST_LUT_BITS bits in one 2-byte load; only longer (rare) codes and
//     the code-length alphabet take the boundary-sum canonical decode,
//     whose boundaries, adjoff and symbol bank lie in shared memory too.
//     Everything is laid out [entry][lane of the block], so lanes never
//     fight over a 4-byte word's bank whatever their indices;
//   - input comes through an 8-word ring in shared memory over the lane's
//     row, refilled 16 bytes at a time; the next 16 bytes are already on
//     their way in registers, so a refill does not wait for device memory;
//     a step takes its bits as two 64-bit windows, not five 32-bit ones;
//   - few threads of each warp own a lane (lanes_per_warp): fewer branches
//     to run per warp and more warps per scheduler to hide latency;
//   - a lane in S_WAIT builds its tables in the same launch (a counting
//     sort by its own thread over <= 288 symbols, then the lookup table)
//     and goes on; count, first and offs go straight to the carry in
//     device memory, which a step never reads;
//   - the token buffer arrives zero-filled and only real tokens are
//     stored; the largest row any lane wrote comes back through an
//     atomicMax, so the whole call needs one launch and one host read.
// Shared-input mode (runtime/large.py's split decode of one huge stream):
// every lane reads the same body, so a lane's row is words + lane *
// row_stride with row_stride 0 and W the body's length; bitpos, nbits and
// limit are then positions in the whole stream (below 2^31 - 2^22 bits, so
// every cursor, and every word index derived from one by a right shift,
// fits an int), a lane is DONE at the first block header at or past its
// limit, reach is per lane (0 for the lane at the stream's head), and
// in_base rebases a stored run's offset to the lane's own segment.
// Consume-only-on-success is kept: a step that lacks bits leaves bitpos,
// state and tokens untouched and marks the lane UNFINISHED, which is what
// makes EFULL and UNFINISHED lanes resumable.
//
// The per-lane code is plain C++ apart from a few intrinsics, so a host
// build of this file (tests/test_torch_stream_decode.py) runs the same
// step and build code lane by lane on the CPU.
#include <cstdint>
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

// lane states, status codes, token kinds: defl_tpu_torch/ops/inflate_batch.py
constexpr int S_ZHDR = 0, S_DICTID = 1, S_BHDR = 2, S_STORED_HDR = 3,
              S_STORED_LEN = 4, S_STORED = 5, S_CLEN_HDR = 6,
              S_CLEN_LENS = 7, S_LENS = 8, S_WAIT = 9, S_SYM = 10,
              S_DONE = 11, S_ERR = 12, S_FULL = 13;
constexpr int STATUS_RUNNING = 127;
constexpr int RES_OK = 0, RES_UNFINISHED = 2, RES_ERR = -1, RES_EFULL = -105;
constexpr uint32_t TOK_LIT = 1, TOK_MATCH = 2, TOK_STORED = 3;
constexpr uint32_t TOK_LIT_PAIR_BIT = 1u << 16;
constexpr int STORED_MAX_RUN = 256;
// symbol bank (defl_tpu_torch/ops/tables.py): 3 x 10-bit entries per word
constexpr int SYMS_BANK = 348, SYMS_WORDS = 116, LENS_WORDS = 40;
constexpr int CL_BASE = 0, LIT_BASE = 24, DIST_BASE_ = 312;
// state rows: defl_tpu_torch/ops/cuda/decode_cu.py R_*
constexpr int R_STATE = 0, R_BITPOS = 1, R_FINAL = 2, R_HLIT = 3,
              R_HDIST = 4, R_HCLEN = 5, R_IDX = 6, R_PREV = 7,
              R_DSTPOS = 8, R_NEEDB = 9, R_RESUME = 10, R_STATUS = 11,
              R_CLLO = 12, R_CLHI = 13, R_NBITS = 14, R_CAP = 15,
              R_LIMIT = 17, R_REACH = 18, R_INBASE = 19;
// A lane's shared memory in the stream kernel.  4-byte words, entry-major
// (word e of the block's lane s is smem[e * lanes + s]): the symbol bank,
// adjoff and the code-space boundaries (kind*16 + len each), the code
// lengths being read, 16 sort counters, the input ring.  Behind the words
// of all lanes, 2-byte lookup entries laid out the same way: LIT then DIST.
constexpr int OFF_SYMS = 0, OFF_ADJ = 116, OFF_BND = 164, OFF_LENS = 212,
              OFF_CNT = 252, OFF_RING = 268;
constexpr int LANE_WORDS = 276;
constexpr int LIT_LUT_BITS = 10, DIST_LUT_BITS = 8;
constexpr int LUT_ENTRIES = (1 << LIT_LUT_BITS) + (1 << DIST_LUT_BITS);
constexpr int LANE_BYTES = LANE_WORDS * 4 + LUT_ENTRIES * 2;
// a lookup entry: the symbol in bits [8:0], its code length in [12:9];
// 0 where no code of at most the table's bits matches
constexpr int LUT_LEN_SHIFT = 9;
// the call's totals over all lanes, 64 bits each: the largest token row
// written, steps, builds, symbols the builds sorted, cycles in builds and
// in all, tokens stored
typedef unsigned long long meta_t;
constexpr int M_ROWS = 0, M_STEPS = 1, M_BUILDS = 2, M_SORTED = 3,
              M_BUILD_CYCLES = 4, M_LANE_CYCLES = 5, M_TOKENS = 6;
constexpr int THREADS = 128;  // decode_chunk's block

// RFC 1951 code-length code order
__constant__ int kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                 11, 4, 12, 3, 13, 2, 14, 1, 15};

__device__ __forceinline__ uint32_t extract(uint32_t pk, int off, int nb) {
  return (pk >> off) & ((1u << nb) - 1u);
}

__device__ __forceinline__ int length_from_sym(int sym, uint32_t pk, int off,
                                               int& eb) {
  eb = min(max((sym - 261) >> 2, 0), 5);
  int base = sym <= 264 ? sym - 254 : ((((sym - 261) & 3) + 4) << eb) + 3;
  if (sym >= 285) {
    eb = 0;
    base = 258;
  }
  return base + (int)extract(pk, off, eb);
}

__device__ __forceinline__ int dist_from_sym(int dsym, uint32_t pk, int off,
                                             int& eb) {
  eb = min(max((dsym >> 1) - 1, 0), 13);
  int base = ((2 + (dsym & 1)) << eb) + 1;
  if (dsym < 4) {
    eb = 0;
    base = dsym + 1;
  }
  return base + (int)extract(pk, off, eb);
}

// ---- a lane's state ---------------------------------------------------------

struct Lane {
  int state, bitpos, fin, hlit, hdist, hclen, idx, prev, dst_pos, need_build,
      resume_state, status;
  uint32_t cl_lo, cl_hi;
  int nbits, cap, limit, reach, in_base;

  __device__ __forceinline__ void load_state(const int32_t* r, size_t n) {
    state = r[R_STATE * n];
    bitpos = r[R_BITPOS * n];
    fin = r[R_FINAL * n];
    hlit = r[R_HLIT * n];
    hdist = r[R_HDIST * n];
    hclen = r[R_HCLEN * n];
    idx = r[R_IDX * n];
    prev = r[R_PREV * n];
    dst_pos = r[R_DSTPOS * n];
    need_build = r[R_NEEDB * n];
    resume_state = r[R_RESUME * n];
    status = r[R_STATUS * n];
    cl_lo = (uint32_t)r[R_CLLO * n];
    cl_hi = (uint32_t)r[R_CLHI * n];
    nbits = r[R_NBITS * n];
    cap = r[R_CAP * n];
    limit = r[R_LIMIT * n];
    reach = r[R_REACH * n];
    in_base = r[R_INBASE * n];
  }
  __device__ __forceinline__ void store_state(int32_t* r, size_t n) const {
    r[R_STATE * n] = state;
    r[R_BITPOS * n] = bitpos;
    r[R_FINAL * n] = fin;
    r[R_HLIT * n] = hlit;
    r[R_HDIST * n] = hdist;
    r[R_HCLEN * n] = hclen;
    r[R_IDX * n] = idx;
    r[R_PREV * n] = prev;
    r[R_DSTPOS * n] = dst_pos;
    r[R_NEEDB * n] = need_build;
    r[R_RESUME * n] = resume_state;
    r[R_STATUS * n] = status;
    r[R_CLLO * n] = (int32_t)cl_lo;
    r[R_CLHI * n] = (int32_t)cl_hi;
  }
};

// ---- a lane's input row -------------------------------------------------------

struct Row {
  const uint32_t* row;
  int W;
  bool vec;  // rows start on 16-byte boundaries and W % 4 == 0
  // words [4g, 4g + 4); past the row's end it is the last group (the
  // caller's zero padding) or, word by word, the last word
  __device__ __forceinline__ uint4 group(int g) const {
    uint4 v;
    if (vec) {
      g = min(max(g, 0), (W >> 2) - 1);
      v = reinterpret_cast<const uint4*>(row)[g];
    } else {
      v.x = row[min(max(4 * g, 0), W - 1)];
      v.y = row[min(max(4 * g + 1, 0), W - 1)];
      v.z = row[min(max(4 * g + 2, 0), W - 1)];
      v.w = row[min(max(4 * g + 3, 0), W - 1)];
    }
    return v;
  }
};

// the shared decode of a canonical code from 48 boundaries: the code
// length is 1 + #{l : rev15 >= bound[l]}, found iff it is at most 15
template <class BND>
__device__ __forceinline__ int code_length(uint32_t pk, int& rv, BND bnd) {
  rv = (int)(__brev(pk & 0x7FFFu) >> 17);
  int nge = 0;
#pragma unroll
  for (int l = 1; l <= 15; ++l) nge += rv >= bnd(l);
  return nge >= 15 ? 0 : nge + 1;
}

__device__ __forceinline__ int bank_symbol(uint32_t word, int symidx, int q) {
  return (int)((word >> (10 * (symidx - 3 * q))) & 0x3FFu);
}

// ---- decode_chunk's memory: tables in device memory, window in registers ----

struct ChunkMem {
  const int32_t* adjoff;  // + lane, lane-minor rows of n
  const uint32_t* syms;   // + lane
  uint32_t* lens_pk;      // + lane
  size_t n;
  int bnd[48];  // code-space boundaries, kind*16 + len
  int mlen[3];
  Row in;
  // input window: words [base, base + 8) of the lane's row, base % 4 == 0
  uint32_t w[8];
  int base;

  __device__ __forceinline__ int maxlen(int kind) const { return mlen[kind]; }
  __device__ __forceinline__ void lens_or(int wi, uint32_t v) const {
    lens_pk[wi * n] |= v;
  }
  __device__ __forceinline__ void put(int at, uint4 v) {
    w[at] = v.x;
    w[at + 1] = v.y;
    w[at + 2] = v.z;
    w[at + 3] = v.w;
  }
  __device__ __forceinline__ void open(int w0) {
    base = w0 & ~3;
    put(0, in.group(base >> 2));
    put(4, in.group((base >> 2) + 1));
  }
  // make base <= w0 < base + 4: a step reads at most 131 bits from its
  // word-aligned cursor, i.e. words [w0, w0 + 5), which then lie inside
  __device__ __forceinline__ void seek(int w0) {
    const int d = w0 - base;
    if (d >= 0 && d < 4) return;
    if (d >= 4 && d < 8) {
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = w[j + 4];
      base += 4;
      put(4, in.group((base >> 2) + 1));
    } else {
      open(w0);
    }
  }
  __device__ __forceinline__ uint32_t word(int i) const {
    const uint32_t a0 = (i & 1) ? w[1] : w[0], a1 = (i & 1) ? w[3] : w[2];
    const uint32_t a2 = (i & 1) ? w[5] : w[4], a3 = (i & 1) ? w[7] : w[6];
    const uint32_t b0 = (i & 2) ? a1 : a0, b1 = (i & 2) ? a3 : a2;
    return (i & 4) ? b1 : b0;
  }
  // 64 bits, LSB first, from stream bit `pos` (at most 48 past the cursor).
  // The funnel shift is defined for a shift of 0, so the TPU kernel's
  // `(32 - s) & 31` guard and `s == 0` select are not needed.
  __device__ __forceinline__ void peek64(int pos, uint32_t& lo,
                                         uint32_t& hi) const {
    const int o = pos - (base << 5), i = o >> 5;
    const uint32_t mid = word(i + 1);
    lo = __funnelshift_r(word(i), mid, o & 31);
    hi = __funnelshift_r(mid, word(i + 2), o & 31);
  }
  // boundary-sum canonical decode against table KIND (0 CL, 1 LIT,
  // 2 DIST): returns the symbol and sets clen, 0 when no code matches
  template <int KIND>
  __device__ __forceinline__ int canon(uint32_t pk, int& clen) const {
    int rv;
    clen = code_length(pk, rv, [this](int l) { return bnd[KIND * 16 + l]; });
    if (clen == 0) return 0;
    int symidx = adjoff[(KIND * 16 + clen) * n] + (rv >> (15 - clen));
    symidx = min(max(symidx, 0), SYMS_BANK - 1);
    const int q = symidx / 3;
    return bank_symbol(syms[q * n], symidx, q);
  }
};

// ---- the stream kernel's memory: everything in shared memory -----------------

struct StreamMem {
  uint32_t* p;    // the block's words + this lane's slot
  uint16_t* lut;  // the block's lookup entries + this lane's slot
  int stride;     // lanes of the block
  int mlen[3];
  Row in;
  int base;      // the ring holds words [base, base + 8), base % 4 == 0
  uint4 ahead;   // words [base + 8, base + 12), loaded one refill early

  __device__ __forceinline__ uint32_t& at(int e) const {
    return p[e * stride];
  }
  __device__ __forceinline__ uint16_t& lut_at(int e) const {
    return lut[e * stride];
  }
  __device__ __forceinline__ int maxlen(int kind) const { return mlen[kind]; }
  __device__ __forceinline__ void lens_or(int wi, uint32_t v) const {
    at(OFF_LENS + wi) |= v;
  }
  __device__ __forceinline__ void put(int word0, uint4 v) const {
    const int e = OFF_RING + (word0 & 7);
    at(e) = v.x;
    at(e + 1) = v.y;
    at(e + 2) = v.z;
    at(e + 3) = v.w;
  }
  __device__ __forceinline__ void open(int w0) {
    base = w0 & ~3;
    put(base, in.group(base >> 2));
    put(base + 4, in.group((base >> 2) + 1));
    ahead = in.group((base >> 2) + 2);
  }
  // make base <= w0 < base + 4 (see ChunkMem::seek).  The group that
  // enters the ring was requested at the last refill; the next one is
  // requested now and waited for only at the next refill.
  __device__ __forceinline__ void seek(int w0) {
    const int d = w0 - base;
    if (d >= 0 && d < 4) return;
    if (d >= 4 && d < 8) {
      put(base + 8, ahead);  // over words [base, base + 4)
      base += 4;
      ahead = in.group((base >> 2) + 2);
    } else {
      open(w0);
    }
  }
  __device__ __forceinline__ void peek64(int pos, uint32_t& lo,
                                         uint32_t& hi) const {
    const int i = pos >> 5;
    const uint32_t a = at(OFF_RING + (i & 7));
    const uint32_t b = at(OFF_RING + ((i + 1) & 7));
    const uint32_t c = at(OFF_RING + ((i + 2) & 7));
    lo = __funnelshift_r(a, b, pos & 31);
    hi = __funnelshift_r(b, c, pos & 31);
  }
  template <int KIND>
  __device__ __forceinline__ int canon(uint32_t pk, int& clen) const;
};

// The boundary-sum decode with every operand from shared memory, for the
// code-length alphabet (FROM = 1) and for what a lookup table does not
// hold (FROM = its bits + 1): no code of fewer than FROM bits matches, and
// the boundaries grow with the length, so rev15 is past all of those and
// only the lengths from FROM on are compared.  Out of line: it is rare,
// and it takes p and stride by value so that the lane's StreamMem can
// stay in registers.  Returns symbol | clen << 16, 0 when nothing matches.
template <int KIND, int FROM>
__device__ __noinline__ uint32_t canon_slow(const uint32_t* p, int stride,
                                            uint32_t pk) {
  const int rv = (int)(__brev(pk & 0x7FFFu) >> 17);
  int nge = FROM - 1;
#pragma unroll
  for (int l = FROM; l <= 15; ++l)
    nge += rv >= (int)p[(OFF_BND + KIND * 16 + l) * stride];
  if (nge >= 15) return 0;
  const int clen = nge + 1;
  int symidx = (int)p[(OFF_ADJ + KIND * 16 + clen) * stride] +
               (rv >> (15 - clen));
  symidx = min(max(symidx, 0), SYMS_BANK - 1);
  const int q = symidx / 3;
  return (uint32_t)bank_symbol(p[(OFF_SYMS + q) * stride], symidx, q) |
         ((uint32_t)clen << 16);
}

template <int KIND>
__device__ __forceinline__ int StreamMem::canon(uint32_t pk,
                                                int& clen) const {
  uint32_t r;
  if (KIND == 0) {
    r = canon_slow<0, 1>(p, stride, pk);
  } else {
    constexpr int BITS = KIND == 1 ? LIT_LUT_BITS : DIST_LUT_BITS;
    constexpr int E0 = KIND == 1 ? 0 : (1 << LIT_LUT_BITS);
    const uint32_t e = lut_at(E0 + (int)(pk & ((1u << BITS) - 1u)));
    if (e != 0) {
      clen = (int)(e >> LUT_LEN_SHIFT);
      return (int)(e & ((1u << LUT_LEN_SHIFT) - 1u));
    }
    r = canon_slow<KIND, BITS + 1>(p, stride, pk);
  }
  clen = (int)(r >> 16);
  return (int)(r & 0xFFFFu);
}

// One step of the lane's state machine.  Returns true when the lane is at
// a fixed point: stalled for input, or in S_WAIT, S_DONE, S_ERR or S_FULL.
template <class MEM>
__device__ __forceinline__ bool step(Lane& L, MEM& M, int has_dict,
                                     uint32_t& token, uint32_t& token2) {
  const int s = L.state;
  const int avail = L.nbits - L.bitpos;
  M.seek(L.bitpos >> 5);
  // 64 bits at the cursor: every field of a step's first token lies in
  // them (at most 20 bits of literal/length, then 28 of distance), so its
  // windows are shifts of these two registers
  uint32_t pk, pk_hi;
  M.peek64(L.bitpos, pk, pk_hi);

  int consume = 0, nstate = s;
  token = 0;
  token2 = 0;
  bool stalled = false;
  const int end_next = L.fin > 0 ? S_DONE : S_BHDR;

  if (s == S_SYM) {  // literal (pair) / EOB / whole match
    do {
      int clen;
      const int sym = M.template canon<1>(pk, clen);
      if (clen == 0) {
        if (avail < M.maxlen(1)) stalled = true; else nstate = S_ERR;
        break;
      }
      if (clen > avail) {
        stalled = true;
        break;
      }
      if (sym == 256) {
        consume = clen;
        nstate = end_next;
        break;
      }
      if (sym > 285) {
        nstate = S_ERR;
        break;
      }
      if (sym < 256) {
        if (L.dst_pos >= L.cap) {
          nstate = S_FULL;
          L.status = RES_EFULL;
          L.resume_state = s;
          break;
        }
        // a second literal rides along when it fits
        int clen2;
        const int sym2 =
            M.template canon<1>(__funnelshift_r(pk, pk_hi, clen), clen2);
        const bool lit2 = clen2 > 0 && sym2 < 256 && clen2 <= avail - clen &&
                          L.dst_pos + 1 < L.cap;
        token = (TOK_LIT << 30) | (uint32_t)sym |
                (lit2 ? TOK_LIT_PAIR_BIT | ((uint32_t)sym2 << 8) : 0u);
        consume = clen + (lit2 ? clen2 : 0);
        L.dst_pos += lit2 ? 2 : 1;
      } else {
        int leb;
        const int len_v = length_from_sym(sym, pk, clen, leb);
        const int c1 = clen + leb;
        const uint32_t pk2 = __funnelshift_r(pk, pk_hi, c1);
        const int avail2 = avail - c1;
        int clen2, deb;
        const int dsym = M.template canon<2>(pk2, clen2);
        const int dv = dist_from_sym(dsym, pk2, clen2, deb);
        // the code first: a hole or a distance code of 30 or 31 is an
        // error before any extra bits are read (the oracle's order)
        if (clen2 == 0 ? avail2 < M.maxlen(2) : clen2 > avail2) {
          stalled = true;
          break;
        }
        if (clen2 == 0 || dsym > 29) {
          nstate = S_ERR;  // no code, or no distance symbol
          break;
        }
        if (clen2 + deb > avail2) {
          stalled = true;
          break;
        }
        if (dv > L.dst_pos + L.reach) {
          nstate = S_ERR;  // too far back
          break;
        }
        if (L.dst_pos + len_v > L.cap) {
          nstate = S_FULL;
          L.status = RES_EFULL;
          L.resume_state = s;
          break;
        }
        token = (TOK_MATCH << 30) | ((uint32_t)(len_v - 3) << 21) |
                (uint32_t)(dv - 1);
        consume = c1 + clen2 + deb;
        L.dst_pos += len_v;
      }
      // opportunistic second token: defer-only, no error paths; whatever
      // does not fit is decoded next step as a primary
      const int b3 = consume, avail3 = avail - consume;
      // b3 <= 48, so the 64 bits at the cursor still hold the 15 a code
      // can take; only a match reads past them
      uint32_t pk3 = b3 < 32 ? __funnelshift_r(pk, pk_hi, b3)
                             : pk_hi >> (b3 - 32);
      int clen3;
      const int sym3 = M.template canon<1>(pk3, clen3);
      if (clen3 == 0 || clen3 > avail3) break;
      if (sym3 < 256) {
        if (L.dst_pos < L.cap) {
          token2 = (TOK_LIT << 30) | (uint32_t)sym3;
          consume += clen3;
          L.dst_pos += 1;
        }
      } else if (sym3 == 256) {
        consume += clen3;
        nstate = end_next;
      } else if (sym3 <= 285) {
        uint32_t pk3_hi;  // the match's own 64 bits: 20 of length, 28 of
        M.peek64(L.bitpos + b3, pk3, pk3_hi);  // distance
        int leb3;
        const int len3 = length_from_sym(sym3, pk3, clen3, leb3);
        const int c31 = clen3 + leb3;
        const uint32_t pk4 = __funnelshift_r(pk3, pk3_hi, c31);
        int clen4, deb4;
        const int dsym4 = M.template canon<2>(pk4, clen4);
        const int dv4 = dist_from_sym(dsym4, pk4, clen4, deb4);
        if (clen4 > 0 && clen4 + deb4 <= avail3 - c31 && dsym4 <= 29 &&
            dv4 <= L.dst_pos + L.reach && L.dst_pos + len3 <= L.cap) {
          token2 = (TOK_MATCH << 30) | ((uint32_t)(len3 - 3) << 21) |
                   (uint32_t)(dv4 - 1);
          consume += c31 + clen4 + deb4;
          L.dst_pos += len3;
        }
      }
    } while (false);
  } else {
    switch (s) {
      case S_ZHDR: {
        const int cmf = pk & 0xFF, flg = (pk >> 8) & 0xFF;
        const bool zok = (cmf & 0xF) == 8 && (cmf >> 4) <= 7 &&
                         ((cmf << 8) + flg) % 31 == 0;
        if (avail < 16) {
          stalled = true;
        } else if (!zok) {
          nstate = S_ERR;
        } else {
          nstate = (flg & 0x20) ? (has_dict ? S_DICTID : S_ERR) : S_BHDR;
          consume = 16;
        }
        break;
      }
      case S_DICTID:
        if (avail < 32) {
          stalled = true;
        } else {
          nstate = S_BHDR;
          consume = 32;
        }
        break;
      case S_BHDR: {
        if (L.bitpos >= L.limit) {  // split decode: the segment is complete
          nstate = S_DONE;
          break;
        }
        if (avail < 3) {
          stalled = true;
          break;
        }
        const int bt = (pk >> 1) & 3;
        L.fin = pk & 1;
        nstate = bt == 0 ? S_STORED_HDR
               : bt == 1 ? S_WAIT
               : bt == 2 ? S_CLEN_HDR : S_ERR;
        if (bt != 3) consume = 3;
        if (bt == 1) L.need_build = 3;
        break;
      }
      case S_STORED_HDR:  // byte-align (reads no content)
        nstate = S_STORED_LEN;
        consume = (-L.bitpos) & 7;
        break;
      case S_STORED_LEN: {
        if (avail < 32) {
          stalled = true;
          break;
        }
        const int slen = pk & 0xFFFF;
        if (slen != (int)(~(pk >> 16) & 0xFFFF)) {
          nstate = S_ERR;
          break;
        }
        nstate = slen == 0 ? end_next : S_STORED;
        consume = 32;
        L.idx = slen;
        break;
      }
      case S_STORED: {  // input-offset tokens (reads no bits)
        const int space = L.cap - L.dst_pos;
        const int run_avail = min(min(min(L.idx, STORED_MAX_RUN), space),
                                  avail >> 3);
        if (space == 0) {
          nstate = S_FULL;
          L.status = RES_EFULL;
          L.resume_state = s;
        } else if (space > 0 && run_avail > 0) {
          token = (TOK_STORED << 30) | ((uint32_t)(run_avail - 1) << 22) |
                  (uint32_t)((L.bitpos >> 3) - L.in_base);
          consume = run_avail << 3;
          L.dst_pos += run_avail;
          L.idx -= run_avail;
          if (L.idx == 0) nstate = end_next;
        } else if (space > 0) {
          stalled = true;
        }
        break;
      }
      case S_CLEN_HDR: {
        if (avail < 14) {
          stalled = true;
          break;
        }
        const int h_lit = 257 + (pk & 31), h_dist = 1 + ((pk >> 5) & 31);
        if (h_lit > 286 || h_dist > 30) {
          nstate = S_ERR;
          break;
        }
        nstate = S_CLEN_LENS;
        consume = 14;
        L.hlit = h_lit;
        L.hdist = h_dist;
        L.hclen = 4 + ((pk >> 10) & 15);
        L.idx = 0;
        L.cl_lo = 0;
        L.cl_hi = 0;
        break;
      }
      case S_CLEN_LENS: {
        if (avail < 3) {
          stalled = true;
          break;
        }
        const int ordi = kClOrder[min(max(L.idx, 0), 18)];
        const uint32_t v3 = pk & 7u, sh3 = 3u * ordi;
        if (ordi < 10)
          L.cl_lo |= v3 << (sh3 & 31u);
        else
          L.cl_hi |= v3 << ((sh3 - 30u) & 31u);
        consume = 3;
        L.idx += 1;
        if (L.idx >= L.hclen) {
          L.need_build = 1;
          nstate = S_WAIT;
        }
        break;
      }
      case S_LENS: {  // one code-length symbol -> packed lens nibbles
        int clen;
        const int sym = M.template canon<0>(pk, clen);
        if (clen == 0) {
          if (avail < M.maxlen(0)) stalled = true; else nstate = S_ERR;
          break;
        }
        if (clen > avail) {
          stalled = true;
          break;
        }
        if (sym == 16 && L.idx == 0) {  // a repeat with nothing before it:
          nstate = S_ERR;               // an error before its extra bits
          break;
        }
        const int ebits = sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0;
        if (clen + ebits > avail) {
          stalled = true;
          break;
        }
        const int ev = (int)extract(pk, clen, ebits);
        const int rep = sym < 16 ? 1 : (sym == 16 || sym == 17) ? 3 + ev
                                                                : 11 + ev;
        const int wval = sym < 16 ? sym : sym == 16 ? L.prev : 0;
        if (L.idx + rep > L.hlit + L.hdist) {
          nstate = S_ERR;
          break;
        }
        if (wval > 0) {  // OR nibbles [idx, idx+rep) (all in lens words)
          const uint32_t splat = (uint32_t)wval * 0x11111111u;
          for (int wi = L.idx >> 3; wi <= (L.idx + rep - 1) >> 3; ++wi) {
            const int lo = min(max(L.idx - 8 * wi, 0), 8);
            const int hi = min(max(L.idx + rep - 8 * wi, 0), 8);
            const int cnt = hi - lo;
            const uint32_t mw = cnt >= 8 ? 0xFFFFFFFFu
                : ((1u << (4 * cnt)) - 1u) << (4 * lo);
            M.lens_or(wi, splat & mw);
          }
        }
        consume = clen + ebits;
        if (sym < 16) L.prev = sym;
        else if (sym == 17 || sym == 18) L.prev = 0;
        L.idx += rep;
        if (L.idx == L.hlit + L.hdist) {
          L.need_build = 2;
          nstate = S_WAIT;
        }
        break;
      }
      default:  // S_WAIT, S_DONE, S_ERR, S_FULL: nothing to do
        break;
    }
  }

  if (stalled) L.status = RES_UNFINISHED;
  if (nstate == S_ERR) L.status = RES_ERR;
  if (nstate == S_DONE) L.status = RES_OK;
  L.state = nstate;
  L.bitpos += consume;
  return stalled || (nstate >= S_WAIT && nstate != S_SYM);
}

// ---- table builds (the stream kernel only) ----------------------------------

// One level of table KIND as a step reads it.
template <int KIND>
__device__ __forceinline__ void set_level(StreamMem& M, int l, int count,
                                          int first, int offs) {
  M.at(OFF_BND + KIND * 16 + l) = (uint32_t)((first + count) << (15 - l));
  M.at(OFF_ADJ + KIND * 16 + l) = (uint32_t)(offs - first);
  if (count > 0) M.mlen[KIND] = l;  // callers walk l upwards from 0
}

// The lookup table of KIND (1 LIT, 2 DIST) from the lane's count, first
// and offs rows and its symbol bank: every code of at most the table's
// bits fills the entries whose low bits are the code, first bit lowest.
template <int KIND>
__device__ __forceinline__ void fill_lut(const StreamMem& M,
                                         const int32_t* count,
                                         const int32_t* first,
                                         const int32_t* offs) {
  constexpr int BITS = KIND == 1 ? LIT_LUT_BITS : DIST_LUT_BITS;
  constexpr int E0 = KIND == 1 ? 0 : (1 << LIT_LUT_BITS);
  for (int i = 0; i < (1 << BITS); ++i) M.lut_at(E0 + i) = 0;
  for (int l = 1; l <= BITS; ++l) {
    const int c = min(count[KIND * 16 + l], 288);
    const int f = first[KIND * 16 + l], o = offs[KIND * 16 + l];
    for (int r = 0; r < c; ++r) {
      const int symidx = min(max(o + r, 0), SYMS_BANK - 1), q = symidx / 3;
      const int sym = bank_symbol(M.at(OFF_SYMS + q), symidx, q);
      const uint16_t e = (uint16_t)((sym & 0x1FF) | (l << LUT_LEN_SHIFT));
      for (int i = (int)(__brev((uint32_t)(f + r)) >> (32 - l));
           i < (1 << BITS); i += 1 << l)
        M.lut_at(E0 + i) = e;
    }
  }
}

// The canonical build of ops/tables.build_canonical for one lane, written
// the way _set_table writes it: count, first and offs (with the bank base)
// into the carry, the symbols in (length, symbol) order followed by the
// unused ones into the bank, maxlen, and what a step reads.  len_of(j) is
// symbol j's code length.  Returns the Kraft oversubscription.
template <int KIND, int SYMBOLS, int WIDTH, int BASE, class LEN>
__device__ __forceinline__ bool build_table(StreamMem& M, int32_t* count,
                                            int32_t* first, int32_t* offs,
                                            LEN len_of) {
#pragma unroll
  for (int l = 0; l < 16; ++l) M.at(OFF_CNT + l) = 0;
  for (int j = 0; j < SYMBOLS; ++j) M.at(OFF_CNT + len_of(j)) += 1;
  int used = SYMBOLS - (int)M.at(OFF_CNT);

  int left = 1, code = 0, off = 0, cprev = 0;
  bool oversub = false;
  M.mlen[KIND] = 0;
  count[KIND * 16] = 0;
  first[KIND * 16] = 0;
  offs[KIND * 16] = BASE;
  set_level<KIND>(M, 0, 0, 0, BASE);
#pragma unroll
  for (int l = 1; l < 16; ++l) {
    const int c = (int)M.at(OFF_CNT + l);
    left = 2 * left - c;  // goes negative once oversubscribed: no shift
    oversub |= left < 0;
    code = (code + cprev) << 1;
    count[KIND * 16 + l] = c;
    first[KIND * 16 + l] = code;
    offs[KIND * 16 + l] = off + BASE;
    set_level<KIND>(M, l, c, code, off + BASE);
    M.at(OFF_CNT + l) = (uint32_t)off;  // from here: the next free slot
    off += c;
    cprev = c;
  }

  for (int q = BASE / 3; q < (BASE + WIDTH) / 3; ++q) M.at(OFF_SYMS + q) = 0;
  for (int j = 0; j < SYMBOLS; ++j) {
    const int l = len_of(j);
    int p;
    if (l > 0) {
      p = (int)M.at(OFF_CNT + l);
      M.at(OFF_CNT + l) = (uint32_t)(p + 1);
    } else {
      p = used++;
    }
    p += BASE;
    const int q = p / 3;
    M.at(OFF_SYMS + q) |= (uint32_t)j << (10 * (p - 3 * q));
  }
  if (KIND != 0 && !oversub) fill_lut<KIND>(M, count, first, offs);
  return oversub;
}

// The step of a lane in S_WAIT: the build its need_build names
// (ops/inflate_batch.py _build_cl, _build_litdist, _build_fixed).
// count/first/offs point at the lane's [3][16] rows, maxlen at its [3].
__device__ __forceinline__ void build_step(Lane& L, StreamMem& M,
                                           int32_t* count, int32_t* first,
                                           int32_t* offs, int32_t* maxlen,
                                           int& sorted) {
  if (L.need_build == 1) {
    const uint32_t lo = L.cl_lo, hi = L.cl_hi;
    const bool bad = build_table<0, 19, 24, CL_BASE>(
        M, count, first, offs, [lo, hi](int j) {
          return (int)(((j < 10 ? lo : hi) >> (3 * (j < 10 ? j : j - 10))) &
                       7u);
        });
    maxlen[0] = M.mlen[0];
    for (int wi = 0; wi < LENS_WORDS; ++wi) M.at(OFF_LENS + wi) = 0;
    if (bad) {
      L.state = S_ERR;
      L.status = RES_ERR;
    } else {
      L.state = S_LENS;
      L.idx = 0;
      L.prev = 0;
    }
    sorted += 19;
  } else if (L.need_build == 2 || L.need_build == 3) {
    // a fixed block is the same build over RFC 1951's fixed lengths
    const bool fixed = L.need_build == 3;
    const int hlit = fixed ? 288 : L.hlit, hdist = fixed ? 32 : L.hdist;
    auto nib = [&M, fixed](int i) {
      if (fixed)
        return i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : i < 288 ? 8 : 5;
      return (int)((M.at(OFF_LENS + (i >> 3)) >> (4 * (i & 7))) & 0xFu);
    };
    const bool over_l = build_table<1, 288, 288, LIT_BASE>(
        M, count, first, offs,
        [&](int j) { return j < hlit ? nib(j) : 0; });
    const bool over_d = build_table<2, 32, 36, DIST_BASE_>(
        M, count, first, offs,
        [&](int k) { return k < hdist ? nib(hlit + k) : 0; });
    maxlen[1] = M.mlen[1];
    maxlen[2] = M.mlen[2];
    if (over_l || over_d || nib(256) == 0) {  // a block needs a real EOB
      L.state = S_ERR;
      L.status = RES_ERR;
    } else {
      L.state = S_SYM;
    }
    sorted += 320;
  }
  L.need_build = 0;
}

// ---- one lane of the stream kernel -----------------------------------------

// Runs lane `lane` from its carry to a fixed point or the end of its step
// budget.  smem: the block's shared memory; slot, lanes: this lane's place
// among the block's lanes.  meta[M_*] collect the call's totals.
__device__ __forceinline__ void stream_lane(
    uint32_t* smem, int slot, int lanes, int lane, int32_t* st,
    uint32_t* lens, int32_t* count, int32_t* first, int32_t* offs,
    int32_t* maxlen, uint32_t* syms, const uint32_t* words, size_t row_stride,
    int W, int vec, uint32_t* tok, meta_t* meta, int N, int n_steps,
    int has_dict) {
  const size_t n = (size_t)N;
  Lane L;
  L.load_state(st + lane, n);
  if (L.status != STATUS_RUNNING) return;  // a fixed point already

  StreamMem M;
  M.p = smem + slot;
  M.lut = reinterpret_cast<uint16_t*>(smem + (size_t)LANE_WORDS * lanes) +
          slot;
  M.stride = lanes;
  M.in = Row{words + (size_t)lane * row_stride, W, vec != 0};
  count += (size_t)lane * 48;
  first += (size_t)lane * 48;
  offs += (size_t)lane * 48;
  maxlen += (size_t)lane * 3;
  syms += (size_t)lane * SYMS_WORDS;
  // the carry's tables: a resumed lane may be in the middle of a block
#pragma unroll
  for (int kind = 0; kind < 3; ++kind) M.mlen[kind] = maxlen[kind];
  for (int i = 0; i < 48; ++i) {
    const int c = count[i], f = first[i];
    M.at(OFF_BND + i) = (uint32_t)((f + c) << (15 - (i & 15)));
    M.at(OFF_ADJ + i) = (uint32_t)(offs[i] - f);
  }
  for (int q = 0; q < SYMS_WORDS; q += 4) {
    const uint4 v = reinterpret_cast<const uint4*>(syms)[q >> 2];
    M.at(OFF_SYMS + q) = v.x;
    M.at(OFF_SYMS + q + 1) = v.y;
    M.at(OFF_SYMS + q + 2) = v.z;
    M.at(OFF_SYMS + q + 3) = v.w;
  }
  for (int wi = 0; wi < LENS_WORDS; ++wi)
    M.at(OFF_LENS + wi) = lens[wi * n + lane];
  fill_lut<1>(M, count, first, offs);
  fill_lut<2>(M, count, first, offs);
  M.open(L.bitpos >> 5);

  int k = 0, rows = 0, builds = 0, sorted = 0, stored = 0;
  uint32_t* slot0 = tok + lane;  // the step's first token slot
  long long t_build = 0;
  const long long t_start = clock64();
  while (k < n_steps) {
    bool fixed_point;
    if (L.state == S_WAIT && L.need_build != 0) {
      const long long t0 = clock64();
      build_step(L, M, count, first, offs, maxlen, sorted);
      t_build += clock64() - t0;
      ++builds;
      fixed_point = L.state == S_ERR;
    } else {
      uint32_t t1, t2;
      fixed_point = step(L, M, has_dict, t1, t2);
      if (t1 != 0) {  // the buffer arrives zero-filled: NOPs are not stored
        slot0[0] = t1;
        ++stored;
        if (t2 != 0) {
          slot0[n] = t2;
          ++stored;
        }
        rows = 2 * k + 2;
      }
      if (L.state == S_WAIT && L.need_build != 0) fixed_point = false;
    }
    ++k;
    slot0 += 2 * n;
    if (fixed_point) break;
  }

  L.store_state(st + lane, n);
  for (int wi = 0; wi < LENS_WORDS; ++wi)
    lens[wi * n + lane] = M.at(OFF_LENS + wi);
  if (builds > 0) {
    for (int q = 0; q < SYMS_WORDS; q += 4) {
      uint4 v;
      v.x = M.at(OFF_SYMS + q);
      v.y = M.at(OFF_SYMS + q + 1);
      v.z = M.at(OFF_SYMS + q + 2);
      v.w = M.at(OFF_SYMS + q + 3);
      reinterpret_cast<uint4*>(syms)[q >> 2] = v;
    }
    atomicAdd(meta + M_BUILDS, (meta_t)builds);
    atomicAdd(meta + M_SORTED, (meta_t)sorted);
    atomicAdd(meta + M_BUILD_CYCLES, (meta_t)t_build);
  }
  atomicMax(meta + M_ROWS, (meta_t)rows);
  atomicAdd(meta + M_STEPS, (meta_t)k);
  atomicAdd(meta + M_TOKENS, (meta_t)stored);
  atomicAdd(meta + M_LANE_CYCLES, (meta_t)(clock64() - t_start));
}

// ---- one lane of decode_chunk -----------------------------------------------

__device__ __forceinline__ void chunk_lane(
    int lane, int32_t* st, uint32_t* lens, const uint32_t* words,
    size_t row_stride, int W, int vec, const int32_t* bound, const int32_t* adjoff,
    const int32_t* maxlen, const uint32_t* syms, uint32_t* tok, int N, int K,
    int has_dict) {
  const size_t n = (size_t)N;
  Lane L;
  L.load_state(st + lane, n);
  ChunkMem M;
  M.adjoff = adjoff + lane;
  M.syms = syms + lane;
  M.lens_pk = lens + lane;
  M.n = n;
#pragma unroll
  for (int i = 0; i < 48; ++i) M.bnd[i] = bound[i * n + lane];
#pragma unroll
  for (int i = 0; i < 3; ++i) M.mlen[i] = maxlen[i * n + lane];
  M.in = Row{words + (size_t)lane * row_stride, W, vec != 0};
  M.open(L.bitpos >> 5);

  int k = 0;
  while (k < K) {
    uint32_t t1, t2;
    const bool fixed_point = step(L, M, has_dict, t1, t2);
    tok[(size_t)(2 * k) * n + lane] = t1;
    tok[(size_t)(2 * k + 1) * n + lane] = t2;
    ++k;
    if (fixed_point) break;  // nothing changes until the next chunk
  }
  for (; k < K; ++k) {  // this entry owns every slot of its chunk
    tok[(size_t)(2 * k) * n + lane] = 0;
    tok[(size_t)(2 * k + 1) * n + lane] = 0;
  }
  L.store_state(st + lane, n);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(256) decode_stream_kernel(
    int32_t* __restrict__ st, uint32_t* __restrict__ lens,
    int32_t* __restrict__ count, int32_t* __restrict__ first,
    int32_t* __restrict__ offs, int32_t* __restrict__ maxlen,
    uint32_t* __restrict__ syms, const uint32_t* __restrict__ words,
    size_t row_stride, int W, int vec, uint32_t* __restrict__ tok,
    meta_t* __restrict__ meta,
    const int32_t* __restrict__ order, int N, int n_steps, int has_dict,
    int lanes_per_warp) {
  extern __shared__ uint32_t smem[];
  // the first lanes_per_warp threads of each warp own a lane each; order
  // says which: the caller puts lanes with alike work side by side
  const int t = threadIdx.x & 31;
  if (t >= lanes_per_warp) return;
  const int lanes = (blockDim.x >> 5) * lanes_per_warp;
  const int slot = (threadIdx.x >> 5) * lanes_per_warp + t;
  if (blockIdx.x * lanes + slot >= N) return;
  const int lane = order[blockIdx.x * lanes + slot];
  stream_lane(smem, slot, lanes, lane, st, lens, count, first, offs, maxlen,
              syms, words, row_stride, W, vec, tok, meta, N, n_steps,
              has_dict);
}

__global__ void __launch_bounds__(THREADS) decode_chunk_kernel(
    int32_t* __restrict__ st, uint32_t* __restrict__ lens,
    const uint32_t* __restrict__ words, size_t row_stride, int W, int vec,
    const int32_t* __restrict__ bound, const int32_t* __restrict__ adjoff,
    const int32_t* __restrict__ maxlen, const uint32_t* __restrict__ syms,
    uint32_t* __restrict__ tok, int N, int K, int has_dict) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= N) return;
  chunk_lane(lane, st, lens, words, row_stride, W, vec, bound, adjoff, maxlen,
             syms, tok, N, K, has_dict);
}

// 16-byte loads need rows that start on 16-byte boundaries
inline int rows_vectorise(const void* words, int W) {
  return (W & 3) == 0 && (reinterpret_cast<uintptr_t>(words) & 15) == 0;
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// Plain C entries for ctypes: pointers to device memory, the caller's
// stream, and ints.  Each launches on `stream`, does not synchronise, and
// returns the first CUDA error (0 when the launch was accepted).  Each
// leaves the calling thread's current device as it found it: a launch on
// another card from a thread that works on one card (the sharded decode
// runs one thread per card) must not change what that thread's calls
// without a device argument mean.

namespace {

struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err != cudaSuccess) {
      prev = -1;
      return;
    }
    if (prev != device) err = cudaSetDevice(device);
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace

// One launch per decode: st [20, N], lens [40, N], count/first/offs
// [N, 3, 16], maxlen [N, 3] and syms [N, 116] are read and updated in
// place; tok [2 * n_steps, N] must arrive zero-filled; meta [8], 64-bit
// words, must arrive zeroed; order [N] is a permutation of the lanes, the order in which
// threads take them.  A block has `threads` threads (a multiple of 32, at
// most 256); the first `lanes_per_warp` of each warp own a lane, and a
// block's lanes share LANE_BYTES each of dynamic shared memory.  words is
// [N, W] with `shared` 0, or one body [W] that every lane reads with
// `shared` 1.
extern "C" int decode_stream_launch(
    void* st, void* lens, void* count, void* first, void* offs, void* maxlen,
    void* syms, const void* words, int W, int shared, void* tok, void* meta,
    const void* order, int N, int n_steps, int has_dict, int threads,
    int lanes_per_warp, void* stream, int device) {
  DeviceScope scope(device);
  cudaError_t err = scope.err;
  if (err != cudaSuccess) return (int)err;
  if (N <= 0) return 0;
  if (threads < 32 || (threads & 31) || lanes_per_warp < 1 ||
      lanes_per_warp > 32)
    return (int)cudaErrorInvalidValue;
  const int lanes = (threads >> 5) * lanes_per_warp;
  const size_t shmem = (size_t)LANE_BYTES * (size_t)lanes;
  if (shmem > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_stream_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shmem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it: the error is returned, not left set
      return (int)err;
    }
  }
  const int blocks = (N + lanes - 1) / lanes;
  decode_stream_kernel<<<blocks, threads, shmem, (cudaStream_t)stream>>>(
      (int32_t*)st, (uint32_t*)lens, (int32_t*)count, (int32_t*)first,
      (int32_t*)offs, (int32_t*)maxlen, (uint32_t*)syms,
      (const uint32_t*)words, shared ? (size_t)0 : (size_t)W, W,
      rows_vectorise(words, W), (uint32_t*)tok, (meta_t*)meta, (const int32_t*)order, N, n_steps, has_dict,
      lanes_per_warp);
  return (int)cudaGetLastError();
}

extern "C" int decode_chunk_launch(void* st, void* lens, const void* words,
                                   int W, int shared, const void* bound,
                                   const void* adjoff, const void* maxlen,
                                   const void* syms, void* tok, int N, int K,
                                   int has_dict, void* stream, int device) {
  DeviceScope scope(device);
  cudaError_t err = scope.err;
  if (err != cudaSuccess) return (int)err;
  if (N <= 0) return 0;
  const int blocks = (N + THREADS - 1) / THREADS;
  decode_chunk_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (int32_t*)st, (uint32_t*)lens, (const uint32_t*)words,
      shared ? (size_t)0 : (size_t)W, W, rows_vectorise(words, W),
      (const int32_t*)bound,
      (const int32_t*)adjoff, (const int32_t*)maxlen, (const uint32_t*)syms,
      (uint32_t*)tok, N, K, has_dict);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
