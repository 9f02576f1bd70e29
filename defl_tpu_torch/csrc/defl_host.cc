// defl_host.cc — native host codec of defl_tpu_torch (a copy of
// defl_tpu/native/defl_host.cc, built with g++ at first use).
//
// The C++ tier of the framework's runtime: a fast serial DEFLATE/zlib
// inflate + deflate used for host-side fallback (streams too large or too
// pathological for the device step budget), corpus staging, and as an
// independent second implementation cross-checked against the Python
// oracle and the device path.
//
// Plays the role the reference's hand-tuned C paths play there (fast
// two-level Huffman tables, infl.c:378-1104), but is a from-scratch
// implementation: 64-bit bit reservoir, root-10 two-level tables with
// extra-bits folded into entries, hash-chain LZ77 with lazy matching on
// the encode side.
//
// Exported ABI (ctypes, see defl_tpu_torch/runtime/native.py):
//   int  dt_inflate(src, srclen, dst, dstcap, *dstlen, flags)
//   int  dt_deflate(src, srclen, dst, dstcap, *dstlen, level, flags)
//   u32  dt_adler32(p, n, start)
//   u32  dt_crc32(p, n, start)
// Result codes match defl_tpu_torch.errors.Result (OK=0, UNFINISHED=2, ERR=-1,
// EFULL=-105).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int R_OK = 0;
constexpr int R_UNFINISHED = 2;
constexpr int R_ERR = -1;
constexpr int R_EFULL = -105;

// ---------------------------------------------------------------- bits ----
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t bits = 0;
  int n = 0;

  void refill() {
    if (n > 56) return;  // reservoir already full to capacity
    if (end - p >= 8) {
      // fast path: one unconditional 8-byte little-endian load tops the
      // reservoir up to >=57 bits (branch-free; the byte loop below cost
      // ~8 dependent iterations and dominated the per-symbol decode)
      uint64_t w;
      memcpy(&w, p, 8);
      bits |= w << n;
      p += (63 - n) >> 3;
      n |= 56;
      return;
    }
    while (n <= 56 && p < end) {
      bits |= (uint64_t)(*p++) << n;
      n += 8;
    }
  }
  // bits remaining including unread bytes
  int64_t total_avail() const { return n + 8 * (int64_t)(end - p); }
  uint32_t peek(int k) const { return (uint32_t)(bits & ((1u << k) - 1)); }
  void drop(int k) { bits >>= k; n -= k; }
  void align() { drop(n & 7); }
};

// ------------------------------------------------------------- tables -----
// Two-level decode table. Root 10 bits; longer codes chain to subtables.
// Entry: bit31 = sub pointer; else bits[0:4] = code length (0 = invalid),
// bits[4:13] = symbol, bits[16:24] = extra bits, bits[24:32] unused.
// Sub pointer: bits[0:4] = extra index bits, bits[4:20] = offset.
struct Table {
  static constexpr int kRoot = 10;
  uint32_t entry[1 << kRoot];
  uint32_t sub[1 << 15];  // generous; max subtable load is small
  int sub_used = 0;
  // longest assigned code length: gates the invalid-vs-need-input
  // decision so all engines error once maxlen bits are available
  // (matches core/oracle.py _decode_symbol semantics)
  int maxlen = 15;
};

inline uint32_t bitrev(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; i++) { r = (r << 1) | (v & 1); v >>= 1; }
  return r;
}

// Build canonical decode table from code lengths. Returns false on
// oversubscription or len > 15. Incomplete codes are allowed.
bool build_table(Table& t, const uint8_t* lens, int n) {
  int count[16] = {0};
  for (int s = 0; s < n; s++) {
    if (lens[s] > 15) return false;
    count[lens[s]]++;
  }
  count[0] = 0;
  int left = 1;
  for (int l = 1; l <= 15; l++) {
    left = (left << 1) - count[l];
    if (left < 0) return false;
  }
  int first[16] = {0};
  int offs[17] = {0};
  int code = 0;
  for (int l = 1; l <= 15; l++) {
    code = (code + count[l - 1]) << 1;
    first[l] = code;
    offs[l + 1] = offs[l] + count[l];
  }
  // symbols in canonical order
  int sorted[320];
  int fill[16];
  memcpy(fill, offs, sizeof(fill));
  for (int s = 0; s < n; s++)
    if (lens[s]) sorted[fill[lens[s]]++] = s;

  memset(t.entry, 0, sizeof(t.entry));
  t.sub_used = 0;
  t.maxlen = 0;
  for (int l = 15; l >= 1; l--) if (count[l]) { t.maxlen = l; break; }

  // roots
  for (int l = 1; l <= Table::kRoot; l++) {
    for (int r = 0; r < count[l]; r++) {
      int sym = sorted[offs[l] + r];
      uint32_t c = bitrev((uint32_t)(first[l] + r), l);
      uint32_t e = (uint32_t)l | ((uint32_t)sym << 4);
      for (uint32_t idx = c; idx < (1u << Table::kRoot); idx += 1u << l)
        t.entry[idx] = e;
    }
  }
  // long codes: group by low kRoot bits
  if (t.maxlen <= Table::kRoot) return true;

  // For each root index that some long code maps to, build a subtable of
  // (maxlen_for_prefix - kRoot) index bits.
  // Pass 1: per-prefix max extra bits.
  uint8_t pre_bits[1 << Table::kRoot];
  memset(pre_bits, 0, sizeof(pre_bits));
  for (int l = Table::kRoot + 1; l <= 15; l++) {
    for (int r = 0; r < count[l]; r++) {
      uint32_t c = bitrev((uint32_t)(first[l] + r), l);
      uint32_t pre = c & ((1u << Table::kRoot) - 1);
      uint8_t eb = (uint8_t)(l - Table::kRoot);
      if (eb > pre_bits[pre]) pre_bits[pre] = eb;
    }
  }
  // Pass 2: allocate subtables.
  for (uint32_t pre = 0; pre < (1u << Table::kRoot); pre++) {
    if (!pre_bits[pre]) continue;
    int eb = pre_bits[pre];
    int off = t.sub_used;
    t.sub_used += 1 << eb;
    if (t.sub_used > (int)(sizeof(t.sub) / sizeof(t.sub[0]))) return false;
    memset(t.sub + off, 0, sizeof(uint32_t) << eb);
    t.entry[pre] = 0x80000000u | ((uint32_t)off << 4) | (uint32_t)eb;
  }
  // Pass 3: fill subtable entries.
  for (int l = Table::kRoot + 1; l <= 15; l++) {
    for (int r = 0; r < count[l]; r++) {
      int sym = sorted[offs[l] + r];
      uint32_t c = bitrev((uint32_t)(first[l] + r), l);
      uint32_t pre = c & ((1u << Table::kRoot) - 1);
      uint32_t ptr = t.entry[pre];
      int eb = (int)(ptr & 0xF);
      int off = (int)((ptr >> 4) & 0xFFFF);
      uint32_t hi = c >> Table::kRoot;         // eb' = l - kRoot index bits
      uint32_t e = (uint32_t)l | ((uint32_t)sym << 4);
      for (uint32_t idx = hi; idx < (1u << eb); idx += 1u << (l - Table::kRoot))
        t.sub[off + idx] = e;
    }
  }
  return true;
}

// Decode one symbol; returns symbol or -1 (invalid) / -2 (need input).
inline int decode_sym(BitReader& b, const Table& t, int* used) {
  b.refill();
  uint32_t e = t.entry[b.bits & ((1u << Table::kRoot) - 1)];
  if (e & 0x80000000u) {
    int eb = (int)(e & 0xF);
    int off = (int)((e >> 4) & 0xFFFF);
    e = t.sub[off + ((b.bits >> Table::kRoot) & ((1u << eb) - 1))];
  }
  int len = (int)(e & 0xF);
  if (!len) return b.n >= t.maxlen ? -1 : -2;
  if (len > b.n) return -2;
  *used = len;
  return (int)((e >> 4) & 0x1FF);
}

// ------------------------------------------------------- format tables ----
const uint16_t kLenBase[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,35,43,
                              51,59,67,83,99,115,131,163,195,227,258};
const uint8_t kLenExtra[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,4,4,4,
                               4,5,5,5,5,0};
const uint16_t kDistBase[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,257,
                                385,513,769,1025,1537,2049,3073,4097,6145,8193,
                                12289,16385,24577};
const uint8_t kDistExtra[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,9,9,
                                10,10,11,11,12,12,13,13};
const uint8_t kClOrder[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15};

void fixed_lens(uint8_t* lit, uint8_t* dist) {
  int i = 0;
  for (; i < 144; i++) lit[i] = 8;
  for (; i < 256; i++) lit[i] = 9;
  for (; i < 280; i++) lit[i] = 7;
  for (; i < 288; i++) lit[i] = 8;
  for (i = 0; i < 32; i++) dist[i] = 5;
}

// ------------------------------------------------------------ inflate -----
struct Inflater {
  Table lit, dist;
  Table clt;
  uint8_t lens[320];
};

uint32_t adler32_impl(const uint8_t* p, uint64_t n, uint32_t start);

int inflate_impl(const uint8_t* src, uint64_t srclen, uint8_t* dst,
                 uint64_t dstcap, uint64_t* dstlen, int flags,
                 uint64_t* in_pos = nullptr) {
  BitReader b{src, src + srclen};
  uint64_t out = 0;
  *dstlen = 0;

  if (flags & 1) {  // zlib wrapper
    b.refill();
    if (b.n < 16) return R_UNFINISHED;
    uint32_t cmf = b.peek(8); b.drop(8);
    uint32_t flg = b.peek(8); b.drop(8);
    if ((cmf & 0xF) != 8 || (cmf >> 4) > 7) return R_ERR;
    if (((cmf << 8) + flg) % 31 != 0) return R_ERR;
    if (flg & 0x20) return R_ERR;  // FDICT: host one-shot path has no dict
  }

  static thread_local Inflater inf;
  bool final_blk = false;
  while (!final_blk) {
    b.refill();
    if (b.n < 3) return R_UNFINISHED;
    final_blk = b.peek(1); b.drop(1);
    uint32_t btype = b.peek(2); b.drop(2);

    if (btype == 0) {  // stored
      b.align();
      b.refill();
      if (b.n < 32) return R_UNFINISHED;
      uint32_t len = b.peek(16); b.drop(16);
      uint32_t nlen = b.peek(16); b.drop(16);
      if (len != (~nlen & 0xFFFF)) return R_ERR;
      if (out + len > dstcap) { *dstlen = out; return R_EFULL; }
      // drain reservoir bytes first, then memcpy
      while (len && b.n) { dst[out++] = (uint8_t)b.peek(8); b.drop(8); len--; }
      if ((uint64_t)(b.end - b.p) < len) return R_UNFINISHED;
      if (len) {
        memcpy(dst + out, b.p, len);
        b.p += len;   // manual cursor move: the fast refill's unaccounted
        b.bits = 0;   // reservoir residue (bits past n) is stale now
        out += len;
      }
      continue;
    }
    if (btype == 3) return R_ERR;

    if (btype == 1) {
      uint8_t ll[288], dl[32];
      fixed_lens(ll, dl);
      if (!build_table(inf.lit, ll, 288) || !build_table(inf.dist, dl, 32))
        return R_ERR;
    } else {  // dynamic
      b.refill();
      if (b.n < 14) return R_UNFINISHED;
      int hlit = 257 + (int)b.peek(5); b.drop(5);
      int hdist = 1 + (int)b.peek(5); b.drop(5);
      int hclen = 4 + (int)b.peek(4); b.drop(4);
      if (hlit > 286 || hdist > 30) return R_ERR;
      uint8_t cl[19] = {0};
      for (int i = 0; i < hclen; i++) {
        b.refill();
        if (b.n < 3) return R_UNFINISHED;
        cl[kClOrder[i]] = (uint8_t)b.peek(3); b.drop(3);
      }
      if (!build_table(inf.clt, cl, 19)) return R_ERR;
      int total = hlit + hdist;
      int i = 0, prev = 0;
      memset(inf.lens, 0, sizeof(inf.lens));
      while (i < total) {
        int used;
        int sym = decode_sym(b, inf.clt, &used);
        if (sym == -2) return R_UNFINISHED;
        if (sym < 0) return R_ERR;
        b.drop(used);
        if (sym < 16) { inf.lens[i++] = (uint8_t)sym; prev = sym; continue; }
        int rep, val = 0, eb = sym == 16 ? 2 : sym == 17 ? 3 : 7;
        int base = sym == 16 ? 3 : sym == 17 ? 3 : 11;
        b.refill();
        if (b.n < eb) return R_UNFINISHED;
        rep = base + (int)b.peek(eb); b.drop(eb);
        if (sym == 16) { if (i == 0) return R_ERR; val = prev; }
        else prev = 0;
        if (i + rep > total) return R_ERR;
        while (rep--) inf.lens[i++] = (uint8_t)val;
      }
      if (inf.lens[256] == 0) return R_ERR;
      if (!build_table(inf.lit, inf.lens, hlit)) return R_ERR;
      if (!build_table(inf.dist, inf.lens + hlit, hdist)) return R_ERR;
    }

    // block body
    for (;;) {
      int used;
      int sym = decode_sym(b, inf.lit, &used);
      if (sym == -2) { *dstlen = out; return R_UNFINISHED; }
      if (sym < 0) return R_ERR;
      b.drop(used);
      if (sym < 256) {
        if (out >= dstcap) { *dstlen = out; return R_EFULL; }
        dst[out++] = (uint8_t)sym;
        continue;
      }
      if (sym == 256) break;
      if (sym > 285) return R_ERR;
      int eb = kLenExtra[sym - 257];
      b.refill();
      if (b.n < eb) { *dstlen = out; return R_UNFINISHED; }
      uint32_t length = kLenBase[sym - 257] + b.peek(eb); b.drop(eb);

      int dsym = decode_sym(b, inf.dist, &used);
      if (dsym == -2) { *dstlen = out; return R_UNFINISHED; }
      if (dsym < 0 || dsym > 29) return R_ERR;
      b.drop(used);
      eb = kDistExtra[dsym];
      b.refill();
      if (b.n < eb) { *dstlen = out; return R_UNFINISHED; }
      uint32_t distv = kDistBase[dsym] + b.peek(eb); b.drop(eb);
      if (distv > out) return R_ERR;
      if (out + length > dstcap) { *dstlen = out; return R_EFULL; }
      // overlapping-safe copy
      uint8_t* d = dst + out;
      const uint8_t* s = d - distv;
      out += length;
      if (distv >= length) {
        memcpy(d, s, length);
      } else {
        for (uint32_t k = 0; k < length; k++) d[k] = s[k];
      }
    }
  }
  if (in_pos) {
    // reference input_pos semantics (infl.h:180-184, mem.c:296-329):
    // whole unread bytes prefetched into the bit buffer don't count; a
    // partially consumed final byte counts as consumed.  Captured at the
    // final block's EOB, before any trailer read.
    int64_t consumed_bits = 8 * (int64_t)srclen - b.total_avail();
    *in_pos = (uint64_t)((consumed_bits + 7) / 8);
  }
  if ((flags & 1) && (flags & 2)) {
    // FLAG_VERIFY_ADLER32 extension: 4 big-endian trailer bytes after the
    // byte-aligned end of the final block (reference never checks it)
    b.align();
    b.refill();
    if (b.n < 32) { *dstlen = out; return R_UNFINISHED; }
    uint32_t stored = 0;
    for (int k = 0; k < 4; k++) {
      stored = (stored << 8) | b.peek(8);
      b.drop(8);
    }
    if (stored != adler32_impl(dst, out, 1)) { *dstlen = out; return R_ERR; }
  }
  *dstlen = out;
  return R_OK;
}

// ----------------------------------------------------------- checksums ----
uint32_t adler32_impl(const uint8_t* p, uint64_t n, uint32_t start) {
  uint32_t a = start & 0xFFFF, s = start >> 16;
  while (n) {
    uint64_t blk = n > 5552 ? 5552 : n;
    n -= blk;
    while (blk--) { a += *p++; s += a; }
    a %= 65521; s %= 65521;
  }
  return (s << 16) | a;
}

uint32_t crc_table[8][256];
bool crc_init_done = false;
void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ ((c & 1) ? 0xEDB88320u : 0);
    crc_table[0][i] = c;
  }
  for (int t = 1; t < 8; t++)
    for (uint32_t i = 0; i < 256; i++)
      crc_table[t][i] = crc_table[0][crc_table[t - 1][i] & 0xFF] ^
                        (crc_table[t - 1][i] >> 8);
  crc_init_done = true;
}

uint32_t crc32_impl(const uint8_t* p, uint64_t n, uint32_t start) {
  if (!crc_init_done) crc_init();
  uint32_t c = ~start;
  while (n >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = crc_table[7][lo & 0xFF] ^ crc_table[6][(lo >> 8) & 0xFF] ^
        crc_table[5][(lo >> 16) & 0xFF] ^ crc_table[4][lo >> 24] ^
        crc_table[3][hi & 0xFF] ^ crc_table[2][(hi >> 8) & 0xFF] ^
        crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = crc_table[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return ~c;
}

// ------------------------------------------------------------ deflate -----
struct BitWriter {
  uint8_t* p;
  uint8_t* end;
  uint64_t acc = 0;
  int n = 0;
  bool overflow = false;

  void put(uint32_t v, int nb) {
    acc |= (uint64_t)(v & ((1u << nb) - 1)) << n;
    n += nb;
    while (n >= 8) {
      if (p >= end) { overflow = true; n = 0; acc = 0; return; }
      *p++ = (uint8_t)acc;
      acc >>= 8;
      n -= 8;
    }
  }
  void put_code(uint32_t code, int nb) { put(bitrev(code, nb), nb); }
  void align() { if (n) put(0, 8 - n); }
};

// Huffman code-length construction (package of counts, heap-free):
// simple O(n log n) via sorting freqs; depth-limit with Kraft fixup.
struct HNode { uint64_t f; int a, b, sym; };

void huff_lengths(const uint32_t* freq, int n, int maxlen, uint8_t* lens) {
  // collect used symbols
  int used[320], nu = 0;
  for (int i = 0; i < n; i++) { lens[i] = 0; if (freq[i]) used[nu++] = i; }
  if (nu == 0) return;
  if (nu == 1) { lens[used[0]] = 1; return; }

  HNode nodes[640];
  int nn = 0;
  for (int i = 0; i < nu; i++) nodes[nn++] = {freq[used[i]], -1, -1, used[i]};
  // simple heap
  auto cmp = [](const HNode& x, const HNode& y) { return x.f < y.f; };
  // build via repeated min selection over an index heap
  int heap[640], hs = 0;
  auto push = [&](int idx) {
    heap[hs++] = idx;
    for (int c = hs - 1; c && cmp(nodes[heap[c]], nodes[heap[(c-1)/2]]); c = (c-1)/2) {
      int t = heap[c]; heap[c] = heap[(c-1)/2]; heap[(c-1)/2] = t;
    }
  };
  auto pop = [&]() {
    int top = heap[0];
    heap[0] = heap[--hs];
    for (int c = 0;;) {
      int l = 2*c+1, r = 2*c+2, m = c;
      if (l < hs && cmp(nodes[heap[l]], nodes[heap[m]])) m = l;
      if (r < hs && cmp(nodes[heap[r]], nodes[heap[m]])) m = r;
      if (m == c) break;
      int t = heap[c]; heap[c] = heap[m]; heap[m] = t;
      c = m;
    }
    return top;
  };
  for (int i = 0; i < nu; i++) push(i);
  while (hs > 1) {
    int a = pop(), bI = pop();
    nodes[nn] = {nodes[a].f + nodes[bI].f, a, bI, -1};
    push(nn++);
  }
  // depths
  int depth[640];
  depth[nn - 1] = 0;
  int bl_count[64] = {0};
  for (int i = nn - 1; i >= 0; i--) {
    if (nodes[i].a >= 0) {
      depth[nodes[i].a] = depth[i] + 1;
      depth[nodes[i].b] = depth[i] + 1;
    } else {
      int d = depth[i] ? depth[i] : 1;
      bl_count[d < 63 ? d : 63]++;
    }
  }
  // Depth-limit fixup with EXACT Kraft accounting.  Clamping deep
  // leaves to maxlen oversubscribes the tree by a fractional amount per
  // leaf, so counting clamped leaves (zlib's `overflow -= 2`) can stop
  // short for tree shapes our tree build produces (emitted headers then
  // carry an oversubscribed codelen tree every conformant decoder
  // rejects — caught by encoder round-trip fuzz).  Instead measure
  // oversubscription in integer units of 2^-maxlen and remove exactly
  // that many: each op turns a leaf at depth d into an internal node
  // whose children are that leaf one deeper plus a leaf pulled up from
  // maxlen — net one unit removed, leaf count preserved.
  int overflow = 0;
  for (int d = maxlen + 1; d < 64; d++) overflow += bl_count[d];
  if (overflow) {
    bl_count[maxlen] += overflow;
    for (int d = maxlen + 1; d < 64; d++) bl_count[d] = 0;
    int64_t units = 0;
    for (int d = 1; d <= maxlen; d++)
      units += (int64_t)bl_count[d] << (maxlen - d);
    while (units > ((int64_t)1 << maxlen)) {
      int d = maxlen - 1;
      while (d > 0 && !bl_count[d]) d--;
      if (d == 0) break;  // unreachable: all-at-maxlen can't oversubscribe
      bl_count[d]--;
      bl_count[d + 1] += 2;
      bl_count[maxlen]--;
      units -= 1;
    }
  }
  // assign: leaves sorted by (depth, sym) get lengths from histogram
  // order leaves by original depth then symbol
  int leaf[320]; int nl = 0;
  for (int i = 0; i < nn; i++)
    if (nodes[i].sym >= 0) leaf[nl++] = i;
  // insertion sort by (depth, sym) — n <= 288
  for (int i = 1; i < nl; i++) {
    int x = leaf[i], j = i - 1;
    int dx = depth[x] ? depth[x] : 1;
    while (j >= 0) {
      int dy = depth[leaf[j]] ? depth[leaf[j]] : 1;
      if (dy < dx || (dy == dx && nodes[leaf[j]].sym < nodes[x].sym)) break;
      leaf[j + 1] = leaf[j];
      j--;
    }
    leaf[j + 1] = x;
  }
  int li = 0;
  for (int d = 1; d <= maxlen; d++)
    for (int c = 0; c < bl_count[d]; c++)
      lens[nodes[leaf[li++]].sym] = (uint8_t)d;
}

void assign_codes(const uint8_t* lens, int n, uint16_t* codes) {
  int count[16] = {0};
  for (int i = 0; i < n; i++) count[lens[i]]++;
  count[0] = 0;
  int next[16], code = 0;
  for (int l = 1; l <= 15; l++) { code = (code + count[l - 1]) << 1; next[l] = code; }
  for (int i = 0; i < n; i++)
    codes[i] = lens[i] ? (uint16_t)next[lens[i]]++ : 0;
}

int len_to_sym(uint32_t len) {
  if (len <= 10) return 257 + (int)len - 3;
  if (len == 258) return 285;
  for (int i = 28; i >= 0; i--)
    if (len >= kLenBase[i]) return 257 + i;
  return 257;
}

int dist_to_sym(uint32_t d) {
  for (int i = 29; i >= 0; i--)
    if (d >= kDistBase[i]) return i;
  return 0;
}

struct Token { uint32_t v; };  // <256 literal; else (len<<16)|dist

constexpr int kHash4Bits = 16;
constexpr int kHash3Bits = 14;
constexpr int kMinMatch = 3;
constexpr int kMaxMatch = 258;
constexpr int kMaxDist = 32768;
// a 3-byte match beyond this distance costs more bits than 3 literals
// (dist code + up to 13 extra bits) — zlib applies the same cutoff
constexpr int kTooFar3 = 4096;

// Two-table matcher (libdeflate-style): 4-byte-hash chains carry the
// real search (far fewer collisions than 3-byte chains on structured
// data), and a single-probe 3-byte-hash head recovers nearby length-3
// matches that the 4-byte hash cannot see.
struct Matcher {
  int32_t head4[1 << kHash4Bits];
  int32_t head3[1 << kHash3Bits];
  int32_t* prev;
};

inline uint32_t hash4(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return (v * 2654435761u) >> (32 - kHash4Bits);
}

inline uint32_t hash3(const uint8_t* p) {
  uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
  return (v * 506832829u) >> (32 - kHash3Bits);
}

// Emit one block of tokens with dynamic or fixed or stored encoding,
// choosing the cheapest.  Templated over the writer so the same block
// logic drives both the serial BitWriter and the FieldWriter that feeds
// the device bit-pack kernel (ops/huffman_pack.py) — identical put()
// sequences make the two encode paths byte-identical by construction.
template <class W>
void emit_block(W& w, const Token* toks, int ntok,
                const uint8_t* raw, uint64_t rawlen, bool final_blk) {
  uint32_t lit_freq[288] = {0}, dist_freq[32] = {0};
  uint64_t extra_bits = 0;
  for (int i = 0; i < ntok; i++) {
    uint32_t t = toks[i].v;
    if (t < 256) { lit_freq[t]++; continue; }
    uint32_t len = t >> 16, d = t & 0xFFFF;
    int ls = len_to_sym(len), ds = dist_to_sym(d);
    lit_freq[ls]++; dist_freq[ds]++;
    extra_bits += kLenExtra[ls - 257] + kDistExtra[ds];
  }
  lit_freq[256]++;

  // zero-init the full arrays: huff_lengths fills only [0, n) but
  // assign_codes scans all 288/32 — stack garbage in ll[286..287] /
  // dl[30..31] would shift every canonical code (uninitialized read,
  // found by cross-process-nondeterministic encoder fuzz)
  uint8_t ll[288] = {0}, dl[32] = {0};
  huff_lengths(lit_freq, 286, 15, ll);
  huff_lengths(dist_freq, 30, 15, dl);
  bool any_dist = false;
  for (int i = 0; i < 30; i++) if (dl[i]) any_dist = true;
  if (!any_dist) dl[0] = 1;
  uint16_t lc[288], dc[32];
  assign_codes(ll, 288, lc);
  assign_codes(dl, 32, dc);

  // fixed lengths
  uint8_t fll[288], fdl[32];
  fixed_lens(fll, fdl);
  uint16_t flc[288], fdc[32];
  assign_codes(fll, 288, flc);
  assign_codes(fdl, 32, fdc);

  // dynamic header: RLE the length list
  int hlit = 257, hdist = 1;
  for (int i = 257; i < 286; i++) if (ll[i]) hlit = i + 1;
  for (int i = 0; i < 30; i++) if (dl[i]) hdist = i + 1;
  uint8_t all[320];
  memcpy(all, ll, hlit);
  memcpy(all + hlit, dl, hdist);
  int tot = hlit + hdist;

  // RLE
  struct Rle { uint8_t sym, ev, eb; };
  Rle rle[400]; int nr = 0;
  for (int i = 0; i < tot;) {
    uint8_t v = all[i];
    int run = 1;
    while (i + run < tot && all[i + run] == v) run++;
    if (v == 0) {
      int r = run;
      while (r >= 11) { int tk = r > 138 ? 138 : r; rle[nr++] = {18, (uint8_t)(tk - 11), 7}; r -= tk; }
      if (r >= 3) { rle[nr++] = {17, (uint8_t)(r - 3), 3}; r = 0; }
      while (r--) rle[nr++] = {0, 0, 0};
    } else {
      rle[nr++] = {v, 0, 0};
      int r = run - 1;
      while (r >= 3) { int tk = r > 6 ? 6 : r; rle[nr++] = {16, (uint8_t)(tk - 3), 2}; r -= tk; }
      while (r-- > 0) rle[nr++] = {v, 0, 0};
    }
    i += run;
  }
  uint32_t cl_freq[19] = {0};
  for (int i = 0; i < nr; i++) cl_freq[rle[i].sym]++;
  uint8_t cl_lens[19];
  huff_lengths(cl_freq, 19, 7, cl_lens);
  uint16_t cl_codes[19];
  assign_codes(cl_lens, 19, cl_codes);
  int hclen = 19;
  while (hclen > 4 && !cl_lens[kClOrder[hclen - 1]]) hclen--;

  // costs
  uint64_t dyn_cost = 14 + 3 * hclen + extra_bits;
  for (int i = 0; i < nr; i++) dyn_cost += cl_lens[rle[i].sym] + rle[i].eb;
  for (int i = 0; i < 288; i++) dyn_cost += (uint64_t)lit_freq[i] * ll[i];
  for (int i = 0; i < 30; i++) dyn_cost += (uint64_t)dist_freq[i] * dl[i];
  uint64_t fix_cost = extra_bits;
  for (int i = 0; i < 288; i++) fix_cost += (uint64_t)lit_freq[i] * fll[i];
  for (int i = 0; i < 30; i++) fix_cost += (uint64_t)dist_freq[i] * 5;
  uint64_t sto_cost = 7 + 32 + 8 * rawlen + 40 * (rawlen / 65535);

  if (raw && sto_cost < dyn_cost && sto_cost < fix_cost) {
    uint64_t off = 0;
    for (;;) {
      uint32_t take = rawlen - off > 65535 ? 65535 : (uint32_t)(rawlen - off);
      bool last = off + take == rawlen;
      w.put(final_blk && last ? 1 : 0, 1);
      w.put(0, 2);
      w.align();
      w.put(take & 0xFF, 8); w.put(take >> 8, 8);
      w.put(~take & 0xFF, 8); w.put((~take >> 8) & 0xFF, 8);
      for (uint32_t k = 0; k < take; k++) w.put(raw[off + k], 8);
      off += take;
      if (last) break;
    }
    return;
  }

  const uint8_t* ell = ll;
  const uint16_t* elc = lc;
  const uint8_t* edl = dl;
  const uint16_t* edc = dc;
  if (dyn_cost < fix_cost) {
    w.put(final_blk ? 1 : 0, 1);
    w.put(2, 2);
    w.put(hlit - 257, 5);
    w.put(hdist - 1, 5);
    w.put(hclen - 4, 4);
    for (int i = 0; i < hclen; i++) w.put(cl_lens[kClOrder[i]], 3);
    for (int i = 0; i < nr; i++) {
      w.put_code(cl_codes[rle[i].sym], cl_lens[rle[i].sym]);
      if (rle[i].eb) w.put(rle[i].ev, rle[i].eb);
    }
  } else {
    w.put(final_blk ? 1 : 0, 1);
    w.put(1, 2);
    ell = fll; elc = flc; edl = fdl; edc = fdc;
  }

  for (int i = 0; i < ntok; i++) {
    uint32_t t = toks[i].v;
    if (t < 256) { w.put_code(elc[t], ell[t]); continue; }
    uint32_t len = t >> 16, d = t & 0xFFFF;
    int ls = len_to_sym(len), ds = dist_to_sym(d);
    w.put_code(elc[ls], ell[ls]);
    if (kLenExtra[ls - 257]) w.put(len - kLenBase[ls - 257], kLenExtra[ls - 257]);
    w.put_code(edc[ds], edl[ds]);
    if (kDistExtra[ds]) w.put(d - kDistBase[ds], kDistExtra[ds]);
  }
  w.put_code(elc[256], ell[256]);
}

// zlib's configuration_table tuning: good = prev length above which the
// chain search shortens 4x; lazy_max = 0 for greedy levels, else the
// prev length at/above which lazy evaluation stops; nice = stop
// searching at this length.
struct LevelCfg { int max_chain; int good; int lazy_max; int nice; };
LevelCfg level_cfg(int level) {
  switch (level < 1 ? 1 : level > 9 ? 9 : level) {
    case 1: return {4, 4, 0, 8};
    case 2: return {8, 4, 0, 16};
    case 3: return {32, 4, 0, 32};
    case 4: return {16, 4, 4, 16};
    case 5: return {32, 8, 16, 32};
    case 6: return {128, 8, 16, 128};
    case 7: return {256, 8, 32, 128};
    case 8: return {1024, 32, 128, 258};
    default: return {4096, 32, 258, 258};
  }
}

// Matcher + block loop, templated over the bit sink (see emit_block).
// Ends with a byte-align; the zlib wrapper stays with the caller.
template <class W>
int deflate_core(const uint8_t* src, uint64_t n, W& w, int level) {
  LevelCfg cfg = level_cfg(level);

  if (n == 0) {
    w.put(1, 1); w.put(1, 2);
    w.put_code(0, 7);  // fixed EOB
  } else {
    Matcher m;
    m.prev = (int32_t*)malloc(n * sizeof(int32_t));
    if (!m.prev) return R_ERR;
    memset(m.head4, -1, sizeof(m.head4));
    memset(m.head3, -1, sizeof(m.head3));

    const int kBlockTokens = 16384;
    Token* toks = (Token*)malloc(kBlockTokens * sizeof(Token));
    int ntok = 0;
    uint64_t blk_start = 0;

    int64_t last_ins = (int64_t)n - kMinMatch + 1;
    int64_t last_ins4 = (int64_t)n - 4 + 1;
    int64_t ins = 0;
    auto insert_one = [&](int64_t k) {
      if (k < last_ins4) {
        uint32_t h = hash4(src + k);
        m.prev[k] = m.head4[h];
        m.head4[h] = (int32_t)k;
      } else {
        m.prev[k] = -1;
      }
      m.head3[hash3(src + k)] = (int32_t)k;
    };
    auto advance_insert = [&](int64_t limit) {
      int64_t stop = limit < last_ins ? limit : last_ins;
      while (ins < stop) insert_one(ins++);
    };
    auto match_len = [&](int64_t j, int64_t i, int limit) -> int {
      int l = 0;
      while (l + 8 <= limit) {
        uint64_t a, bb;
        memcpy(&a, src + j + l, 8);
        memcpy(&bb, src + i + l, 8);
        if (a != bb) return l + (__builtin_ctzll(a ^ bb) >> 3);
        l += 8;
      }
      while (l < limit && src[j + l] == src[i + l]) l++;
      return l;
    };
    auto longest = [&](int64_t i, int best_in, uint32_t* out_d) -> int {
      int best = best_in;
      uint32_t best_d = 0;
      int64_t limit64 = (int64_t)n - i;
      int limit = limit64 > kMaxMatch ? kMaxMatch : (int)limit64;
      if (limit < kMinMatch) return 0;
      int64_t lo = i - kMaxDist;
      if (lo < 0) lo = 0;
      // single probe for a nearby 3-byte match (4-byte chains can't see
      // them); beyond kTooFar3 a length-3 match loses to literals
      if (best < kMinMatch) {
        int32_t j3 = m.head3[hash3(src + i)];
        if (j3 >= 0 && j3 >= lo && i - j3 <= kTooFar3) {
          int l = match_len(j3, i, limit);
          if (l >= kMinMatch && l > best) {
            best = l;
            best_d = (uint32_t)(i - j3);
          }
        }
      }
      if (i < last_ins4) {
        int32_t j = m.head4[hash4(src + i)];
        int chain = cfg.max_chain;
        if (best_in >= cfg.good) chain >>= 2;  // prev match already good
        while (j >= 0 && j >= lo && chain-- && best < limit) {
          if (src[j + best] == src[i + best]) {
            int l = match_len(j, i, limit);
            if (l > best
                && (l > kMinMatch || (uint32_t)(i - j) <= kTooFar3)) {
              best = l;
              best_d = (uint32_t)(i - j);
              if (l >= cfg.nice) break;
            }
          }
          j = m.prev[j];
        }
      }
      if (best >= kMinMatch && best_d) { *out_d = best_d; return best; }
      return 0;
    };

    auto flush = [&](bool final_blk, uint64_t blk_end) {
      emit_block(w, toks, ntok, src + blk_start, blk_end - blk_start,
                 final_blk);
      ntok = 0;
      blk_start = blk_end;
    };

    // zlib deflate_slow structure: carry the previous position's match
    // and re-evaluate lazily at EVERY position (a one-shot defer misses
    // chains of improving matches on structured data), with the
    // good/lazy/nice speed heuristics from zlib's configuration table.
    // Levels 1-3 (lazy_max == 0) run the greedy variant.
    int64_t i = 0;
    int prev_len = 0;
    uint32_t prev_d = 0;
    bool have_prev = false;
    while ((uint64_t)i < n) {
      advance_insert(i);
      uint32_t d = 0;
      int len = 0;
      bool skip_search = have_prev && (prev_len >= cfg.lazy_max
                                       || prev_len >= cfg.nice);
      if (!skip_search && i + kMinMatch <= (int64_t)n)
        len = longest(i, have_prev ? prev_len : kMinMatch - 1, &d);
      if (have_prev) {
        if (len > prev_len) {
          // current position wins: the deferred byte becomes a literal
          toks[ntok++].v = src[i - 1];
          prev_len = len;
          prev_d = d;
          if (ntok == kBlockTokens) flush(false, i);
          i++;
        } else {
          toks[ntok++].v = ((uint32_t)prev_len << 16) | prev_d;
          i = (i - 1) + prev_len;
          have_prev = false;
          // never finalize mid-loop: a flush landing exactly at
          // end-of-input would otherwise mark its block final AND the
          // post-loop else branch would append a second empty final
          // block.  Finalization happens only after the loop.
          if (ntok == kBlockTokens) flush(false, i);
        }
        continue;
      }
      if (len >= kMinMatch && cfg.lazy_max && len < cfg.lazy_max
          && len < cfg.nice && i + 1 + kMinMatch <= (int64_t)n) {
        prev_len = len;   // defer: maybe i+1 has a longer match
        prev_d = d;
        have_prev = true;
        i++;
        continue;
      }
      if (len >= kMinMatch) {
        toks[ntok++].v = ((uint32_t)len << 16) | d;
        i += len;
      } else {
        toks[ntok++].v = src[i];
        i++;
      }
      if (ntok == kBlockTokens) flush(false, i);
    }
    if (have_prev)  // unreachable by construction; containment only
      toks[ntok++].v = ((uint32_t)prev_len << 16) | prev_d;
    if (ntok || blk_start != n) flush(true, n);
    else {
      // tokens flushed exactly at the end but block wasn't final:
      // emit an empty final fixed block
      w.put(1, 1); w.put(1, 2); w.put_code(0, 7);
    }
    free(toks);
    free(m.prev);
  }

  w.align();
  return R_OK;
}

int deflate_impl(const uint8_t* src, uint64_t n, uint8_t* dst,
                 uint64_t dstcap, uint64_t* dstlen, int level, int flags) {
  BitWriter w{dst, dst + dstcap};
  if (flags & 1) {
    uint32_t cmf = 0x78, flg = 0;
    uint32_t rem = ((cmf << 8) | flg) % 31;
    if (rem) flg += 31 - rem;
    w.put(cmf, 8); w.put(flg, 8);
  }
  int r = deflate_core(src, n, w, level);
  if (r != R_OK) return r;
  if (flags & 1) {
    uint32_t ad = adler32_impl(src, n, 1);
    w.put(ad >> 24, 8); w.put((ad >> 16) & 0xFF, 8);
    w.put((ad >> 8) & 0xFF, 8); w.put(ad & 0xFF, 8);
  }
  if (w.overflow) return R_EFULL;
  *dstlen = (uint64_t)(w.p - dst);
  return R_OK;
}

// ---------------------------------------- device-encode field export ------
// The host half of the hybrid TPU encoder: run the matcher + tree build
// + block logic (deflate_core) but record every put() as a (value <=16
// bits, nbits) FIELD instead of packing bits.  The device bit-pack
// kernel (ops/huffman_pack.py) then concatenates fields lane-parallel
// (prefix-sum of nbits -> word scatter) — byte-identical to BitWriter
// output by construction.  ≙ the encode half the reference declares but
// never builds (include/defl/defl.h:17-25).
struct FieldWriter {
  uint32_t* f;
  int64_t cap;
  int64_t n = 0;
  int64_t bits = 0;
  bool overflow = false;

  void put(uint32_t v, int nb) {
    if (!nb) return;
    if (n >= cap) { overflow = true; return; }
    f[n++] = ((uint32_t)nb << 16) | (v & 0xFFFF);
    bits += nb;
  }
  void put_code(uint32_t code, int nb) { put(bitrev(code, nb), nb); }
  void align() { if (bits & 7) put(0, (int)(8 - (bits & 7))); }
};

int deflate_fields_impl(const uint8_t* src, uint64_t n, uint32_t* fields,
                        int64_t fields_cap, int64_t* n_fields,
                        int64_t* total_bits, uint32_t* adler, int level) {
  FieldWriter w{fields, fields_cap};
  int r = deflate_core(src, n, w, level);
  *n_fields = w.n;
  *total_bits = w.bits;
  *adler = adler32_impl(src, n, 1);
  if (r != R_OK) return r;
  return w.overflow ? R_EFULL : R_OK;
}

// ----------------------------------------------------- token resolver -----
// Pass 2 of the hybrid device+host inflate: expand the TPU decoder's token
// stream (defl_tpu_torch/ops/inflate_batch.py encoding) into output bytes.
// One worker thread per group of lanes; each lane is pure sequential
// memcpy/copy work, so this runs at memory bandwidth.

struct ResolveArgs {
  const uint32_t* tokens;   // [N, T] row-major (lane-major)
  int64_t T;
  const uint8_t* input;     // [N, in_stride] packed compressed bytes
  uint64_t in_stride;
  uint8_t* out;             // [N, out_stride]
  uint64_t out_stride;
  uint64_t out_cap;         // usable bytes per lane row (= out_stride for
                            // strided batches; total buffer size when
                            // out_stride==0, the single-buffer stitch mode)
  const int32_t* dst_len;   // [N]
  const int32_t* dst_start; // [N] or null: out[0:dst_start) is pre-existing
                            // window content (incremental streaming resolve)
  const uint8_t* dict;
  uint32_t dict_len;
  int64_t in_cap;           // readable bytes from each lane's input base —
                            // bounds stored-run token reads so an
                            // adversarial/corrupt token word can never
                            // read out of bounds (≙ the containment rule
                            // that a bad lane must not crash the batch)
};

// Overlap-correct match copy with 8-byte overrunning stores (caller
// guarantees >=32 bytes of slack past d+len inside the lane's row).
// dist>=8 makes stride-8 word copies overlap-safe directly; 1<dist<8
// seeds the largest multiple of dist <= 8 byte-wise, then doubles the
// written region (region copies stay aligned to the pattern period).
static inline void copy_match_fast(uint8_t* d, const uint8_t* s,
                                   uint32_t len, uint32_t dist) {
  uint64_t w;
  if (dist == 1) {
    memset(d, s[0], len);
    return;
  }
  if (dist >= 8) {
    for (uint32_t k = 0; k < len; k += 8) {
      memcpy(&w, s + k, 8);
      memcpy(d + k, &w, 8);
    }
    return;
  }
  uint32_t period = dist * (8 / dist);  // largest multiple of dist <= 8
  if (len <= period) {
    for (uint32_t k = 0; k < len; k++) d[k] = s[k];
    return;
  }
  for (uint32_t k = 0; k < period; k++) d[k] = s[k];
  uint32_t written = period;
  while (written < len) {
    uint32_t chunk = written < len - written ? written : len - written;
    for (uint32_t k = 0; k < chunk; k += 8) {  // [d, d+written) -> tail
      memcpy(&w, d + k, 8);
      memcpy(d + written + k, &w, 8);
    }
    written += chunk;
  }
}

// Exact-semantics token step (tail region / dictionary / malformed
// containment; the fast loop below handles the bulk).  Returns false to
// stop the lane (malformed back-reference).
static inline bool resolve_token_exact(const ResolveArgs& a, uint32_t v,
                                       const uint8_t* in, uint8_t* out,
                                       int64_t& p, int64_t row_cap) {
  uint32_t kind = v >> 30;
  if (kind == 1) {
    // bound by the token's ACTUAL width: a single literal landing on the
    // last row byte is valid (a fixed p+2 check truncated the final
    // byte of capacity-exact lanes — caught by the full-corpus bench)
    int64_t width = 1 + ((v >> 16) & 1);
    if (p + width > row_cap) return false;  // malformed dst_len: contain
    out[p++] = (uint8_t)v;
    if (v & (1u << 16)) out[p++] = (uint8_t)(v >> 8);
    return true;
  }
  if (kind == 3) {
    uint32_t run = ((v >> 22) & 0xFF) + 1;
    int64_t off = (int64_t)(v & 0x3FFFFF);
    if (off + run > a.in_cap || p + run > row_cap) return false;
    memcpy(out + p, in + off, run);
    p += run;
    return true;
  }
  uint32_t len = ((v >> 21) & 0x1FF) + 3;
  uint32_t dist = (v & 0x7FFF) + 1;
  if (p + (int64_t)len > row_cap) return false;  // malformed: contain
  int64_t src = p - (int64_t)dist;
  if (src < -(int64_t)a.dict_len) return false;  // malformed: contain
  if (src < 0) {  // reaches into the shared preset dictionary
    uint32_t from_dict = (uint32_t)(-src);
    if (from_dict > len) from_dict = len;
    memcpy(out + p, a.dict + a.dict_len - (uint32_t)(-src), from_dict);
    p += from_dict;
    len -= from_dict;
    src = 0;
    if (!len) return true;
  }
  if (dist >= len) {
    memcpy(out + p, out + src, len);
  } else {
    uint8_t* d = out + p;
    const uint8_t* s = out + src;
    for (uint32_t k = 0; k < len; k++) d[k] = s[k];
  }
  p += len;
  return true;
}

void resolve_lane(const ResolveArgs& a, int64_t n) {
  const uint32_t* tok = a.tokens + n * a.T;
  const uint8_t* in = a.input + n * a.in_stride;
  uint8_t* out = a.out + n * a.out_stride;
  const int64_t row_cap = a.out_stride ? (int64_t)a.out_stride
                                       : (int64_t)a.out_cap;
  int64_t want = a.dst_len[n];
  if (want > row_cap) want = row_cap;  // lying dst_len: contain
  int64_t p = a.dst_start ? a.dst_start[n] : 0;
  if (p < 0 || p > row_cap) return;    // lying dst_start: contain
  // Fast region: while every possible emission (a match token ENCODES up
  // to 514B — the 9-bit len field is adversarial input even though the
  // decoder never emits >258 — plus stride-8 store overrun) stays inside
  // the row, no per-token capacity checks are needed and all stores may
  // overrun (stale bytes past the current position are overwritten by
  // later tokens or lie beyond dst_len).
  const int64_t fast_end =
      (row_cap - 576 < want ? row_cap - 576 : want);
  int64_t t = 0;
  uint64_t w;
  for (; t < a.T && p < fast_end; t++) {
    uint32_t v = tok[t];
    uint32_t kind = v >> 30;
    if (kind == 1) {
      // a literal token IS its output bytes in LE order: bits[7:0] the
      // byte, bits[15:8] the pair byte; one unconditional 4B store
      // (bytes past len are slack, overwritten by the next token)
      memcpy(out + p, &v, 4);
      p += 1 + ((v >> 16) & 1);
      continue;
    }
    if (kind == 2) {
      uint32_t len = ((v >> 21) & 0x1FF) + 3;
      uint32_t dist = (v & 0x7FFF) + 1;
      int64_t src = p - (int64_t)dist;
      if (__builtin_expect(src < 0, 0)) {
        if (!resolve_token_exact(a, v, in, out, p, row_cap)) return;
        continue;
      }
      const uint8_t* s = out + src;
      uint8_t* d = out + p;
      p += len;
      if (dist >= 8) {  // stride-8 overrunning copies are overlap-safe
        memcpy(&w, s, 8);
        memcpy(d, &w, 8);
        for (uint32_t k = 8; k < len; k += 8) {
          memcpy(&w, s + k, 8);
          memcpy(d + k, &w, 8);
        }
      } else {
        copy_match_fast(d, s, len, dist);
      }
      continue;
    }
    if (kind == 3) {
      uint32_t run = ((v >> 22) & 0xFF) + 1;
      int64_t off = (int64_t)(v & 0x3FFFFF);
      if (__builtin_expect(off + run > a.in_cap, 0)) return;  // contain
      memcpy(out + p, in + off, run);
      p += run;
    }
    // kind 0: NOP
  }
  // exact tail: per-token capacity semantics, no overruns
  for (; t < a.T && p < want; t++) {
    uint32_t v = tok[t];
    if ((v >> 30) == 0) continue;
    if (!resolve_token_exact(a, v, in, out, p, row_cap)) return;
  }
}

void resolve_all(const ResolveArgs& a, int64_t N, int n_threads) {
  if (n_threads <= 1) {
    for (int64_t n = 0; n < N; n++) resolve_lane(a, n);
    return;
  }
  std::vector<std::thread> ts;
  std::atomic<int64_t> next{0};
  for (int i = 0; i < n_threads; i++) {
    ts.emplace_back([&] {
      for (;;) {
        int64_t n = next.fetch_add(1);
        if (n >= N) return;
        resolve_lane(a, n);
      }
    });
  }
  for (auto& t : ts) t.join();
}

// ----------------------------------------- speculative block finder -------
// Rapidgzip-style re-sync (SURVEY §5 long-sequence row): find dynamic-
// block headers at arbitrary bit offsets so a single huge stream can be
// split into device lanes.  Two stages: a cheap bit filter (BTYPE==2,
// HLIT/HDIST bounds, complete codelen tree) kills ~99.98% of offsets;
// survivors get a full table-free header decode (codelen expansion,
// litlen completeness, EOB present).  False positives that survive both
// are caught later by the chain validation (lane k's end bit must equal
// lane k+1's start bit).

inline uint64_t bits_at(const uint8_t* src, int64_t bit) {
  uint64_t v;
  memcpy(&v, src + (bit >> 3), 8);  // little-endian hosts only
  return v >> (bit & 7);
}

// canonical decode without a table (19-symbol codelen alphabet)
struct MiniCanon {
  int count[8];
  int firstcode[8];
  int offs[8];
  uint8_t syms[19];

  bool init(const uint8_t* lens, int n) {  // lens values <= 7
    memset(count, 0, sizeof(count));
    for (int s = 0; s < n; s++) count[lens[s]]++;
    int code = 0, idx = 0, left = 1;
    for (int l = 1; l <= 7; l++) {
      left = (left << 1) - count[l];
      if (left < 0) return false;
      firstcode[l] = code;
      offs[l] = idx;
      idx += count[l];
      code = (code + count[l]) << 1;
    }
    if (left != 0) return false;  // demand a complete tree
    int k[8];
    memcpy(k, offs, sizeof(k));
    for (int s = 0; s < n; s++)
      if (lens[s]) syms[k[lens[s]]++] = (uint8_t)s;
    return true;
  }
  // returns symbol, sets *used; -1 if no code matches
  int decode(uint32_t peek7, int* used) const {
    uint32_t rev = bitrev(peek7 & 0x7F, 7);
    for (int l = 1; l <= 7; l++) {
      int c = (int)(rev >> (7 - l));
      if (c - firstcode[l] < count[l] && c >= firstcode[l]) {
        *used = l;
        return syms[offs[l] + c - firstcode[l]];
      }
    }
    return -1;
  }
};

// full header validation at `bit` (assumed past the cheap filter)
bool validate_dyn_header(const uint8_t* src, uint64_t srclen, int64_t bit) {
  uint64_t v = bits_at(src, bit);
  int hlit = 257 + (int)((v >> 3) & 31);
  int hdist = 1 + (int)((v >> 8) & 31);
  int hclen = 4 + (int)((v >> 13) & 15);
  uint8_t cl[19] = {0};
  for (int i = 0; i < hclen; i++)
    cl[kClOrder[i]] = (uint8_t)(bits_at(src, bit + 17 + 3 * i) & 7);
  MiniCanon mc;
  if (!mc.init(cl, 19)) return false;

  BitReader b{src + ((bit + 17 + 3 * hclen) >> 3), src + srclen};
  b.refill();
  b.drop((int)((bit + 17 + 3 * hclen) & 7));
  uint8_t lens[320];
  memset(lens, 0, sizeof(lens));
  int total = hlit + hdist, i = 0, prev = 0;
  while (i < total) {
    b.refill();
    if (b.n < 14) return false;  // truncated: not usable as a lane start
    int used;
    int sym = mc.decode(b.peek(7), &used);
    if (sym < 0) return false;
    b.drop(used);
    if (sym < 16) { lens[i++] = (uint8_t)sym; prev = sym; continue; }
    int eb = sym == 16 ? 2 : sym == 17 ? 3 : 7;
    int base = sym == 16 ? 3 : sym == 17 ? 3 : 11;
    int rep = base + (int)b.peek(eb); b.drop(eb);
    int val = 0;
    if (sym == 16) { if (i == 0) return false; val = prev; }
    else prev = 0;
    if (i + rep > total) return false;
    while (rep--) lens[i++] = (uint8_t)val;
  }
  if (lens[256] == 0) return false;
  // litlen tree must be complete (true for every compressor-produced
  // stream); dist may be incomplete but not oversubscribed
  int left = 1, dleft = 1;
  int cnt[16] = {0}, dcnt[16] = {0};
  for (int s = 0; s < hlit; s++) cnt[lens[s]]++;
  for (int s = 0; s < hdist; s++) dcnt[lens[hlit + s]]++;
  for (int l = 1; l <= 15; l++) {
    left = (left << 1) - cnt[l];
    dleft = (dleft << 1) - dcnt[l];
    if (left < 0 || dleft < 0) return false;
  }
  return left == 0;
}

int64_t find_block_start_impl(const uint8_t* src, uint64_t srclen,
                              int64_t lo, int64_t hi) {
  // bits_at loads 8 bytes: the deepest header load is at bit+71, so stay
  // 144 bits clear of the end (the tail is covered by chain fallback)
  int64_t maxbit = 8 * (int64_t)srclen - 144;
  if (hi > maxbit) hi = maxbit;
  if (lo < 0) lo = 0;
  // Batch pre-filter: one 64-bit window yields a candidate mask for 40
  // positions at once (BTYPE==2 means bit i+1 == 0 and bit i+2 == 1, so
  // mask = ~(w>>1) & (w>>2); only ~25% of positions survive), and the
  // 17-bit fixed header fields are still in-register for every survivor
  // (i <= 40 keeps i+16 inside the window).  The 3*hclen codelen field
  // block (<=57 bits) is ONE further load; its Kraft histogram runs in
  // registers.  Net: ~1 cycle/position + ~25 cycles/candidate, ~30x the
  // naive per-bit loop that re-loaded 8 bytes per codelen field.
  for (int64_t base = lo; base < hi; base += 40) {
    uint64_t w = bits_at(src, base);
    uint64_t m = ~(w >> 1) & (w >> 2) & ((UINT64_C(1) << 40) - 1);
    // HLIT<=29 (bits i+4..i+7 not all set) and HDIST<=29 (i+9..i+12)
    // fold into the same batch mask: kills the ~12% of BTYPE survivors
    // that previously paid a branchy per-candidate check
    m &= ~((w >> 4) & (w >> 5) & (w >> 6) & (w >> 7));
    m &= ~((w >> 9) & (w >> 10) & (w >> 11) & (w >> 12));
    int64_t room = hi - base;
    if (room < 40) m &= (UINT64_C(1) << room) - 1;
    while (m) {
      int i = __builtin_ctzll(m);
      m &= m - 1;
      uint64_t v = w >> i;
      int64_t bit = base + i;
      int hclen = 4 + (int)((v >> 13) & 15);
      uint64_t h = bits_at(src, bit + 17);  // all 3*hclen fields (<=57b)
      int cnt[8] = {0};
      for (int f = 0; f < hclen; f++) { cnt[h & 7]++; h >>= 3; }
      int left = 1;
      bool bad = false;
      for (int l = 1; l <= 7; l++) {
        left = (left << 1) - cnt[l];
        if (left < 0) { bad = true; break; }
      }
      if (bad || left != 0) continue;                     // codelen Kraft
      if (validate_dyn_header(src, srclen, bit)) return bit;
    }
  }
  return -1;
}

// ---------------------------------- serial span decode (stitch fallback) --
// Decode raw-deflate starting at an arbitrary bit position with an
// existing output prefix as the back-reference window; stop at the first
// block boundary at/after bit_limit or after the final block.
int inflate_span_impl(const uint8_t* src, uint64_t srclen, int64_t bit_start,
                      int64_t bit_limit, uint8_t* dst, uint64_t dstcap,
                      uint64_t dst_start, uint64_t* dstlen,
                      int64_t* end_bit) {
  BitReader b{src + (bit_start >> 3), src + srclen};
  b.refill();
  b.drop((int)(bit_start & 7));
  uint64_t out = dst_start;
  *dstlen = out;
  static thread_local Inflater inf;
  bool final_blk = false;
  auto cur_bit = [&]() { return 8 * (int64_t)(b.p - src) - (int64_t)b.n; };
  // single-exit wrapper: *dstlen reflects bytes decoded on EVERY exit
  // path (a truncated span must report its partial output, never a
  // stale length — callers stitch from it)
  auto run = [&]() -> int {
  while (!final_blk) {
    if (cur_bit() >= bit_limit) break;  // clean block boundary: stop
    b.refill();
    if (b.n < 3) { *dstlen = out; *end_bit = cur_bit(); return R_UNFINISHED; }
    final_blk = b.peek(1); b.drop(1);
    uint32_t btype = b.peek(2); b.drop(2);

    if (btype == 0) {
      b.align();
      b.refill();
      if (b.n < 32) return R_UNFINISHED;
      uint32_t len = b.peek(16); b.drop(16);
      uint32_t nlen = b.peek(16); b.drop(16);
      if (len != (~nlen & 0xFFFF)) return R_ERR;
      if (out + len > dstcap) { *dstlen = out; return R_EFULL; }
      while (len && b.n) { dst[out++] = (uint8_t)b.peek(8); b.drop(8); len--; }
      if ((uint64_t)(b.end - b.p) < len) return R_UNFINISHED;
      if (len) {
        memcpy(dst + out, b.p, len);
        b.p += len;   // manual cursor move: clear the fast refill's
        b.bits = 0;   // unaccounted reservoir residue (bits past n)
        out += len;
      }
      continue;
    }
    if (btype == 3) return R_ERR;
    if (btype == 1) {
      uint8_t ll[288], dl[32];
      fixed_lens(ll, dl);
      if (!build_table(inf.lit, ll, 288) || !build_table(inf.dist, dl, 32))
        return R_ERR;
    } else {
      b.refill();
      if (b.n < 14) return R_UNFINISHED;
      int hlit = 257 + (int)b.peek(5); b.drop(5);
      int hdist = 1 + (int)b.peek(5); b.drop(5);
      int hclen = 4 + (int)b.peek(4); b.drop(4);
      if (hlit > 286 || hdist > 30) return R_ERR;
      uint8_t cl[19] = {0};
      for (int i = 0; i < hclen; i++) {
        b.refill();
        if (b.n < 3) return R_UNFINISHED;
        cl[kClOrder[i]] = (uint8_t)b.peek(3); b.drop(3);
      }
      if (!build_table(inf.clt, cl, 19)) return R_ERR;
      int total = hlit + hdist, i = 0, prev = 0;
      memset(inf.lens, 0, sizeof(inf.lens));
      while (i < total) {
        int used;
        int sym = decode_sym(b, inf.clt, &used);
        if (sym == -2) return R_UNFINISHED;
        if (sym < 0) return R_ERR;
        b.drop(used);
        if (sym < 16) { inf.lens[i++] = (uint8_t)sym; prev = sym; continue; }
        int rep, val = 0, eb = sym == 16 ? 2 : sym == 17 ? 3 : 7;
        int base = sym == 16 ? 3 : sym == 17 ? 3 : 11;
        b.refill();
        if (b.n < eb) return R_UNFINISHED;
        rep = base + (int)b.peek(eb); b.drop(eb);
        if (sym == 16) { if (i == 0) return R_ERR; val = prev; }
        else prev = 0;
        if (i + rep > total) return R_ERR;
        while (rep--) inf.lens[i++] = (uint8_t)val;
      }
      if (inf.lens[256] == 0) return R_ERR;
      if (!build_table(inf.lit, inf.lens, hlit)) return R_ERR;
      if (!build_table(inf.dist, inf.lens + hlit, hdist)) return R_ERR;
    }
    for (;;) {
      int used;
      int sym = decode_sym(b, inf.lit, &used);
      if (sym == -2) { *dstlen = out; return R_UNFINISHED; }
      if (sym < 0) return R_ERR;
      b.drop(used);
      if (sym < 256) {
        if (out >= dstcap) { *dstlen = out; return R_EFULL; }
        dst[out++] = (uint8_t)sym;
        continue;
      }
      if (sym == 256) break;
      if (sym > 285) return R_ERR;
      int eb = kLenExtra[sym - 257];
      b.refill();
      if (b.n < eb) { *dstlen = out; return R_UNFINISHED; }
      uint32_t length = kLenBase[sym - 257] + b.peek(eb); b.drop(eb);
      int dsym = decode_sym(b, inf.dist, &used);
      if (dsym == -2) { *dstlen = out; return R_UNFINISHED; }
      if (dsym < 0 || dsym > 29) return R_ERR;
      b.drop(used);
      eb = kDistExtra[dsym];
      b.refill();
      if (b.n < eb) { *dstlen = out; return R_UNFINISHED; }
      uint32_t distv = kDistBase[dsym] + b.peek(eb); b.drop(eb);
      if (distv > out) return R_ERR;
      if (out + length > dstcap) { *dstlen = out; return R_EFULL; }
      uint8_t* d = dst + out;
      const uint8_t* s = d - distv;
      out += length;
      if (distv >= length) memcpy(d, s, length);
      else for (uint32_t k = 0; k < length; k++) d[k] = s[k];
    }
  }
  // negative end_bit encodes "final block consumed" (stream complete);
  // non-negative means "stopped at a block boundary at/after bit_limit"
  *end_bit = final_blk ? -(cur_bit() + 1) : cur_bit();
  return R_OK;
  };
  int r = run();
  *dstlen = out;
  return r;
}

// ------------------------------------------------ one-call lane stitch ----
// The whole speculative-chain stitch (runtime/large.py) in one native
// call: walk the candidate chain, resolve each validated lane's token
// row into the shared output (its window = everything stitched so far),
// and serially span-decode any gap (false-positive candidate / EFULL /
// budget-exhausted lane) until the chain re-synchronises at the next
// candidate.  Replaces ~1000 per-lane ctypes round-trips per 64MB.
int stitch_impl(const uint8_t* body, uint64_t body_len,
                const int64_t* cands, int64_t M,
                const uint32_t* toks, int64_t T,
                const int32_t* dst_pos, const int32_t* status,
                const int32_t* final_flags, const int64_t* bit_end,
                uint8_t* out, uint64_t out_cap,
                uint64_t* total_out, int64_t* end_bit_out) {
  const int64_t nbits = 8 * (int64_t)body_len;
  int64_t cur_bit = M ? cands[0] : 0;
  uint64_t out_pos = 0;
  int64_t k = 0;
  *total_out = 0;
  *end_bit_out = cur_bit;
  // corrupt-metadata containment: candidates must be sorted stream
  // positions (the python side guarantees this; a fuzzer need not)
  for (int64_t i = 0; i < M; i++)
    if (cands[i] < 0 || cands[i] >= nbits ||
        (i && cands[i] <= cands[i - 1]))
      return R_ERR;
  for (;;) {
    while (k < M && cands[k] < cur_bit) k++;
    bool lane_ok = false;
    if (toks && k < M && cands[k] == cur_bit && status[k] == 0) {
      bool at_seam = (k + 1 < M) && bit_end[k] == cands[k + 1];
      lane_ok = final_flags[k] > 0 || at_seam;
    }
    // resolve_lane's cursors are int32: outputs past 2GB take the span
    // path for the remainder (the grow-on-EFULL loop retries above 1TB)
    if (lane_ok && out_pos + (uint64_t)dst_pos[k] < (UINT64_C(1) << 31)) {
      uint64_t seg = (uint64_t)dst_pos[k];
      if (out_pos + seg > out_cap) {
        *total_out = out_pos;
        *end_bit_out = cur_bit;
        return R_EFULL;
      }
      int32_t lane_end = (int32_t)(out_pos + seg);
      int32_t lane_start = (int32_t)out_pos;
      ResolveArgs a{toks + k * T, T, body + (cands[k] >> 3), 0,
                    out, 0, out_cap, &lane_end, &lane_start, nullptr, 0,
                    (int64_t)body_len - (cands[k] >> 3)};
      resolve_lane(a, 0);
      out_pos += seg;
      cur_bit = bit_end[k];
      if (final_flags[k] > 0) {
        *total_out = out_pos;
        *end_bit_out = cur_bit;
        return R_OK;
      }
      k++;
      continue;
    }
    // a lying bit_end (corrupt lane metadata) must never reach the span
    // decoder's pointer arithmetic
    if (cur_bit < 0 || cur_bit > nbits) {
      *total_out = out_pos;
      *end_bit_out = cur_bit;
      return R_ERR;
    }
    if (cur_bit == nbits) {
      *total_out = out_pos;
      *end_bit_out = cur_bit;
      return R_UNFINISHED;
    }
    // serial fallback: decode to the next candidate boundary (the chain
    // re-synchronises there), or to the stream end
    int64_t j = (k < M && cands[k] == cur_bit) ? k + 1 : k;
    int64_t lim = j < M ? cands[j] : (int64_t)1 << 62;
    uint64_t dstlen = out_pos;
    int64_t eb = cur_bit;
    int r = inflate_span_impl(body, body_len, cur_bit, lim, out, out_cap,
                              out_pos, &dstlen, &eb);
    out_pos = dstlen;
    if (r != R_OK) {
      *total_out = out_pos;
      *end_bit_out = cur_bit;
      return r;
    }
    if (eb < 0) {  // final block consumed: stream complete
      *total_out = out_pos;
      *end_bit_out = -(eb + 1);
      return R_OK;
    }
    if (eb >= nbits) {
      *total_out = out_pos;
      *end_bit_out = eb;
      return R_UNFINISHED;
    }
    cur_bit = eb;
  }
}

// ------------------------------------ parallel large-stream inflate -------
// Host-parallel answer to the reference's core single-huge-stream use
// case (the reference's `src/infl/infl.c:1507-1675`, strictly serial
// there): rapidgzip-style two-pass decode.  N worker threads each (a)
// find a dynamic-block boundary near their segment target with the
// speculative finder above and (b) Huffman-decode their span to TOKENS —
// tokens need no back-reference window, so segments decode with zero
// inter-segment dependency.  The calling thread follows behind as the
// stitcher: it walks the candidate chain in stream order, validates each
// seam (lane k's end bit == lane k+1's start bit), and resolves
// validated token runs into the single output buffer at memory speed
// (`resolve_lane`); any gap — finder miss, false positive, decode error
// — is serially span-decoded until the chain re-synchronises.  A wrong
// candidate can never corrupt output; worst case equals the serial
// engine.
//
// The decode/stitch phases overlap: the stitcher blocks on a per-segment
// done flag (mutex+cv — TSan-clean happens-before) while workers run
// ahead, so wall clock ~ max(parallel token decode, serial resolve).

struct LargeSeg {
  int64_t start_bit = -1;   // candidate block start (-1: finder missed)
  int64_t end_bit = 0;      // first block boundary at/past the next target
  int64_t out_len = 0;      // bytes the token run produces
  int64_t min_reach = 0;    // most negative (local_out - dist) over tokens
  int status = R_ERR;       // R_OK: decoded cleanly to a stop point
  bool final_blk = false;
  std::vector<uint32_t> toks;
};

struct LargeState {
  std::vector<LargeSeg> segs;
  std::vector<uint8_t> done;  // guarded by mu
  // per-segment ownership: whoever exchanges 0->1 decodes that segment.
  // Lets the stitcher WORK-STEAL the segment it is about to block on
  // (startup: segment 0; tail: the chain head) instead of idling.
  std::unique_ptr<std::atomic<uint8_t>[]> claim;
  int64_t seg_bits = 0;
  int64_t max_toks = 0;
  std::mutex mu;
  std::condition_variable cv;
  bool decoded = false;  // phase A completed (EFULL-retry runs stitch only)
};

// Span decode emitting tokens (no output window).  Stops at the first
// block boundary at/past bit_limit, at the final block's EOB, or on any
// anomaly (status stays R_ERR -> the stitcher's serial fallback covers).
void span_to_tokens(const uint8_t* src, uint64_t srclen, LargeSeg& seg,
                    int64_t bit_limit, int64_t max_toks) {
  BitReader b{src + (seg.start_bit >> 3), src + srclen};
  b.refill();
  b.drop((int)(seg.start_bit & 7));
  static thread_local Inflater inf;
  const int64_t in_base = seg.start_bit >> 3;
  int64_t out = 0, min_reach = 0;
  int pend = -1;  // buffered literal awaiting a pair partner
  auto cur_bit = [&]() { return 8 * (int64_t)(b.p - src) - (int64_t)b.n; };
  auto flush_pend = [&]() {
    if (pend >= 0) { seg.toks.push_back((1u << 30) | (uint32_t)pend); pend = -1; }
  };
  bool final_blk = false;
  for (;;) {
    if (final_blk || cur_bit() >= bit_limit) {
      flush_pend();
      seg.end_bit = cur_bit();
      seg.out_len = out;
      seg.min_reach = min_reach;
      seg.final_blk = final_blk;
      seg.status = R_OK;
      return;
    }
    b.refill();
    if (b.n < 3) return;
    final_blk = b.peek(1); b.drop(1);
    uint32_t btype = b.peek(2); b.drop(2);
    if ((int64_t)seg.toks.size() > max_toks) return;  // runaway guard

    if (btype == 0) {
      b.align();
      b.refill();
      if (b.n < 32) return;
      uint32_t len = b.peek(16); b.drop(16);
      uint32_t nlen = b.peek(16); b.drop(16);
      if (len != (~nlen & 0xFFFF)) return;
      int64_t data_byte = cur_bit() >> 3;  // byte-aligned here
      if (data_byte + len > (int64_t)srclen) return;
      flush_pend();
      for (uint32_t off = 0; off < len; off += 256) {
        uint32_t run = len - off < 256 ? len - off : 256;
        int64_t rel = data_byte + off - in_base;
        if (rel > 0x3FFFFF) return;  // 22-bit offset field exceeded
        seg.toks.push_back((3u << 30) | ((run - 1) << 22) | (uint32_t)rel);
      }
      out += len;
      b = BitReader{src + data_byte + len, src + srclen};
      b.refill();
      continue;
    }
    if (btype == 3) return;
    if (btype == 1) {
      uint8_t ll[288], dl[32];
      fixed_lens(ll, dl);
      if (!build_table(inf.lit, ll, 288) || !build_table(inf.dist, dl, 32))
        return;
    } else {
      b.refill();
      if (b.n < 14) return;
      int hlit = 257 + (int)b.peek(5); b.drop(5);
      int hdist = 1 + (int)b.peek(5); b.drop(5);
      int hclen = 4 + (int)b.peek(4); b.drop(4);
      if (hlit > 286 || hdist > 30) return;
      uint8_t cl[19] = {0};
      for (int i = 0; i < hclen; i++) {
        b.refill();
        if (b.n < 3) return;
        cl[kClOrder[i]] = (uint8_t)b.peek(3); b.drop(3);
      }
      if (!build_table(inf.clt, cl, 19)) return;
      int total = hlit + hdist, i = 0, prev = 0;
      memset(inf.lens, 0, sizeof(inf.lens));
      while (i < total) {
        int used;
        int sym = decode_sym(b, inf.clt, &used);
        if (sym < 0) return;
        b.drop(used);
        if (sym < 16) { inf.lens[i++] = (uint8_t)sym; prev = sym; continue; }
        int rep, val = 0, eb = sym == 16 ? 2 : sym == 17 ? 3 : 7;
        int base = sym == 16 ? 3 : sym == 17 ? 3 : 11;
        b.refill();
        if (b.n < eb) return;
        rep = base + (int)b.peek(eb); b.drop(eb);
        if (sym == 16) { if (i == 0) return; val = prev; }
        else prev = 0;
        if (i + rep > total) return;
        while (rep--) inf.lens[i++] = (uint8_t)val;
      }
      if (inf.lens[256] == 0) return;
      if (!build_table(inf.lit, inf.lens, hlit)) return;
      if (!build_table(inf.dist, inf.lens + hlit, hdist)) return;
    }
    for (;;) {
      int used;
      int sym = decode_sym(b, inf.lit, &used);
      if (sym < 0) return;
      b.drop(used);
      if (sym < 256) {
        if (pend < 0) {
          pend = sym;
        } else {
          seg.toks.push_back((1u << 30) | (1u << 16)
                             | ((uint32_t)sym << 8) | (uint32_t)pend);
          pend = -1;
        }
        out++;
        continue;
      }
      if (sym == 256) break;
      if (sym > 285) return;
      int eb = kLenExtra[sym - 257];
      b.refill();
      if (b.n < eb) return;
      uint32_t length = kLenBase[sym - 257] + b.peek(eb); b.drop(eb);
      int dsym = decode_sym(b, inf.dist, &used);
      if (dsym < 0 || dsym > 29) return;
      b.drop(used);
      eb = kDistExtra[dsym];
      b.refill();
      if (b.n < eb) return;
      uint32_t distv = kDistBase[dsym] + b.peek(eb); b.drop(eb);
      flush_pend();
      if (out - (int64_t)distv < min_reach) min_reach = out - (int64_t)distv;
      seg.toks.push_back((2u << 30) | ((length - 3) << 21) | (distv - 1));
      out += length;
      if ((int64_t)seg.toks.size() > max_toks) return;
    }
  }
}

// Find + token-decode one segment and publish its done flag.  Called by
// the phase-A workers and by the stitcher when it steals a segment.
void process_seg(const uint8_t* body, uint64_t body_len, LargeState* S,
                 int64_t i) {
  LargeSeg& seg = S->segs[i];
  if (i == 0) {
    seg.start_bit = 0;
  } else {
    int64_t lo = i * S->seg_bits;
    seg.start_bit =
        find_block_start_impl(body, body_len, lo, lo + 2 * S->seg_bits);
  }
  if (seg.start_bit >= 0)
    span_to_tokens(body, body_len, seg, (i + 1) * S->seg_bits, S->max_toks);
  {
    std::lock_guard<std::mutex> lk(S->mu);
    S->done[i] = 1;
  }
  S->cv.notify_all();
}

// The stitcher: walk segments in stream order (blocking on each done
// flag), resolve validated token runs, serially span-decode gaps.
int large_stitch(const uint8_t* body, uint64_t body_len, LargeState* S,
                 uint8_t* out, uint64_t out_cap,
                 uint64_t* total_out, int64_t* end_bit_out) {
  const int64_t nbits = 8 * (int64_t)body_len;
  const int64_t n = (int64_t)S->segs.size();
  int64_t cur_bit = 0;
  uint64_t out_pos = 0;
  int64_t k = 0;
  auto wait_done = [&](int64_t i) {
    {
      std::lock_guard<std::mutex> lk(S->mu);
      if (S->done[i]) return;
    }
    if (S->claim && S->claim[i].exchange(1) == 0) {
      // steal: the segment the stitcher needs next is unclaimed —
      // decode it here instead of idling on the cv (removes the
      // startup stall on segment 0 and the chain-head tail stalls;
      // ~10% wall on a 4-core host)
      process_seg(body, body_len, S, i);
      return;
    }
    std::unique_lock<std::mutex> lk(S->mu);
    S->cv.wait(lk, [&] { return S->done[i] != 0; });
  };
  auto finish = [&](int r) {
    *total_out = out_pos;
    *end_bit_out = cur_bit;
    return r;
  };
  for (;;) {
    // next candidate at/past cur_bit (skips finder misses + duplicates)
    while (k < n) {
      wait_done(k);
      if (S->segs[k].start_bit >= cur_bit) break;
      k++;
    }
    LargeSeg* seg = (k < n && S->segs[k].start_bit == cur_bit)
                        ? &S->segs[k] : nullptr;
    if (seg && seg->status == R_OK && !seg->final_blk) {
      // seam validation needs the NEXT candidate's start bit
      int64_t j = k + 1;
      while (j < n) {
        wait_done(j);
        if (S->segs[j].start_bit > seg->start_bit) break;
        j++;
      }
      if (j >= n || S->segs[j].start_bit != seg->end_bit) seg = nullptr;
    }
    if (seg && (int64_t)out_pos + seg->min_reach < 0)
      seg = nullptr;  // back-ref before output start (only possible in
                      // the first 32KB): serial path raises the error
    if (seg && out_pos + (uint64_t)seg->out_len >= (UINT64_C(1) << 31))
      seg = nullptr;  // resolve_lane cursors are int32: span path instead
    if (seg) {
      if (out_pos + (uint64_t)seg->out_len > out_cap) return finish(R_EFULL);
      int32_t lane_end = (int32_t)(out_pos + (uint64_t)seg->out_len);
      int32_t lane_start = (int32_t)out_pos;
      ResolveArgs a{seg->toks.data(), (int64_t)seg->toks.size(),
                    body + (seg->start_bit >> 3), 0, out, 0, out_cap,
                    &lane_end, &lane_start, nullptr, 0,
                    (int64_t)body_len - (seg->start_bit >> 3)};
      resolve_lane(a, 0);
      out_pos += (uint64_t)seg->out_len;
      cur_bit = seg->end_bit;
      if (seg->final_blk) return finish(R_OK);
      k++;
      continue;
    }
    if (cur_bit >= nbits) return finish(R_UNFINISHED);
    // serial fallback to the next known candidate boundary
    int64_t j = k;
    while (j < n) {
      wait_done(j);
      if (S->segs[j].start_bit > cur_bit) break;
      j++;
    }
    int64_t lim = j < n ? S->segs[j].start_bit : (int64_t)1 << 62;
    uint64_t dstlen = out_pos;
    int64_t eb = cur_bit;
    int r = inflate_span_impl(body, body_len, cur_bit, lim, out, out_cap,
                              out_pos, &dstlen, &eb);
    out_pos = dstlen;
    if (r != R_OK) return finish(r);
    if (eb < 0) {  // final block consumed: stream complete
      cur_bit = -(eb + 1);
      return finish(R_OK);
    }
    if (eb >= nbits) { cur_bit = eb; return finish(R_UNFINISHED); }
    cur_bit = eb;
    k = j;
  }
}

int inflate_large_impl(const uint8_t* body, uint64_t body_len,
                       int64_t seg_bytes, int n_threads,
                       uint8_t* out, uint64_t out_cap,
                       uint64_t* total_out, int64_t* end_bit_out,
                       LargeState** state) {
  LargeState* S = *state;
  if (S && S->decoded) {  // EFULL retry: tokens are kept, stitch only
    return large_stitch(body, body_len, S, out, out_cap, total_out,
                        end_bit_out);
  }
  if (seg_bytes < 4096) seg_bytes = 4096;
  int64_t n_seg = (int64_t)(body_len / (uint64_t)seg_bytes);
  if (n_seg < 1) n_seg = 1;
  S = new LargeState();
  *state = S;
  S->segs.resize(n_seg);
  S->done.assign(n_seg, 0);
  S->claim.reset(new std::atomic<uint8_t>[n_seg]);
  for (int64_t i = 0; i < n_seg; i++) S->claim[i].store(0);
  S->seg_bits = 8 * seg_bytes;
  S->max_toks = 4 * S->seg_bits + 4096;  // runaway false positives
  std::atomic<int64_t> next{0};
  auto work = [&] {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_seg) return;
      if (S->claim[i].exchange(1) != 0) continue;  // stitcher stole it
      process_seg(body, body_len, S, i);
    }
  };
  std::vector<std::thread> ts;
  if (n_threads < 1) n_threads = 1;
  for (int t = 0; t < n_threads; t++) ts.emplace_back(work);
  int r = large_stitch(body, body_len, S, out, out_cap, total_out,
                       end_bit_out);
  for (auto& t : ts) t.join();
  S->decoded = true;
  return r;
}

}  // namespace

extern "C" {

// Parallel large-stream inflate (find ‖ token-decode workers + stitcher
// on the calling thread).  *state must be NULL on the first call; on
// R_EFULL the caller may grow `out` and call again with the same state
// (tokens are reused; only the stitch re-runs), then free with
// dt_large_free.
int dt_inflate_large(const uint8_t* body, uint64_t body_len,
                     int64_t seg_bytes, int n_threads,
                     uint8_t* out, uint64_t out_cap,
                     uint64_t* total_out, int64_t* end_bit_out,
                     void** state) {
  return inflate_large_impl(body, body_len, seg_bytes, n_threads, out,
                            out_cap, total_out, end_bit_out,
                            (LargeState**)state);
}

void dt_large_free(void* state) { delete (LargeState*)state; }

int64_t dt_find_block_start(const uint8_t* src, uint64_t srclen,
                            int64_t bit_lo, int64_t bit_hi) {
  return find_block_start_impl(src, srclen, bit_lo, bit_hi);
}

int dt_stitch(const uint8_t* body, uint64_t body_len,
              const int64_t* cands, int64_t M,
              const uint32_t* toks, int64_t T,
              const int32_t* dst_pos, const int32_t* status,
              const int32_t* final_flags, const int64_t* bit_end,
              uint8_t* out, uint64_t out_cap,
              uint64_t* total_out, int64_t* end_bit_out) {
  return stitch_impl(body, body_len, cands, M, toks, T, dst_pos, status,
                     final_flags, bit_end, out, out_cap, total_out,
                     end_bit_out);
}

int dt_inflate_span(const uint8_t* src, uint64_t srclen, int64_t bit_start,
                    int64_t bit_limit, uint8_t* dst, uint64_t dstcap,
                    uint64_t dst_start, uint64_t* dstlen, int64_t* end_bit) {
  return inflate_span_impl(src, srclen, bit_start, bit_limit, dst, dstcap,
                           dst_start, dstlen, end_bit);
}

// Companion of the device lockstep pack (ops/huffman_pack.py
// pack_fields_scan): the emission schedule is a pure function of the
// field nbits sequence, so this reconstructs per-lane output word
// positions from the fields the host generated, gathers the used slots,
// and appends the final partial word — no flags plane crosses the link.
int dt_encode_compact(const uint32_t* fields, const uint32_t* slots,
                      int64_t N, int64_t F, const int64_t* n_fields,
                      const uint32_t* final_lo,
                      uint8_t* const* dsts, const uint64_t* dstcaps,
                      uint64_t* dstlens, int n_threads) {
  std::atomic<int64_t> next{0};
  std::atomic<int> err{0};
  auto work = [&] {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= N) return;
      const uint32_t* fr = fields + i * F;
      const uint32_t* sr = slots + i * F;
      uint8_t* d = dsts[i];
      uint64_t cap = dstcaps[i];
      int64_t nf = n_fields[i];
      if (nf > F) nf = F;
      uint64_t w = 0;
      int nres = 0;
      int64_t bits = 0;
      for (int64_t t = 0; t < nf; t++) {
        int nb = (int)(fr[t] >> 16);
        bits += nb;
        nres += nb;
        if (nres >= 32) {
          if (w * 4 + 4 > cap) { err.store(1); return; }
          memcpy(d + w * 4, &sr[t], 4);
          w++;
          nres -= 32;
        }
      }
      uint64_t nbytes = (uint64_t)((bits + 7) / 8);
      if (nres > 0) {
        if (nbytes > cap) { err.store(1); return; }
        uint32_t tail = final_lo[i];
        for (uint64_t k = w * 4; k < nbytes; k++) {
          d[k] = (uint8_t)tail;
          tail >>= 8;
        }
      }
      dstlens[i] = nbytes;
    }
  };
  if (n_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return err.load() ? R_EFULL : 0;
}

// Host half of the hybrid TPU encode: per stream, matcher + trees +
// block layout, exported as (value, nbits) fields into fields[i*F..],
// for the device bit-pack kernel.  results[i] = R_EFULL when a stream's
// fields exceed F (caller reroutes that lane to the serial encoder).
int dt_deflate_fields_batch(const uint8_t* const* srcs,
                            const uint64_t* srclens,
                            uint32_t* fields, int64_t F,
                            int64_t* n_fields, int64_t* total_bits,
                            uint32_t* adlers, int32_t* results,
                            int64_t n, int level, int n_threads) {
  std::atomic<int64_t> next{0};
  auto work = [&] {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      results[i] = deflate_fields_impl(srcs[i], srclens[i], fields + i * F,
                                       F, &n_fields[i], &total_bits[i],
                                       &adlers[i], level);
    }
  };
  if (n_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return 0;
}

int dt_deflate_batch(const uint8_t* const* srcs, const uint64_t* srclens,
                     uint8_t* const* dsts, const uint64_t* dstcaps,
                     uint64_t* dstlens, int32_t* results,
                     int64_t n, int level, int flags, int n_threads) {
  std::atomic<int64_t> next{0};
  auto work = [&] {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      results[i] = deflate_impl(srcs[i], srclens[i], dsts[i], dstcaps[i],
                                &dstlens[i], level, flags);
    }
  };
  if (n_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return 0;
}

int dt_inflate_batch(const uint8_t* const* srcs, const uint64_t* srclens,
                     uint8_t* const* dsts, const uint64_t* dstcaps,
                     uint64_t* dstlens, int32_t* results,
                     int64_t n, int flags, int n_threads) {
  std::atomic<int64_t> next{0};
  auto work = [&] {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      results[i] = inflate_impl(srcs[i], srclens[i], dsts[i], dstcaps[i],
                                &dstlens[i], flags);
    }
  };
  if (n_threads <= 1) {
    work();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return 0;
}

int dt_resolve_tokens(const uint32_t* tokens, int64_t N, int64_t T,
                      const uint8_t* input, uint64_t in_stride,
                      int64_t in_cap,
                      uint8_t* out, uint64_t out_stride, uint64_t out_cap,
                      const int32_t* dst_len, const int32_t* dst_start,
                      const uint8_t* dict, uint32_t dict_len,
                      int n_threads) {
  ResolveArgs a{tokens, T, input, in_stride, out, out_stride, out_cap,
                dst_len, dst_start, dict, dict_len, in_cap};
  resolve_all(a, N, n_threads);
  return 0;
}

int dt_inflate(const uint8_t* src, uint64_t srclen, uint8_t* dst,
               uint64_t dstcap, uint64_t* dstlen, int flags) {
  return inflate_impl(src, srclen, dst, dstcap, dstlen, flags);
}

// One-shot inflate that also reports the consumed input position — the
// native backing for the public InflateStream.run()/inflate_buffer fast
// path (≙ infl_buf being the reference's fast path, infl.h:125-145,
// with infl_input_pos accounting, mem.c:296-329).
int dt_inflate_pos(const uint8_t* src, uint64_t srclen, uint8_t* dst,
                   uint64_t dstcap, uint64_t* dstlen, uint64_t* in_pos,
                   int flags) {
  *in_pos = 0;
  return inflate_impl(src, srclen, dst, dstcap, dstlen, flags, in_pos);
}

int dt_deflate(const uint8_t* src, uint64_t srclen, uint8_t* dst,
               uint64_t dstcap, uint64_t* dstlen, int level, int flags) {
  return deflate_impl(src, srclen, dst, dstcap, dstlen, level, flags);
}

uint32_t dt_adler32(const uint8_t* p, uint64_t n, uint32_t start) {
  return adler32_impl(p, n, start);
}

uint32_t dt_crc32(const uint8_t* p, uint64_t n, uint32_t start) {
  return crc32_impl(p, n, start);
}

}  // extern "C"
