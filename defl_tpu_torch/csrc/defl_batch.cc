// defl_batch.cc — the host library of defl_tpu_torch: the engine
// (defl_host.cc, included whole and unchanged) and the batched entries of
// its block finder and chain stitch that runtime/split.py and
// runtime/large.py call, each running many finds or stitches on native
// threads in one ctypes call (a Python pool of one-find calls queues on
// the interpreter lock at every return).
//
// Exported ABI beside the engine's (ctypes, see runtime/native.py):
//   void dt_find_block_starts(body, offs, lens, lo, hi, n, out, n_threads)
//   void dt_stitch_many(body, offs, lens, first, count, S, cands, toks, T,
//                       dst_pos, status, final, bit_end, outs, out_caps,
//                       results, totals, end_bits, n_threads)

#include "defl_host.cc"

namespace {

// Runs work(i) for every i in [0, n) on n_threads threads (the calling
// thread alone when n_threads <= 1), each taking the next index.
template <typename F>
void for_each_index(int64_t n, int n_threads, F work) {
  std::atomic<int64_t> next{0};
  auto loop = [&] {
    for (int64_t i; (i = next.fetch_add(1)) < n;) work(i);
  };
  if (n_threads <= 1) {
    loop();
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads; t++) ts.emplace_back(loop);
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Many finds at once: find k looks between bits lo[k] and hi[k] of the
// stream of lens[k] bytes at offs[k] in `body`, and reads nothing outside
// that stream.  out[k] as dt_find_block_start.
void dt_find_block_starts(const uint8_t* body, const int64_t* offs,
                          const int64_t* lens, const int64_t* lo,
                          const int64_t* hi, int64_t n, int64_t* out,
                          int n_threads) {
  for_each_index(n, n_threads, [&](int64_t k) {
    out[k] = find_block_start_impl(body + offs[k], (uint64_t)lens[k], lo[k],
                                   hi[k]);
  });
}

// Many chains at once, one a task: chain s is the stream of lens[s] bytes
// at offs[s] in `body`, its lanes are count[s] lanes from lane first[s] of
// the lane arrays (cands and bit_end in bits of its own stream), and it is
// stitched into outs[s] (out_caps[s] bytes) as dt_stitch stitches one;
// results, totals and end_bits are per chain.
void dt_stitch_many(const uint8_t* body, const int64_t* offs,
                    const int64_t* lens, const int64_t* first,
                    const int64_t* count, int64_t S, const int64_t* cands,
                    const uint32_t* toks, int64_t T, const int32_t* dst_pos,
                    const int32_t* status, const int32_t* final_flags,
                    const int64_t* bit_end, uint8_t* const* outs,
                    const uint64_t* out_caps, int32_t* results,
                    uint64_t* totals, int64_t* end_bits, int n_threads) {
  for_each_index(S, n_threads, [&](int64_t c) {
    int64_t f = first[c];
    results[c] = stitch_impl(
        body + offs[c], (uint64_t)lens[c], cands + f, count[c],
        toks ? toks + f * T : nullptr, T, dst_pos + f, status + f,
        final_flags + f, bit_end + f, outs[c], out_caps[c], &totals[c],
        &end_bits[c]);
  });
}

}  // extern "C"
