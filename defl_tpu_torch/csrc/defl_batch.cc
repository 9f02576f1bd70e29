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
//                       results, totals, end_bits, modes, n_threads)

#include <algorithm>
#include <chrono>
#include <deque>
#include <functional>

#include <pthread.h>

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

// Threads kept between calls, for the passes of one chain: on an H100
// machine's host (8 cores) 8 threads take 1.7-2.1 ms to start and join,
// which two passes a chain would pay in every call (more than a chain of
// 60 lanes takes).  run(n, n_threads, work) is for_each_index on the
// calling thread and up to n_threads - 1 of the pool's threads, one job
// at a time; a thread that wakes after the calling thread has run out of
// work stays out of the job.  A blocked thread wakes late there: beside
// threads started for each pass, silesia.large ran 15-40% slower with
// threads that block between jobs and 11-18% faster with threads that
// poll.  So a thread polls for the next job for kPoll after each job and
// after wake(), which a caller sends ahead of the jobs it is about to
// post.
class Workers {
 public:
  void wake(int n_threads) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      start(n_threads - 1);
      warm_++;
    }
    cv_.notify_all();
  }

  void run(int64_t n, int n_threads,
           const std::function<void(int64_t)>& work) {
    std::lock_guard<std::mutex> one_job(job_mu_);
    int helpers = (int)std::min<int64_t>(n_threads, n) - 1;
    {
      std::lock_guard<std::mutex> lk(mu_);
      start(helpers);
      work_ = &work;
      n_ = n;
      next_.store(0);
      seats_ = helpers > 0 ? helpers : 0;
      job_.fetch_add(1);
    }
    cv_.notify_all();
    drain();
    std::unique_lock<std::mutex> lk(mu_);
    seats_ = 0;
    idle_.wait(lk, [&] { return busy_ == 0; });
  }

 private:
  static constexpr std::chrono::milliseconds kPoll{20};

  void start(int helpers) {
    for (; started_ < helpers; started_++)
      std::thread([this] { serve(); }).detach();
  }
  void drain() {
    for (int64_t i; (i = next_.fetch_add(1)) < n_;) (*work_)(i);
  }
  void serve() {
    uint64_t seen = job_.load(), warm = 0;
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      bool poll = warm != warm_;
      warm = warm_;
      if (poll || job_.load() == seen) {
        // poll for the next job a while, then block until one (or a
        // wake) comes
        lk.unlock();
        auto until = std::chrono::steady_clock::now() + kPoll;
        while (job_.load() == seen && std::chrono::steady_clock::now() < until)
          std::this_thread::yield();
        lk.lock();
        cv_.wait(lk, [&] { return job_.load() != seen || warm != warm_; });
        if (job_.load() == seen) continue;  // a wake: poll again
      }
      seen = job_.load();
      if (seats_ == 0) continue;  // too late for this job
      seats_--;
      busy_++;
      lk.unlock();
      drain();
      lk.lock();
      if (--busy_ == 0) idle_.notify_one();
    }
  }

  std::mutex job_mu_, mu_;
  std::condition_variable cv_, idle_;
  const std::function<void(int64_t)>* work_ = nullptr;
  int64_t n_ = 0;
  std::atomic<int64_t> next_{0};
  std::atomic<uint64_t> job_{0};
  int started_ = 0, seats_ = 0, busy_ = 0;
  uint64_t warm_ = 0;
};

// The process's pool, never destroyed (its threads wait in it to the
// process's end); a forked child, which has none of its parent's threads,
// starts a pool of its own.
Workers* g_workers = nullptr;
std::mutex g_workers_mu;

Workers& workers() {
  static const int on_fork =
      pthread_atfork(nullptr, nullptr, [] { g_workers = nullptr; });
  (void)on_fork;
  std::lock_guard<std::mutex> lk(g_workers_mu);
  if (!g_workers) g_workers = new Workers;
  return *g_workers;
}

// ------------------------------------------ one chain on many threads -----
// stitch_impl walks a chain on one thread because each lane's
// back-references reach up to 32 KiB into the lanes before it.  The
// parallel stitch splits that dependency in two passes (rapidgzip's
// window markers), over blocks of consecutive spans of output:
//   plan    (serial) the walk of stitch_impl, writing nothing: which lanes
//           it takes, and each gap decoded to tokens (span_to_tokens), so
//           that every span of output has its tokens and its offset;
//   pass A  (a block a task) each span's tokens into 16-bit cells: a byte
//           is its value, a byte whose source lies before the block is a
//           marker, 256 + the source's index in the 32 KiB before the
//           block; a match copies cells, markers included;
//   pass B  the window before each block into `out`, block after block
//           on the calling thread (32 KiB each), then every block's cells
//           narrowed into `out` (a block a task), a marker through its
//           block's window.
// `out` is written in pass B only, and only once the plan and pass A
// found nothing that stitch_impl would meet otherwise than as bytes of an
// OK stream; else stitch_impl stitches the chain from the start, so the
// result, total, end bit and bytes are dt_stitch's in every case.

enum StitchMode : int32_t {
  kStitchTask = 0,      // stitch_impl, one chain a task
  kStitchParallel = 1,  // the two passes
  kStitchFallback = 2,  // the two passes gave the chain back to stitch_impl
};

// A chain of fewer lanes stays on one thread: at 16 lanes of 24 KiB the
// two passes take what the walk takes on that host (1.5-2.0 ms
// each), at 60 lanes 3.2-3.6 ms against 4.1-6.0, at 122 lanes 5-6 ms
// against 10-11: the plan's serial head (the lanes before a whole
// window) and the second pass over the output weigh as much as the
// spread saves below 16.
constexpr int64_t kMinParallelLanes = 16;
constexpr uint16_t kMarker = 256;
constexpr int64_t kWindow = 32768;
// a block of spans holds more than a window, so that the window before
// the next block lies in it
constexpr uint64_t kMinBlock = 2 * kWindow;
// resolve_lane's int32 cursors: dt_stitch takes no lane's tokens where
// the output would reach 2 GB
constexpr uint64_t kCursorLimit = UINT64_C(1) << 31;

struct ChainSpan {
  const uint32_t* toks;
  int64_t n_toks;
  const uint8_t* in;  // the base of stored-run offsets
  int64_t in_cap;     // readable bytes from `in`
  uint64_t off;       // output offset
  uint64_t len;       // output bytes
};

struct ChainPlan {
  std::vector<ChainSpan> spans;
  std::deque<LargeSeg> gaps;  // the gaps' tokens, which `spans` point into
  uint64_t total = 0;
  int64_t end_bit = 0;
};

// stitch_impl's walk without its output.  Returns true when the walk ends
// OK within out_cap and every span resolves from tokens alone; false
// wherever stitch_impl would meet something else: corrupt candidates, a
// negative lane length, a gap that does not decode to tokens or reaches
// before the stream, EFULL, an output at 2 GB, UNFINISHED.
bool plan_chain(const uint8_t* body, uint64_t body_len, const int64_t* cands,
                int64_t M, const uint32_t* toks, int64_t T,
                const int32_t* dst_pos, const int32_t* status,
                const int32_t* final_flags, const int64_t* bit_end,
                uint64_t out_cap, ChainPlan& P) {
  const int64_t nbits = 8 * (int64_t)body_len;
  for (int64_t i = 0; i < M; i++)
    if (cands[i] < 0 || cands[i] >= nbits ||
        (i && cands[i] <= cands[i - 1]))
      return false;
  const uint64_t cap = out_cap < kCursorLimit ? out_cap : kCursorLimit - 1;
  int64_t cur_bit = M ? cands[0] : 0;
  uint64_t out_pos = 0;
  int64_t k = 0;
  for (;;) {
    while (k < M && cands[k] < cur_bit) k++;
    bool lane_ok = false;
    if (toks && k < M && cands[k] == cur_bit && status[k] == 0) {
      bool at_seam = (k + 1 < M) && bit_end[k] == cands[k + 1];
      lane_ok = final_flags[k] > 0 || at_seam;
    }
    if (lane_ok) {
      if (dst_pos[k] < 0 || out_pos + (uint64_t)dst_pos[k] > cap)
        return false;
      int64_t in_off = cands[k] >> 3;
      P.spans.push_back({toks + k * T, T, body + in_off,
                         (int64_t)body_len - in_off, out_pos,
                         (uint64_t)dst_pos[k]});
      out_pos += (uint64_t)dst_pos[k];
      cur_bit = bit_end[k];
      if (final_flags[k] > 0) break;
      k++;
      continue;
    }
    if (cur_bit < 0 || cur_bit >= nbits) return false;
    int64_t j = (k < M && cands[k] == cur_bit) ? k + 1 : k;
    int64_t lim = j < M ? cands[j] : (int64_t)1 << 62;
    P.gaps.emplace_back();
    LargeSeg& g = P.gaps.back();
    g.start_bit = cur_bit;
    // a token takes at least one bit of input: the bound never cuts a
    // gap that decodes
    span_to_tokens(body, body_len, g, lim, nbits - cur_bit + 4096);
    if (g.status != R_OK || (int64_t)out_pos + g.min_reach < 0 ||
        out_pos + (uint64_t)g.out_len > cap)
      return false;
    int64_t in_off = cur_bit >> 3;
    P.spans.push_back({g.toks.data(), (int64_t)g.toks.size(), body + in_off,
                       (int64_t)body_len - in_off, out_pos,
                       (uint64_t)g.out_len});
    out_pos += (uint64_t)g.out_len;
    cur_bit = g.end_bit;
    if (g.final_blk) break;
    if (cur_bit >= nbits) return false;
  }
  P.total = out_pos;
  P.end_bit = cur_bit;
  return true;
}

// Pass A of one span of a block: its tokens into cells[p0, p0 + s.len),
// where cells[0] is the block's first byte, at `block_off` in the output.
// resolve_lane's semantics, with no store past the span's end (the next
// block is another thread's); false where resolve_lane would stop before
// the span's end or run past it.
bool span_to_cells(const ChainSpan& s, uint16_t* cells, int64_t block_off) {
  const int64_t p0 = (int64_t)s.off - block_off, end = p0 + (int64_t)s.len;
  // room for a match of the 9-bit length field (514) and an 8-cell store
  const int64_t fast_end = end - 576;
  int64_t p = p0, t = 0;
  // a match from `src` (< p) of `n` cells at p; src < 0 lies before the
  // block: those cells are markers
  auto match_slow = [&](int64_t src, int64_t n) {
    int64_t i = 0;
    for (; i < n && src + i < 0; i++)
      cells[p + i] = (uint16_t)(kMarker + kWindow + src + i);
    for (; i < n; i++) cells[p + i] = cells[src + i];
  };
  for (; t < s.n_toks && p < fast_end; t++) {
    uint32_t v = s.toks[t];
    uint32_t kind = v >> 30;
    if (kind == 1) {
      uint32_t pair = (v & 0xFF) | ((v & 0xFF00) << 8);
      memcpy(cells + p, &pair, 4);
      p += 1 + ((v >> 16) & 1);
    } else if (kind == 2) {
      int64_t n = ((v >> 21) & 0x1FF) + 3;
      int64_t dist = (v & 0x7FFF) + 1;
      int64_t src = p - dist;
      if (src < 0) {
        if (block_off + src < 0) return false;  // before the stream
        match_slow(src, n);
      } else if (dist >= 8) {  // 8-cell stores: overlap-safe, may overrun
        uint64_t w[2];
        for (int64_t i = 0; i < n; i += 8) {
          memcpy(w, cells + src + i, 16);
          memcpy(cells + p + i, w, 16);
        }
      } else if (dist == 1) {
        std::fill(cells + p, cells + p + n, cells[src]);
      } else {
        for (int64_t i = 0; i < n; i++) cells[p + i] = cells[src + i];
      }
      p += n;
    } else if (kind == 3) {
      int64_t run = ((v >> 22) & 0xFF) + 1;
      int64_t off = v & 0x3FFFFF;
      if (off + run > s.in_cap) return false;
      for (int64_t i = 0; i < run; i++) cells[p + i] = s.in[off + i];
      p += run;
    }
  }
  for (; t < s.n_toks && p < end; t++) {
    uint32_t v = s.toks[t];
    uint32_t kind = v >> 30;
    if (kind == 1) {
      int64_t width = 1 + ((v >> 16) & 1);
      if (p + width > end) return false;
      cells[p] = v & 0xFF;
      if (width == 2) cells[p + 1] = (v >> 8) & 0xFF;
      p += width;
    } else if (kind == 2) {
      int64_t n = ((v >> 21) & 0x1FF) + 3;
      int64_t src = p - ((v & 0x7FFF) + 1);
      if (p + n > end || block_off + src < 0) return false;
      match_slow(src, n);
      p += n;
    } else if (kind == 3) {
      int64_t run = ((v >> 22) & 0xFF) + 1;
      int64_t off = v & 0x3FFFFF;
      if (off + run > s.in_cap || p + run > end) return false;
      for (int64_t i = 0; i < run; i++) cells[p + i] = s.in[off + i];
      p += run;
    }
  }
  return p == end;
}

// Scratch cells, kept between calls: a chain of 212 MB would otherwise
// fault 424 MB of fresh pages into every call.  One buffer a concurrent
// caller.
struct Cells {
  std::unique_ptr<uint16_t[]> p;
  uint64_t n = 0;
};
std::mutex g_cells_mu;
std::vector<Cells> g_cells;

Cells take_cells(uint64_t n) {
  Cells c;
  {
    std::lock_guard<std::mutex> lk(g_cells_mu);
    if (!g_cells.empty()) {
      c = std::move(g_cells.back());
      g_cells.pop_back();
    }
  }
  if (c.n < n) {
    c.p.reset();  // the old buffer goes before the new one is mapped
    c.p.reset(new uint16_t[n]);
    c.n = n;
  }
  return c;
}

void give_cells(Cells c) {
  std::lock_guard<std::mutex> lk(g_cells_mu);
  g_cells.push_back(std::move(c));
}

// Passes A and B over a clean plan, on n_threads threads.  False (and
// `out` untouched) where a span does not resolve as resolve_lane would.
//
// Both passes work a block at a time: consecutive spans of at least
// kMinBlock bytes together, about two blocks a thread (the last block may
// be shorter).  Markers stand for bytes before their block, not before
// their lane: copies of copies carry a marker on and on, and with markers
// before each lane 59% of the cells of a 53-MB silesia.tar stream were
// markers, whose chases back through the lanes cost more than the walk.
// So pass A runs a block's spans in order on one thread; pass B puts each
// block's window (the last 32 KiB of the block before it) into `out`
// first, block after block on the calling thread, and then every block on
// a thread of its own: a marker's byte is always in its block's window.
bool resolve_plan(const ChainPlan& P, uint8_t* out, int n_threads) {
  const std::vector<ChainSpan>& sp = P.spans;
  const int64_t n = (int64_t)sp.size();
  const uint64_t want =
      std::max<uint64_t>(P.total / (2 * (uint64_t)n_threads), kMinBlock);
  std::vector<int64_t> first{0};  // block b: spans [first[b], first[b + 1])
  uint64_t acc = 0;
  for (int64_t s = 0; s + 1 < n; s++)
    if ((acc += sp[s].len) >= want) {
      first.push_back(s + 1);
      acc = 0;
    }
  first.push_back(n);
  const int64_t B = (int64_t)first.size() - 1;
  auto start = [&](int64_t b) {
    return b < B ? (int64_t)sp[first[b]].off : (int64_t)P.total;
  };
  Cells scratch = take_cells(P.total ? P.total : 1);
  uint16_t* cells = scratch.p.get();
  std::atomic<bool> bad{false};
  workers().run(B, n_threads, [&](int64_t b) {
    for (int64_t s = first[b]; s < first[b + 1]; s++)
      if (bad.load(std::memory_order_relaxed) ||
          !span_to_cells(sp[s], cells + start(b), start(b))) {
        bad.store(true, std::memory_order_relaxed);
        return;
      }
  });
  if (bad.load()) {
    give_cells(std::move(scratch));
    return false;
  }
  // cells [lo, hi) of block b into `out` through a table: a byte is
  // itself, a marker 256 + k the byte k of the block's window, which is
  // in `out` already
  auto narrow = [&](int64_t b, int64_t lo, int64_t hi) {
    uint8_t lut[kMarker + kWindow];
    for (int v = 0; v < kMarker; v++) lut[v] = (uint8_t)v;
    if (b > 0) memcpy(lut + kMarker, out + start(b) - kWindow, kWindow);
    for (int64_t i = lo; i < hi; i++) out[i] = lut[cells[i]];
  };
  for (int64_t b = 1; b < B; b++) narrow(b - 1, start(b) - kWindow, start(b));
  workers().run(B, n_threads, [&](int64_t b) {
    narrow(b, start(b), b + 1 < B ? start(b + 1) - kWindow : start(B));
  });
  give_cells(std::move(scratch));
  return true;
}

// One chain on n_threads threads: the two passes, or stitch_impl where
// they give the chain back.  Returns the chain's StitchMode.
int32_t stitch_parallel(const uint8_t* body, uint64_t body_len,
                        const int64_t* cands, int64_t M,
                        const uint32_t* toks, int64_t T,
                        const int32_t* dst_pos, const int32_t* status,
                        const int32_t* final_flags, const int64_t* bit_end,
                        uint8_t* out, uint64_t out_cap, int32_t* result,
                        uint64_t* total_out, int64_t* end_bit_out,
                        int n_threads) {
  workers().wake(n_threads);  // the plan takes a while: poll through it
  {
    ChainPlan P;
    if (plan_chain(body, body_len, cands, M, toks, T, dst_pos, status,
                   final_flags, bit_end, out_cap, P) &&
        resolve_plan(P, out, n_threads)) {
      *result = R_OK;
      *total_out = P.total;
      *end_bit_out = P.end_bit;
      return kStitchParallel;
    }
  }
  *result = stitch_impl(body, body_len, cands, M, toks, T, dst_pos, status,
                        final_flags, bit_end, out, out_cap, total_out,
                        end_bit_out);
  return kStitchFallback;
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

// Many chains at once: chain s is the stream of lens[s] bytes at offs[s]
// in `body`, its lanes are count[s] lanes from lane first[s] of the lane
// arrays (cands and bit_end in bits of its own stream), and it is
// stitched into outs[s] (out_caps[s] bytes) with the result, total and
// end bit dt_stitch gives it; results, totals, end_bits and modes
// (StitchMode) are per chain.  With at least as many chains as threads,
// one chain a task; with fewer, each chain of kMinParallelLanes lanes or
// more in turn on every thread (stitch_parallel), the others one a task.
void dt_stitch_many(const uint8_t* body, const int64_t* offs,
                    const int64_t* lens, const int64_t* first,
                    const int64_t* count, int64_t S, const int64_t* cands,
                    const uint32_t* toks, int64_t T, const int32_t* dst_pos,
                    const int32_t* status, const int32_t* final_flags,
                    const int64_t* bit_end, uint8_t* const* outs,
                    const uint64_t* out_caps, int32_t* results,
                    uint64_t* totals, int64_t* end_bits, int32_t* modes,
                    int n_threads) {
  std::vector<int64_t> tasks, wide;
  for (int64_t c = 0; c < S; c++)
    (S < n_threads && count[c] >= kMinParallelLanes ? wide : tasks)
        .push_back(c);
  int64_t n_tasks = (int64_t)tasks.size();
  for_each_index(n_tasks, (int)std::min<int64_t>(n_tasks, n_threads),
                 [&](int64_t i) {
                   int64_t c = tasks[i], f = first[c];
                   results[c] = stitch_impl(
                       body + offs[c], (uint64_t)lens[c], cands + f,
                       count[c], toks ? toks + f * T : nullptr, T,
                       dst_pos + f, status + f, final_flags + f, bit_end + f,
                       outs[c], out_caps[c], &totals[c], &end_bits[c]);
                   modes[c] = kStitchTask;
                 });
  for (int64_t c : wide) {
    int64_t f = first[c];
    modes[c] = stitch_parallel(
        body + offs[c], (uint64_t)lens[c], cands + f, count[c],
        toks ? toks + f * T : nullptr, T, dst_pos + f, status + f,
        final_flags + f, bit_end + f, outs[c], out_caps[c], &results[c],
        &totals[c], &end_bits[c], n_threads);
  }
}

}  // extern "C"
