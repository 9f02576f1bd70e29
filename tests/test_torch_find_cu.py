"""The block finder of the split decode (``ops/cuda/find_cu.py``,
``csrc/find_starts.cu``) against the host's native finder
(``native.find_block_starts``, ``find_block_start_impl`` in
``csrc/defl_host.cc``), which gives the bit every find must give.

On the CPU: the plain PyTorch version ``find_block_starts_ref``; the
kernel's own per-find code, built for the host with g++ (the source is
plain C++ apart from a few intrinsics, which the shim below defines) and
run find by find, group by group in order, as the kernel's block walks its
tiles; that build's checked variant (``-DDEFL_CHECKED``), which must count
no fault and catch an injected read outside a find's stream; the
wrapper's refusals; the counters of ``large.find_lane_starts``; and the
benchmark's reader of them.  On the fuzz corpus the kernel's code is also
held, find by find, to the JAX package's finder
(``defl_tpu.runtime.native.find_block_start``).  Inputs are about a kilobyte a stream: zlib
streams in small blocks (``memLevel`` 4), random bytes (every filter
stage and every way a header can fail), the fuzz corpus, several streams
in one body at odd offsets, and a stream cut inside a header whose rest
lies right behind it in the body.

Marked ``needs_cuda`` (each skips without a card, decided in a fixture):
the kernel itself against the native finder and the plain version at the
benchmark's shapes (a ``kodak32.batch`` call's 608 finds, a
``silesia.large`` call's ~4,045), on the fuzz streams, through the two
routes that call it, and its checked build.  On a machine with a card:
``python -m pytest tests/test_torch_find_cu.py -q --noconftest``.
Every comparison is exact.
"""

import ctypes
import functools
import os
import subprocess
import zlib

import numpy as np
import pytest
import torch

from defl_tpu_torch import corpus, metrics
from defl_tpu_torch.ops.cuda import build as cu_build
from defl_tpu_torch.ops.cuda import find_cu
from defl_tpu_torch.runtime import large, native, split

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "defl_tpu_torch", "csrc")

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native library unavailable")

_HOST_SHIM = r"""
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __constant__ static const
#define __noinline__
typedef unsigned long long u64;
static inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (s & 31u));
}
template <typename T> static inline T __ldg(const T* p) { return *p; }
static inline u64 atomicAdd(u64* p, u64 v) { u64 o = *p; *p += v; return o; }
static inline u64 atomicCAS(u64* p, u64 cmp, u64 v) {
  u64 o = *p; if (o == cmp) *p = v; return o;
}
#include "find_starts.cu"

// find by find, and each find's groups of 32 positions in order: the
// kernel's block takes the least pass of the first tile that holds one,
// which is the first pass of the first group that holds one
extern "C" void find_starts_host(const uint8_t* body, const long long* args,
                                 int n, long long* out
#ifdef DEFL_CHECKED
                                 , u64* fault, int inject_find
#endif
                                 ) {
  for (int k = 0; k < n; ++k) {
#ifdef DEFL_CHECKED
    const Stream s{body + args[k], args[n + k],
                   {fault, k, k, 0, k == inject_find ? SITE_FIND : 0}};
#else
    const Stream s{body + args[k], args[n + k]};
#endif
    long long lo = args[2 * n + k], hi = args[3 * n + k];
    clamp_window(s.len, lo, hi);
    out[k] = -1;
    for (long long gb = lo & ~(long long)(GROUP_BITS - 1); gb < hi;
         gb += GROUP_BITS) {
      const long long h = group_first(s, gb, lo, hi);
      if (h >= 0) {
        out[k] = h;
        break;
      }
    }
  }
}
"""


def _build_host(directory, checked: bool) -> ctypes.CDLL:
    src = os.path.join(str(directory), "find_host.cc")
    with open(src, "w") as f:
        f.write(_HOST_SHIM)
    lib = os.path.join(str(directory), "libfind_host{}.so".format(
        "_checked" if checked else ""))
    r = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", *(("-DDEFL_CHECKED",) if checked else ()),
         "-I", CSRC, "-o", lib, src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"g++ failed: {r.stderr}")
    return ctypes.CDLL(lib)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    d = tmp_path_factory.mktemp("find_host")
    return _build_host(d, False), _build_host(d, True)


def _run_host(lib, body: np.ndarray, finds, fault=None, inject=-1):
    args = np.ascontiguousarray(np.stack(
        [np.asarray(a, np.int64) for a in finds]))
    n = args.shape[1]
    out = np.empty(n, np.int64)
    body = np.ascontiguousarray(body)
    p = ctypes.c_void_p
    extra = () if fault is None else (p(fault.ctypes.data),
                                      ctypes.c_int(inject))
    fn = lib.find_starts_host
    fn(p(body.ctypes.data), p(args.ctypes.data), ctypes.c_int(n),
       p(out.ctypes.data), *extra)
    return out


def _native(body: np.ndarray, finds) -> np.ndarray:
    return native.find_block_starts(native.load(), body, *finds)


def _ref(body: np.ndarray, finds) -> np.ndarray:
    return find_cu.find_block_starts(torch.from_numpy(body.copy()),
                                     *finds).numpy()


# ---------------------------------------------------------------------------
# the inputs
# ---------------------------------------------------------------------------

def _small_blocks(raw: bytes, wbits: int = -15) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, wbits, 4)
    return co.compress(raw) + co.flush()


def _text(n: int) -> bytes:
    return b"".join(corpus.make_silesia_like(65536, 65536))[:n]


def _finds_over(offs_lens, step: int = 256, width: int = 2048):
    """Finds every ``step`` bytes of each (offset, length) stream, each
    ``width`` bytes wide, and the edges: lo below 0, hi past the clamp and
    past the stream, an empty window, one wholly past the clamp."""
    offs, lens, lo, hi = [], [], [], []
    for off, n in offs_lens:
        wins = [(8 * t, 8 * (t + width)) for t in range(0, n, step)]
        wins += [(-37, 8 * n + 999), (-1, 40), (8 * n - 300, 8 * n),
                 (500, 400), (8 * n - 144, 8 * n + 64), (0, 8 * n)]
        for a, b in wins:
            offs.append(off)
            lens.append(n)
            lo.append(a)
            hi.append(b)
    return offs, lens, lo, hi


def _one(stream: bytes, pad: int = 3):
    body = np.frombuffer(bytes(pad) + stream + bytes(pad), np.uint8)
    return body, _finds_over([(pad, len(stream))])


def _several(streams, gap: int = 5):
    """Streams back to back with ``gap`` junk bytes between them, at
    offsets that fall anywhere against a word's boundary."""
    rng = np.random.default_rng(3)
    parts, spans, at = [], [], 1
    parts.append(rng.integers(0, 256, 1, dtype=np.uint8).tobytes())
    for s in streams:
        spans.append((at, len(s)))
        parts.append(s)
        junk = rng.integers(0, 256, gap, dtype=np.uint8).tobytes()
        parts.append(junk)
        at += len(s) + gap
    return np.frombuffer(b"".join(parts), np.uint8), _finds_over(spans)


def _cut_header_case():
    """A stream of small blocks cut 300 bits past a block's header start,
    and the rest of the stream right behind it in the body: the header is
    cut by the end of its stream, and a finder that read past that end
    would find it whole."""
    comp = _small_blocks(_text(12000))
    whole = np.frombuffer(comp, np.uint8)
    starts = _native(whole, ([0], [whole.size], [8 * 2000],
                             [8 * whole.size]))
    b = int(starts[0])
    assert b > 0
    cut = (b + TAIL_AND_SOME) // 8
    body = np.frombuffer(comp, np.uint8)
    finds = ([0, 0], [cut, whole.size], [b - 64, b - 64], [b + 64, b + 64])
    return body, finds, b


#: a header's start lies this many bits before its stream's end in the cut
#: case: inside the finder's window (past the 144-bit clamp), while the
#: header runs on for hundreds of bits more
TAIL_AND_SOME = 300


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(11)
    text = _text(30000)
    blocks = [_small_blocks(text[:9000]), _small_blocks(text[9000:21000]),
              zlib.compress(text[21000:], 6)]
    rand = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    pays = corpus.fuzz_payloads(corpus.make_silesia_like(5 * 65536, 65536))
    fuzz = {s: [d for _, d in corpus.fuzz_cases(s, 60, pays) if d]
            for s in FUZZ_SEEDS}
    return blocks, rand, fuzz


#: tests/test_fuzz.py's seeds of its cases
FUZZ_SEEDS = (1, 2, 3, 7)


def _cases():
    inp = _inputs
    return {
        "small_blocks": lambda: _one(inp()[0][0]),
        "zlib6": lambda: _one(inp()[0][2]),
        "random": lambda: _one(inp()[1]),
        "several_streams": lambda: _several(inp()[0] + [inp()[1][:1500]]),
        **{f"fuzz{s}": (lambda s=s: _several(inp()[2][s], gap=3))
           for s in FUZZ_SEEDS},
    }


CASES = _cases()


# ---------------------------------------------------------------------------
# the plain version and the kernel's code built for the host
# ---------------------------------------------------------------------------

@needs_native
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_plain_version_gives_the_native_finders_bits(case):
    body, finds = CASES[case]()
    want = _native(body, finds)
    assert (want >= 0).any() or case.startswith(("random", "fuzz"))
    assert _ref(body, finds).tolist() == want.tolist()


@needs_native
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_kernels_code_gives_the_native_finders_bits(host_libs, case):
    body, finds = CASES[case]()
    plain, checked = host_libs
    want = _native(body, finds)
    assert _run_host(plain, body, finds).tolist() == want.tolist()
    fault = np.zeros(cu_build.FAULT_WORDS, np.int64)
    assert _run_host(checked, body, finds, fault).tolist() == want.tolist()
    assert fault[0] == 0, fault.tolist()


@needs_native
@pytest.mark.parametrize("seed", FUZZ_SEEDS)
def test_the_kernels_code_gives_the_jax_packages_bits_on_the_fuzz_corpus(
        host_libs, seed):
    """Find by find, the kernel's code against the JAX package's own finder
    (``defl_tpu.runtime.native.find_block_start``) over each find's stream
    alone."""
    from defl_tpu.runtime import native as jnative
    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")
    jlib = jnative.get_lib()
    body, finds = CASES[f"fuzz{seed}"]()
    got = _run_host(host_libs[0], body, finds)
    want = [jnative.find_block_start(jlib, body[o:o + n], a, b)
            for o, n, a, b in zip(*finds)]
    assert max(want) >= 0
    assert got.tolist() == want


@needs_native
def test_random_bytes_reach_every_stage_of_the_filter():
    """Random bytes pass the BTYPE mask at about a quarter of their bits
    and the code-length Kraft test at a few of those: the header decode
    runs, and rejects, many times (the native finder finds nothing)."""
    rand = np.random.default_rng(11).integers(0, 256, 3000, dtype=np.uint8)
    finds = ([0], [rand.size], [0], [8 * rand.size])
    assert _native(rand, finds).tolist() == [-1]
    data = torch.from_numpy(rand.copy())
    w = find_cu._windows(data)
    p = torch.arange(0, 8 * rand.size - find_cu.TAIL_BITS)
    v = find_cu._at(w, 0, p, 17)
    btype = ((v >> 1) & 3) == 2
    h = find_cu._at(w, 0, p + 17, 57)
    hclen = 4 + ((v >> 13) & 15)
    kraft = sum(torch.where((q < hclen) & (((h >> 3 * q) & 7) > 0),
                            128 >> ((h >> 3 * q) & 7), 0) for q in range(19))
    assert btype.float().mean() > 0.2
    assert int((btype & (kraft == 128)).sum()) >= 5


@needs_native
def test_a_header_cut_by_its_streams_end_is_refused_though_its_rest_follows(
        host_libs):
    body, finds, b = _cut_header_case()
    want = _native(body, finds)
    # the whole stream has the header at b; cut, the finders refuse it and
    # read nothing of the bytes behind the cut
    assert want[1] == b and want[0] != b
    assert _ref(body, finds).tolist() == want.tolist()
    plain, checked = host_libs
    assert _run_host(plain, body, finds).tolist() == want.tolist()
    fault = np.zeros(cu_build.FAULT_WORDS, np.int64)
    assert _run_host(checked, body, finds, fault).tolist() == want.tolist()
    assert fault[0] == 0


@needs_native
def test_an_injected_read_outside_a_stream_is_caught_by_the_checked_code(
        host_libs):
    body, finds = CASES["several_streams"]()
    _, checked = host_libs
    k = 7
    fault = np.zeros(cu_build.FAULT_WORDS, np.int64)
    got = _run_host(checked, body, finds, fault, inject=k)
    assert fault[0] >= 1
    rec = dict(zip(cu_build.FAULT_FIELDS, fault.tolist()))
    assert cu_build.SITES[rec["site"] - 1] == "find"
    assert (rec["lane"], rec["block"]) == (k, k)
    assert rec["extent"] == finds[1][k]
    assert rec["index"] >= rec["extent"]
    # the moved read gave 0 and was not made; every other find is whole
    want = _native(body, finds)
    assert np.delete(got, k).tolist() == np.delete(want, k).tolist()


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_BAD = {
    "lengths_differ": ([0, 0], [10], [0], [8]),
    "two_dimensional": ([[0]], [[10]], [[0]], [[8]]),
    "negative_offset": ([-1], [10], [0], [8]),
    "negative_length": ([0], [-1], [0], [8]),
    "past_the_body": ([60], [5], [0], [8]),
}


@needs_native
@pytest.mark.parametrize("bad", sorted(_BAD))
def test_the_wrapper_refuses_what_the_native_finder_refuses(bad):
    body = np.zeros(64, np.uint8)
    finds = _BAD[bad]
    with pytest.raises(ValueError) as native_err:
        native.find_block_starts(native.load(), body, *finds)
    with pytest.raises(ValueError) as ours:
        find_cu.find_block_starts(torch.from_numpy(body), *finds)
    assert str(ours.value) == str(native_err.value)


def test_the_wrapper_takes_bytes_or_words_and_nothing_else():
    words = torch.zeros(16, dtype=torch.int32)
    assert find_cu.find_block_starts(words, [0], [64], [0], [512]).tolist() \
        == [-1]
    assert find_cu.find_block_starts(words, [], [], [], []).tolist() == []
    for body in (torch.zeros(16, dtype=torch.int64),
                 torch.zeros((4, 4), dtype=torch.uint8)):
        with pytest.raises(TypeError):
            find_cu.find_block_starts(body, [0], [8], [0], [8])
    with pytest.raises(ValueError):
        find_cu.find_block_starts(torch.zeros(32, dtype=torch.uint8)[::2],
                                  [0], [8], [0], [8])
    with pytest.raises(ValueError):       # the checked build: a card's
        find_cu.find_block_starts(words, [0], [64], [0], [512], inject=0)


# ---------------------------------------------------------------------------
# the route's counters and the benchmark's reader
# ---------------------------------------------------------------------------

@needs_native
def test_find_lane_starts_counts_its_finds_on_the_cpu():
    comp = _small_blocks(_text(20000))
    dev = torch.device("cpu")
    host, view = large.host_body(len(comp), dev)
    view[:len(comp)] = np.frombuffer(comp, np.uint8)
    body_dev, side = large.upload_body(host, dev)
    assert side is None
    spans = [(0, len(comp), 0, [8 * t for t in range(512, len(comp), 512)])]
    n = len(spans[0][3])
    m0 = metrics.snapshot()
    got = large.find_lane_starts(view[:len(comp)], spans, 8 * 512,
                                 body_dev=body_dev)
    m1 = metrics.snapshot()
    assert m1["lane_finds"] - m0.get("lane_finds", 0) == n
    assert m1.get("lane_finds_card", 0) == m0.get("lane_finds_card", 0)
    assert got == large.find_lane_starts(view[:len(comp)], spans, 8 * 512)
    assert len(got[0]) > 3


def _window(counters):
    from codec_bench import run
    return run.Window(kind="inflate", window_s=1.0, setup_s=0.0, calls=1,
                      latencies_s=[1.0], lanes=1, failed=0, raw_bytes=1,
                      comp_bytes=1, counters=counters, cpu_s=0.0)


def test_the_find_card_share_reads_the_two_counters():
    from codec_bench import run
    reader = run.module_at(os.path.join(REPO, "codec_bench", "metrics",
                                        "find_card_pct.py"))
    assert reader.read(_window({})) is None         # a program without them
    assert reader.read(_window({"lane_finds": 8})) == 0.0
    assert reader.read(_window({"lane_finds": 8, "lane_finds_card": 8})) \
        == 100.0
    assert reader.read(_window({"lane_finds": 8, "lane_finds_card": 2})) \
        == 25.0


@needs_native
def test_a_shrunk_kodak32_run_reads_find_card_pct_on_the_cpu(monkeypatch):
    from codec_bench import run
    bench = run.load_json(os.path.join(REPO, "BENCHMARK.json"))
    monkeypatch.setattr(split, "SEGMENT_BYTES", 256)
    shrink = {"format": {"height": 24, "width": 24}, "batch": 2, "pool": 1,
              "params": {"dst_capacity": 24 * 73}}
    metrics.reset()
    r = run.run_cell(bench, "kodak32.batch", 2**33 + 17, 0.01, True,
                     device="cpu", shrink=shrink)
    assert r["correct"] is True, r["checks"]
    assert metrics.snapshot()["lane_finds"] > 0
    assert r["metrics"]["find_card_pct"]["value"] == 0.0
    assert r["metrics"]["split_lane_valid_pct"]["value"] > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _kernel(body: np.ndarray, finds, dev, **kw) -> np.ndarray:
    before = find_cu.launches
    got = find_cu.find_block_starts(torch.from_numpy(body.copy()).to(dev),
                                    *finds, **kw).numpy()
    if not kw:
        assert find_cu.launches == before + 1
    return got


@pytest.mark.needs_cuda
@pytest.mark.parametrize("shape", ["kodak32", "silesia"])
def test_the_kernel_gives_the_native_finders_bits_at_the_cells_shapes(
        card, shape):
    """A kodak32.batch call's finds (32 PNGs of 768 x 512, ~608 finds) and
    a silesia.large call's (the 211,957,760-B archive, ~4,046), made by
    the benchmark's generators as chip_smoke.py [14] makes them."""
    import chip_smoke as cs
    body, finds = cs.kodak_find_args(cs.BATCH_SPLIT_SEED) \
        if shape == "kodak32" else \
        cs.silesia_find_args(cs.silesia_stream(cs.FIND_SILESIA_SEED))
    want = _native(body, finds)
    assert (want >= 0).mean() > 0.5
    got = _kernel(body, finds, card)
    assert got.tolist() == want.tolist()
    assert _ref(body, finds).tolist() == want.tolist()


@pytest.mark.needs_cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_kernel_gives_the_native_finders_bits(card, case):
    body, finds = CASES[case]()
    assert _kernel(body, finds, card).tolist() == _native(body,
                                                          finds).tolist()


@pytest.mark.needs_cuda
def test_the_kernel_refuses_a_header_cut_by_its_streams_end(card):
    body, finds, _ = _cut_header_case()
    assert _kernel(body, finds, card).tolist() == _native(body,
                                                          finds).tolist()


def _capture(monkeypatch):
    """Every ``find_lane_starts`` call's chains, the finds it counted, and
    the native finder's chains for the same spans."""
    seen = []
    orig = large.find_lane_starts

    def spy(body, spans, seg_bits, n_threads=None, body_dev=None):
        m0 = metrics.snapshot()
        got = orig(body, spans, seg_bits, n_threads, body_dev)
        m1 = metrics.snapshot()
        moved = [m1.get(k, 0) - m0.get(k, 0)
                 for k in ("lane_finds", "lane_finds_card")]
        seen.append((got, orig(body, spans, seg_bits), body_dev, moved,
                     sum(len(s[3]) for s in spans)))
        return got

    monkeypatch.setattr(large, "find_lane_starts", spy)
    return seen


@pytest.mark.needs_cuda
def test_both_routes_find_on_the_card_and_cut_the_native_finders_lanes(
        card, monkeypatch):
    import defl_tpu_torch as dt
    raw = b"".join(corpus.make_silesia_like(1 << 22, 65536))
    comp = zlib.compress(raw, 6)
    seen = _capture(monkeypatch)
    before = find_cu.launches
    r, out = dt.inflate_large(comp, use_device=True, device=card)
    assert r == 0 and out == raw
    rs, outs = dt.inflate_batch([comp], backend="device", device=card)
    assert rs[0] == 0 and outs[0] == raw
    assert find_cu.launches - before == len(seen) == 2
    for got, want, body_dev, moved, n in seen:
        assert body_dev.device.type == "cuda"
        assert got == want and len(got[0]) > 3
        assert moved == [n, n] and n > 3


@pytest.mark.needs_cuda
def test_the_checked_kernel_counts_no_fault_and_catches_an_injection(card):
    for case in ("several_streams", "random", "fuzz1"):
        body, finds = CASES[case]()
        want = _native(body, finds)
        assert _kernel(body, finds, card, checked=True).tolist() \
            == want.tolist()
    body, finds = CASES["several_streams"]()
    with pytest.raises(cu_build.KernelFault) as e:
        _kernel(body, finds, card, inject=7)
    f = e.value
    assert (f.kernel, f.site, f.lane, f.block, f.slot) == \
        ("find_starts", "find", 7, 7, find_cu.INJECT_SLOT)
    assert f.index >= f.extent == finds[1][7]
