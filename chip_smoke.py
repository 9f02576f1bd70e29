"""Smoke run of defl_tpu_torch on one CUDA card: the batched inflate main
path, the device-resident inflate, the streaming session, the split decode
of one huge stream, the hybrid encode, the sharded decode, malformed
input among good streams, the bench, and the kernels' checked build.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. device: the card's name and power limit, torch/CUDA versions, and
     the builds from csrc/, started together: nvcc for the kernels
     (decode_stream.cu, adler32_batch.cu), nvcc for their checked build
     ([13]), g++ for the host engine (defl_batch.cc); both nvcc builds'
     ptxas lines;
  2. the decode kernels against their plain PyTorch versions, exactly, on
     the card: (a) full decodes of a small matrix (dynamic, fixed, stored
     and raw blocks, RLE, dist=2 chains, incompressible data, one byte,
     BTYPE=3, truncation, EFULL then revive_carry resume, a dictionary
     stream): the stream kernel (one launch a call, tables built on the
     card) against the chunk loop by decode_cu.compare_decodes, and the
     chunk kernel against its twin slot for slot in that loop;
     (b) one chunk at N=8192 lanes and K=512 steps, chunk kernel against
     twin bit for bit, with both times;
     (c) the whole batch, 8192 x 64 KiB, in one launch of the stream
     kernel: its time by CUDA events (median of 5) beside its bound, all
     lanes byte-equal to their payloads, and lanes of that launch from
     the shortest through the median held against the chunk loop by the
     comparator (the longest lane is held in tests/test_torch_cuda.py:
     the plain version runs as long as its longest lane);
  3. the main path once: inflate_batch(backend="device") on bench.py's
     corpus, 8192 zlib-6 streams x 64 KiB; every lane OK and byte-equal,
     no host fallback, and the decode kernel launched;
  4. pipeline_inflate over two distinct (rotated) batches of that corpus
     with the real token fetch, every lane byte-checked in the sink;
  5. the adler32 kernel against its plain PyTorch version, exactly:
     (a) a small matrix of length and alignment edge cases, each lane
     also against zlib.adler32; (b) uint8 [8192, 65536] holding the
     corpus's payloads, with both times;
  6. the device-resident inflate at full width: device_inflate(
     FLAG_ZLIB | FLAG_VERIFY_ADLER32, resolve="device") on the corpus;
     every lane OK and byte-equal, both kernels launched, no token
     fetched; then one trailer corrupted and one cut, which must come
     back ERR and UNFINISHED; the device resolver's own time and peak
     memory;
  7. DeviceInflateSession on the card, with resolve="host" and
     resolve="device": 1024 lanes fed in four uneven pieces and then
     empty feeds, and an EFULL -> resize_output -> resume case;
  8. one huge stream, split at block starts and decoded by the decode
     kernel's shared-input mode (every lane reads the one body on the
     card): (a) a stream of small blocks at a small segment size: the
     stream kernel against the chunk loop by the comparator, the chunk
     kernel against its twin slot for slot, and the tokens stitched to the
     stream's bytes; (b) the corpus's first 1024 payloads joined (64 MiB,
     one zlib level 6 stream) and its first 4096 (256 MiB), each through
     inflate_large(use_device=True, out=buffer) with the trailer verified
     and through inflate_batch(backend="device"): OK, byte-equal, the
     device route taken, at least 80% of the lanes valid, one launch;
     lanes of that very launch (the shortest of the stream and, in the
     256 MiB stream, the shortest near its end and the last one, whose
     cursors are the largest) held against the chunk loop over the same
     body by the comparator, and the chunk kernel against its twin slot
     for slot on them; the stages'
     seconds, the launch's time beside its bound, and the host-parallel
     and serial C++ engines on the same buffer; (c) a batch of long
     streams split at block starts (runtime/split.py): device_inflate on
     32 PNGs at kodak32.batch's shape (768 x 512 RGB8, IDAT chunk lists,
     made by the benchmark's generator codec_bench/data/png_kodak.py):
     every stream OK and byte-equal, every stream split, one launch, at
     least 80% of the lanes valid; the launch's time by CUDA events; every
     valid lane of that launch held against the chunk loop over the chunk
     kernel, and its shortest lanes (of at most BATCH_SPLIT_TWIN_ROWS
     token rows) against the chunk loop over the twin by the comparator
     (the chunk kernel against the twin slot for slot on them); the call's
     stages (find, launch, stitch, ...), the same batch
     with one lane a stream beside it, and the stages at each segment
     target of BATCH_SPLIT_SWEEP;
  9. the hybrid encode, 2048 x 64 KiB at level 6: device_deflate with both
     packs byte-identical to the C++ encoder, every lane decompressed by
     zlib, no lane fallen back; on 64 lanes the closed-form scan pack
     against the reservoir loop over the steps that hold a field,
     exactly; the stages' seconds;
 10. the sharded decode (parallel/): (a) DistributedCodec over cuda:0 on
     the bench batch: every lane OK and byte-equal in submission order,
     ok_lanes and total_bytes the batch's, one launch, no host fallback;
     then bench_scaling's overhead measurement on that batch (3
     interleaved rounds against raw device_inflate); (b) the same batch
     under an NCCL group of one rank, and a dictionary through the
     broadcast, the stats reduced on the card; (c) two spawned processes
     that share cuda:0 under gloo, each decoding its 4096 host-major rows
     with one launch (the streams reach them through a file), then
     dictionary streams that only rank 0 was given the dictionary of;
 11. malformed input (a malformed stream never poisons its batch): (a) the
     bench batch with every 8th lane swapped for a malformed stream
     (corpus.mixed_batch: truncated, bit-flipped, garbage, garbage after a
     zlib header), one launch of the stream kernel timed in turns with the
     clean batch's: every corpus lane ends where it ends in the clean
     launch (status, dst_pos, bitpos) and resolves to its payload, the
     malformed lanes equal the chunk loop's decode by the comparator;
     (b) defl_tpu_torch.malformed on the same batch: both resolvers (the
     device one with the trailer check on the adler32 kernel), every lane
     the port oracle's class and an OK lane its bytes, and the bench's
     64 MiB stream with 16 bit flips and a cut tail through
     inflate_large(use_device=True) in one launch, against the
     host-parallel engine; (c) the same module over a 256-lane mixed batch
     under compute-sanitizer memcheck (any report fails the run), then
     racecheck over 64 lanes if it ends within its budget; where the tool
     is absent, or refuses the card ("Device not supported"), the run says
     so and records "sanitizer": null;
 12. the bench whole: ``python -m defl_tpu_torch.bench`` at its defaults
     (8192 x 64 KiB on the card: decode, resolve, the pipeline with the
     fetch stubbed and real, the 64 MiB stream, the encode, the sharding
     overhead) in a process of its own, killed past BENCH_BUDGET_S; its
     line is printed and must carry no error, every ``*_ok`` true, the
     card's name, a value above 0 and a token fetch of exactly [2c]'s
     tok_rows x 8192 x 4 B a batch, and the bench's process must have
     launched the decode kernel (its count, read in that process, rides
     in the kernels' JSON as ``bench_launches``) and no checked build;
 13. the kernels' checked build (csrc/checked.cuh, ``-DDEFL_CHECKED``:
     every access to device and shared memory checked against its
     extent, and the stream kernel's shared words and lookup entries also
     against a shadow of what the launch wrote; compute-sanitizer refuses
     the card, [11c]) over the port's malformed and edge inputs: the bench
     batch clean and with every 8th lane malformed, tests/test_fuzz.py's
     cases for seeds 1-3 and 7, the cut streams of faults C4 and C5, [2a]'s
     matrix with its EFULL resume and its dictionary stream, the 64 MiB
     stream's split-decode launch clean and with [11b]'s flips and cut
     tail, [2b]'s chunk, and adler32 at [8192, 65536] and at lengths -1,
     0, C, C + 1 over rows off a 16-byte boundary.  Each must raise no
     fault and equal the unchecked launch bit for bit (tokens, carry,
     totals but the clock's); then one injected out-of-extent access per
     site, in the middle slot of a block, must raise with its own site and
     lane (7 sites of the stream kernel in batch and in shared-input mode,
     3 of the chunk kernel, adler32's one).  The checked launches' times
     beside the unchecked ones', in turns, and both builds' ptxas lines;
 14. the block finder (csrc/find_starts.cu, the split and large routes'
     finds on the card): the kernel against the host's native finder on
     every find, and against its plain PyTorch version, of the fuzz
     corpus's streams (with random bytes and streams of small blocks, in
     one body at odd offsets), a kodak32.batch call (32 PNGs, ~608 finds)
     and a silesia.large call (the archive from the benchmark's generator,
     ~4,045 finds); each
     shape's kernel time by CUDA events beside its bound (the bytes its
     finds must scan at 3.35 TB/s), the native finder's and the plain
     version's; inflate_large(use_device=True) and inflate_batch(backend=
     "device") each launching it once, every find counted on the card,
     their lanes the native finder's; the checked build over the same
     finds with no fault, and one injected read outside a stream caught.
     ``find_only()`` runs this phase alone after the builds.
Each kernel's count of launches is set to 0 just before the path that
uses it and read just after; the checked build's counts must still be 0
after [3], [4] and [3]-[11], and in [12]'s own process (the main path
never launches it).  The line
before the last holds the card's name and power limit, the one before it
the kernels' JSON record; the last line is the result JSON.  Without CUDA it fails at once and prints
no result.  It imports torch, numpy and defl_tpu_torch only, and for
[8c] the benchmark's PNG generator (numpy and zlib).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_STREAMS = 8192
BLOCK = 65536
CHUNK_K = 512
SESSION_LANES = 1024
# [8]: the split decode.  (a) a stream of small blocks and a small segment,
# so that the plain version's lanes take a few thousand steps; (b) payloads
# joined into one stream, as bench.py's "large64" does
SPLIT_RAW_BYTES = 2 << 20
SPLIT_SEGMENT = 1024
LARGE_PAYLOADS = (1024, 4096)
# lanes of each big stream's launch that the plain version re-decodes: the
# SPLIT_HELD with the fewest steps of the whole stream and, in the larger
# stream, as many of its last SPLIT_TAIL lanes and the last lane (the
# largest cursors, the ring's clamp at the body's end).  The last lane has
# some 11,000 steps of the twin, so only one stream pays for it
SPLIT_HELD = 6
SPLIT_TAIL = 64
# [8c]: the split decode of a batch's long streams at kodak32.batch's shape
# (codec_bench/configs/kodak_png_idat8k.json: 32 PNGs of 768 x 512 RGB8 as
# IDAT chunk lists): the seed of its images, the timed calls after the
# first, and the segment targets (bytes) the sweep times
BATCH_SPLIT_SEED = 14
BATCH_SPLIT_CALLS = 3
BATCH_SPLIT_SWEEP = (24576, 32768, 49152, 65536, 98304)
# its lanes the twin re-decodes: the SPLIT_HELD shortest of at most this
# many token rows (a whole segment takes the twin some 3 minutes)
BATCH_SPLIT_TWIN_ROWS = 4096
# [9]: bench.py's encode shape, and the lanes the reservoir loop re-packs
DEFLATE_STREAMS = 2048
PACK_LOOP_LANES = 64

# the card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and the float32 rate outside the tensor cores, taken here as the
# ceiling for the kernels' integer operations as well
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# operations of one working step of the chunk kernel, counted from
# csrc/decode_stream.cu (ChunkMem): up to four canonical decodes (15
# boundary compares and sums, a 16-bit reversal, two table loads: ~50 each)
# and ~50 of window shifts, extra bits and state updates
DECODE_OPS_PER_STEP = 250
# and of the stream kernel (StreamMem): up to four table lookups (~8 each),
# two 64-bit windows out of the ring (~12 each), ~25 for the fields of a
# match, ~40 of checks, token assembly and state updates; a build costs
# ~12 operations a sorted symbol (count, place, pack) and ~6 for each of
# the 1280 lookup entries it fills for a block's 320 symbols
STREAM_OPS_PER_STEP = 120
BUILD_OPS_PER_SYMBOL = 12 + 6 * 1280 // 320
# lanes of the whole-batch launch that the plain version re-decodes, taken
# evenly over the shorter half of the lanes ordered by the steps they took,
# the shortest and the median among them: the twin pays 1-6 ms a step
# whatever the lane count, so the run lasts as long as its longest lane
# (the batch's longest lane is held in tests/test_torch_cuda.py).
# A short chunk keeps the steps a lane idles before its builds few.
PLAIN_LANES = 64
PLAIN_K = 128
# [11]: the bench batch with every 8th lane malformed (corpus.mixed_batch's
# seed), the rounds of clean and mixed launches timed in turns; and what
# compute-sanitizer runs: (tool, lanes of the mixed batch, seconds)
MIXED_SEED = 11
MIXED_ROUNDS = 3
SANITIZER_RUNS = (("memcheck", 256, 420), ("racecheck", 64, 240))
# [12]: the bench at its defaults, in a process of its own, and the keys
# of its line that must be true
BENCH_BUDGET_S = 600
BENCH_OK_KEYS = ("pipeline_fetch_ok", "large64_ok", "large64_device_ok",
                 "encode_ok")
# [13]: the checked build (csrc/checked.cuh) on the card: the seeds of
# tests/test_fuzz.py's cases, the cut streams of faults C4 and C5
# (tests/test_torch_fuzz.py BAD_CODE_CUT_SHORT), the rounds of the whole
# batch timed in turns, the lanes of the bench batch the batch-mode
# injections run on, and the sites each kernel's injections take
CHECKED_FUZZ_SEEDS = (1, 2, 3, 7)
BAD_CODE_CUT_SHORT = ("4b043e", "4b047e", "4b043e00", "0560240980")
CHECKED_ROUNDS = 2
INJECT_LANES = 256
STREAM_SITES = ("shared", "lut", "input", "token", "carry", "meta", "uninit")
CHUNK_SITES = ("input", "token", "carry")
KERNEL_NAMES = ("decode_stream_kernel", "decode_chunk_kernel",
                "adler32_batch_kernel", "find_starts_kernel")
# [14]: the block finder; the archive's seed, and the host finder's clamp at
# a stream's end
FIND_SILESIA_SEED = 2147483659
FIND_TAIL_BITS = 144


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def max_abs_diff(pairs) -> int:
    err = 0
    for a, b in pairs:
        if a.shape != b.shape:
            raise AssertionError(f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def compare_runs(a, b, what) -> int:
    """Two chunk-loop runs slot for slot: tokens, carry, tok_rows."""
    (ta, ca), (tb, cb) = a, b
    if ca["tok_rows"] != cb["tok_rows"]:
        raise AssertionError(f"{what}: tok_rows {ca['tok_rows']} vs "
                             f"{cb['tok_rows']}")
    keys = [k for k in ca if k != "tok_rows"]
    rows = ca["tok_rows"]
    err = max_abs_diff([(ta[:rows], tb[:rows])]
                       + [(ca[k], cb[k]) for k in keys])
    if err:
        raise AssertionError(f"{what}: kernel and twin differ (max {err})")
    return err


def held_equal(decode_cu, a, b, what) -> int:
    """Two complete decodes by the comparator: end state, tokens in order
    and a resumable lane's tables; slots may differ."""
    err = decode_cu.compare_decodes(a, b)
    if err:
        raise AssertionError(f"{what}: stream kernel and chunk loop differ "
                             f"(max {err})")
    return err


def small_matrix(pack):
    """(a)'s inputs: the packed streams (lane 2's capacity forces EFULL),
    each lane's payload (None: must fail), and a preset-dictionary stream
    with its dictionary and payload."""
    rng = np.random.default_rng(7)
    pays = [b"hello hello hello world" * 40, bytes(range(256)) * 16,
            b"\0" * 5000, rng.integers(0, 256, 700, dtype=np.uint8).tobytes(),
            b"ab" * 4000, b"x", b"stored block payload " * 30,
            b"\xff" * 2000, b"fixed huffman block " * 20]
    raw = zlib.compressobj(6, zlib.DEFLATED, -15)
    fixed = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FIXED)
    streams = [zlib.compress(p, 6) for p in pays[:6]] + [
        zlib.compress(pays[6], 0), raw.compress(pays[7]) + raw.flush(),
        fixed.compress(pays[8]) + fixed.flush(),
        b"\x78\x9c\x07\xff\xff\xff", zlib.compress(pays[0], 6)[:-8]]
    zflag = [1] * 7 + [0, 1, 1, 1]
    want = pays + [None, None]
    caps = [8192] * len(streams)
    caps[2] = 1000            # EFULL, resumed with a grown cap
    p = pack.pack_streams(streams, zflag, caps)
    d = b"a shared preset dictionary: hello world, the quick brown fox " * 4
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_DEFAULT_STRATEGY,
                          zdict=d)
    dp = b"hello world, the quick brown fox jumps " * 30
    pd = pack.pack_streams([co.compress(dp) + co.flush()], 1, 4096)
    return p, want, (pd, d, dp)


def phase_small_matrix(decode_cu, ib, pack, native):
    """(a): full decodes through kernel and twin, bytes checked."""
    p, want, (pd, d, dp) = small_matrix(pack)
    args = (p.words, p.nbits, p.zflag, p.dst_cap)
    err = 0
    runs = {}
    twin = decode_cu.decode_chunk_ref
    routes = (("stream", {}), ("kernel", {"_chunk": decode_cu.decode_chunk}),
              ("twin", {"_chunk": twin}))
    for name, kw in routes:
        t1, c1 = decode_cu.decode_tokens(*args, T=4096, K=64, device="cuda",
                                         **kw)
        torch.cuda.synchronize()
        cap = torch.full((p.n,), 8192, dtype=torch.int32, device="cuda")
        t2, c2 = decode_cu.decode_tokens(
            p.words, p.nbits, p.zflag, cap, T=4096, K=64, device="cuda",
            carry=ib.revive_carry(c1, new_cap=cap), **kw)
        torch.cuda.synchronize()
        if (c2["status"] == ib.STATUS_RUNNING).any():
            raise AssertionError(f"small matrix ({name}): lanes still RUNNING")
        runs[name] = ((t1, c1), (t2, c2))
    for i in range(2):
        err = max(err, compare_runs(runs["kernel"][i], runs["twin"][i],
                                    f"small matrix part {i}"))
    as_run = lambda r: ([(t, c["tok_rows"]) for t, c in r], r[-1][1])
    err = max(err, held_equal(decode_cu, as_run(runs["stream"][:1]),
                              as_run(runs["twin"][:1]), "small matrix"))
    err = max(err, held_equal(decode_cu, as_run(runs["stream"]),
                              as_run(runs["twin"]), "small matrix, resumed"))
    (t1, c1), (t2, c2) = runs["stream"]
    st1 = c1["status"].cpu().numpy()
    if st1[2] != -105:
        raise AssertionError(f"lane 2 should hit EFULL first, got {st1[2]}")
    status = c2["status"].cpu().numpy()
    dst = c2["dst_pos"].cpu().numpy()
    toks = torch.cat([t1[:c1["tok_rows"]], t2[:c2["tok_rows"]]]).T
    out = native.native_resolve_tokens(
        toks.contiguous().cpu().numpy().view(np.uint32), p.words, dst, 8192)
    for i, w in enumerate(want):
        if w is None:
            continue
        if status[i] != 0 or out[i, : dst[i]].tobytes() != w:
            raise AssertionError(f"small matrix lane {i}: status "
                                 f"{status[i]}, bytes wrong")
    if status[9] != -1 or status[10] != 2:
        raise AssertionError(f"BTYPE=3/truncation lanes: {status[9:]}")

    # the preset-dictionary stream
    kw = dict(T=4096, K=64, device="cuda", has_dict=True,
              dict_len=pack.pack_dictionary(d)[1])
    dargs = (pd.words, pd.nbits, pd.zflag, pd.dst_cap)
    a = decode_cu.decode_tokens(*dargs, **kw)
    b = decode_cu.decode_tokens(*dargs, **kw, _chunk=twin)
    k = decode_cu.decode_tokens(*dargs, **kw, _chunk=decode_cu.decode_chunk)
    torch.cuda.synchronize()
    err = max(err, compare_runs(k, b, "dictionary"),
              held_equal(decode_cu, a, b, "dictionary"))
    dst = a[1]["dst_pos"].cpu().numpy()
    out = native.native_resolve_tokens(
        a[0][: a[1]["tok_rows"]].T.contiguous().cpu().numpy().view(np.uint32),
        pd.words, dst, 4096, d)
    if a[1]["status"][0] != 0 or out[0, : dst[0]].tobytes() != dp:
        raise AssertionError("dictionary stream decoded wrong")
    return err


def big_chunk(decode_cu, ib, packed):
    """(b)'s inputs: the chunk kernel's rows of the carry two chunks into
    the batch (every lane state of a dynamic block occurs), and the padded
    words on the card."""
    dev = torch.device("cuda")
    args = (packed.words, packed.nbits, packed.zflag, packed.dst_cap)
    # two chunks in, lanes sit in every state of a dynamic block
    _, carry = decode_cu.decode_tokens(*args, T=4 * CHUNK_K, K=CHUNK_K,
                                       device=dev,
                                       _chunk=decode_cu.decode_chunk)
    running, builds = ib._chunk_gate(carry)
    if not running:
        raise AssertionError("no lane left running after two chunks")
    ck, st = ib._apply_builds({k: carry[k] for k in ib.CHUNK_KEYS},
                              {k: carry[k] for k in ib.SCAN_KEYS}, builds)
    N = packed.n
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    inputs = decode_cu._kernel_inputs(
        st, ck, i32(packed.nbits), i32(packed.dst_cap),
        torch.full((N,), 1 << 30, dtype=torch.int32, device=dev),
        torch.zeros(N, dtype=torch.int32, device=dev),
        torch.zeros(N, dtype=torch.int32, device=dev))
    w = packed.words.shape[1] + decode_cu.PAD_WORDS
    words = torch.nn.functional.pad(i32(packed.words.view(np.int32)),
                                    (0, decode_cu.PAD_WORDS + (-w) % 4))
    return inputs, words


def phase_big_chunk(decode_cu, ib, packed):
    """(b): one N=8192, K=512 chunk from a mid-decode carry."""
    inputs, words = big_chunk(decode_cu, ib, packed)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def run(fn):
        x = [t.clone() for t in inputs]
        torch.cuda.synchronize()
        e0.record()
        tok, stp, lens = fn(x[0], x[1], words, *x[2:], K=CHUNK_K)
        e1.record()
        torch.cuda.synchronize()
        return (tok, stp, lens), e0.elapsed_time(e1)

    kern, _ = run(decode_cu.decode_chunk)
    twin, plain_ms = run(decode_cu.decode_chunk_ref)
    err = max_abs_diff(zip(kern, twin))
    if err:
        raise AssertionError(f"N={N} K={CHUNK_K} chunk: kernel and twin "
                             f"differ (max {err})")
    times = [run(decode_cu.decode_chunk)[1] for _ in range(5)]
    states = torch.bincount(kern[1][0], minlength=14).tolist()

    # the least time the card could take for this chunk's work: the input
    # bits these lanes consumed, every state row, lens word and table read
    # once, state, lens and tokens written once; and the steps that did
    # work (a primary token slot was filled) at OPS_PER_STEP operations
    tok, stp, _ = kern
    R = decode_cu.R_BITPOS
    in_bytes = int((stp[R].long() - inputs[0][R].long()).sum()) // 8
    moved = (in_bytes + tok.numel() * 4
             + 2 * 4 * (inputs[0].numel() + inputs[1].numel())
             + 4 * sum(t.numel() for t in inputs[2:]))
    live_steps = int((tok[0::2] != 0).sum())
    bound = roofline(moved, live_steps * DECODE_OPS_PER_STEP)
    return (err, float(np.median(times)), plain_ms, times, states, bound,
            (moved, live_steps))


def phase_whole_batch(decode_cu, ib, native, lane_rows, packed, payloads):
    """(c): the whole batch in one launch of the stream kernel."""
    dev = torch.device("cuda")
    N = packed.n
    up = lambda a: torch.from_numpy(a).to(dev)
    args = (up(packed.words.view(np.int32)), up(packed.nbits),
            up(packed.zflag), up(packed.dst_cap))
    T = ib.step_budget(BLOCK)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    launch = decode_cu._launch_stream

    def timed_launch(*a, **k):
        e0.record()
        launch(*a, **k)
        e1.record()

    times = []
    decode_cu._launch_stream = timed_launch
    try:
        for _ in range(6):              # the first one warms up
            tok, carry = decode_cu.decode_tokens(*args, T=T)
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
    finally:
        decode_cu._launch_stream = launch
    times = times[1:]
    stats = carry["stream_stats"]
    rows = carry["tok_rows"]

    # every lane OK and byte-equal
    status = carry["status"].cpu().numpy()
    dst = carry["dst_pos"].cpu().numpy()
    toks = tok[:rows].T.contiguous().cpu().numpy().view(np.uint32)
    out = native.native_resolve_tokens(toks, packed.words, dst, BLOCK)
    bad = [i for i in range(N) if status[i] != 0
           or out[i, : dst[i]].tobytes() != payloads[i]]
    if bad:
        raise AssertionError(f"whole batch: {len(bad)} lanes wrong, first "
                             f"{bad[:5]}")
    del toks, out

    # lanes of that launch against the plain version: lanes are
    # independent, so theirs are the kernel's results for them.  They span
    # the batch's shorter half: match-heavy lanes of a few hundred steps
    # up to the median lane
    stored = sum(int((tok[r0:r0 + 4096] != 0).sum())
                 for r0 in range(0, rows, 4096))
    if stored != stats["tokens"]:
        raise AssertionError(f"whole batch: the kernel counted "
                             f"{stats['tokens']} tokens, the buffer holds "
                             f"{stored}")
    used = lane_rows(tok, rows)
    by_len = torch.argsort(used)
    at = torch.linspace(0, N // 2, PLAIN_LANES).long().tolist()
    pick = by_len[sorted(set(at))]
    pick_rows = used[pick].tolist()
    sub = [a[pick] for a in args]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts, pc = [], None
    for _ in range(4):
        ptok, pc = decode_cu.decode_tokens(
            *sub, T=T, K=PLAIN_K, carry=pc,
            _chunk=decode_cu.decode_chunk_ref)
        parts.append((ptok, pc["tok_rows"]))
        if not (pc["status"] == ib.STATUS_RUNNING).any():
            break
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = held_equal(decode_cu, decode_cu.select_lanes((tok, carry), pick),
                     (parts, pc), f"whole batch, {pick.numel()} lanes")
    plain_steps = sum(r for _, r in parts) // 2

    # the least time the card could take: the input bits the lanes
    # consumed, state, lens and tables read and written once, the lane
    # order read, the tokens the kernel stored (NOP slots are never
    # written: the buffer's zero-fill is outside the timed launch); and
    # the steps run at STREAM_OPS_PER_STEP plus the builds' sorted symbols
    in_bytes = int(carry["bitpos"].long().sum()) // 8
    state_bytes = 4 * N * (20 + 14 + 2 * 40 + 2 * (3 * 48 + 3 + 116) + 1)
    moved = in_bytes + state_bytes + stats["tokens"] * 4
    ops = (stats["steps"] * STREAM_OPS_PER_STEP
           + stats["sorted_symbols"] * BUILD_OPS_PER_SYMBOL)
    return (err, float(np.median(times)), times, stats, roofline(moved, ops),
            (moved, ops), plain_s * 1e3, pick_rows, plain_steps)


def roofline(n_bytes: int, n_ops: int):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the ALU rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ALU_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps: int = 5):
    """Median device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times)), times


def check_adler(ck, data, lengths, what) -> int:
    """Kernel against plain version on the card, and each lane against
    zlib.adler32 of the same bytes.  Returns the max abs difference."""
    got = ck.adler32_batch(data, lengths)
    ref = ck.adler32_batch_ref(data, lengths)
    torch.cuda.synchronize()
    err = max_abs_diff([(got, ref)])
    if err:
        raise AssertionError(f"adler32 {what}: kernel and plain version "
                             f"differ (max {err})")
    host = data.cpu().numpy()
    lens = lengths.clamp(0, data.shape[1]).cpu().numpy()
    for i, v in enumerate(got.cpu().tolist()):
        want = zlib.adler32(host[i, : lens[i]].tobytes())
        if v != want:
            raise AssertionError(f"adler32 {what} lane {i}: {v:#x} vs zlib "
                                 f"{want:#x}")
    return err


def phase_adler_small(ck):
    """5a: lengths 0, 1, 2, around the TPU kernel's 3072-byte slab, C and
    past C (clipped); all-0xFF rows (the largest sums); a C that is no
    multiple of 16; rows sliced out of a wider buffer at odd offsets."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(5)
    err = 0
    for C in (6144, 6001):
        lens = [0, 1, 2, 15, 16, 17, 3071, 3072, 3073, C - 1, C, C + 7,
                C, C]
        data = torch.randint(0, 256, (len(lens), C), dtype=torch.uint8,
                             generator=g)
        data[-2:] = 0xFF
        lens[-1] = C // 2
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        err = max(err, check_adler(ck, data.to(dev), lengths, f"C={C}"))
        # the same rows inside a wider buffer: row starts at 3, 3 + 6211,
        # ... are not 16-byte aligned, and the row stride is not C
        wide = torch.zeros((len(lens), C + 67), dtype=torch.uint8, device=dev)
        wide[:, 3:3 + C] = data.to(dev)
        err = max(err, check_adler(ck, wide[:, 3:3 + C], lengths,
                                   f"C={C} sliced"))
    # values >= 2**31 must survive the trip as u32
    hi = ck.adler32_batch(torch.full((1, 4096), 0xFF, dtype=torch.uint8,
                                     device=dev),
                          torch.tensor([4096], device=dev))
    if int(hi[0]) != zlib.adler32(b"\xff" * 4096) or int(hi[0]) < 2 ** 31:
        raise AssertionError(f"adler32 of 4096 x 0xFF: {int(hi[0]):#x}")
    return err


def phase_adler_full(ck, payloads):
    """5b: the main-path shape, the corpus's payloads as rows."""
    dev = torch.device("cuda")
    host = np.zeros((N_STREAMS, BLOCK), np.uint8)
    lens = np.zeros(N_STREAMS, np.int32)
    for i, p in enumerate(payloads):
        host[i, : len(p)] = np.frombuffer(p, np.uint8)
        lens[i] = len(p)
    data = torch.from_numpy(host).to(dev)
    lengths = torch.from_numpy(lens).to(dev)
    got = ck.adler32_batch(data, lengths)
    ref = ck.adler32_batch_ref(data, lengths)
    torch.cuda.synchronize()
    err = max_abs_diff([(got, ref)])
    want = [zlib.adler32(p) for p in payloads]
    if err or got.cpu().tolist() != want:
        raise AssertionError(f"adler32 [{N_STREAMS}, {BLOCK}]: kernel, plain "
                             f"version and zlib disagree (max {err})")
    ms, times = cuda_ms(lambda: ck.adler32_batch(data, lengths))
    plain_ms, _ = cuda_ms(lambda: ck.adler32_batch_ref(data, lengths), reps=3)
    # each byte of a lane read once, lengths read and checksums written;
    # per byte one add for sum(d) and a multiply-add for sum(i*d)
    n = int(lens.sum())
    bound = roofline(n + 8 * N_STREAMS, 3 * n)
    return err, ms, plain_ms, times, bound, n


def phase_device_resident(dt, metrics, decode_cu, checksums_cu, streams,
                          payloads, flags):
    """6: device_inflate(resolve="device") at full width."""
    decode_cu.launches = 0
    checksums_cu.launches = 0
    m0 = metrics.snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, outputs, stats = dt.device_inflate(
        streams, flags, dst_capacities=BLOCK, resolve="device")
    wall = time.perf_counter() - t0
    launches = (decode_cu.launches, checksums_cu.launches)
    m1 = metrics.snapshot()
    bad = [i for i, (r, o) in enumerate(zip(results, outputs))
           if r != 0 or o != payloads[i]]
    if bad:
        raise AssertionError(f"device-resident path: {len(bad)} lanes "
                             f"wrong, first {bad[:5]}")
    if stats["host_fallbacks"]:
        raise AssertionError(f"device-resident path: host fallbacks "
                             f"{stats['host_fallbacks'][:5]}")
    if min(launches) <= 0:
        raise AssertionError(f"device-resident path: (decode_stream, "
                             f"adler32_batch) launches {launches}")
    if m1.get("token_fetch_bytes", 0) != m0.get("token_fetch_bytes", 0):
        raise AssertionError("device-resident path fetched tokens")

    # one trailer corrupted, one cut: ERR and UNFINISHED, the rest OK
    broken = list(streams)
    broken[5] = streams[5][:-1] + bytes([streams[5][-1] ^ 0x40])
    broken[77] = streams[77][:-2]
    results, outputs, _ = dt.device_inflate(
        broken, flags, dst_capacities=BLOCK, resolve="device")
    want = [0] * N_STREAMS
    want[5], want[77] = -1, 2
    if [int(r) for r in results] != want:
        got = {i: int(r) for i, r in enumerate(results) if int(r) != 0}
        raise AssertionError(f"bad trailers: non-OK lanes {got}, expected "
                             f"{{5: -1, 77: 2}}")
    if any(o != p for o, p in zip(outputs, payloads)):
        raise AssertionError("bad trailers: output bytes changed")
    return wall, launches


def phase_resolve_alone(decode_cu, resolve, pack, streams, payloads):
    """The device resolver's own time and peak memory on the full batch."""
    dev = torch.device("cuda")
    p = pack.pack_streams(streams, 1, BLOCK)
    words = torch.from_numpy(p.words.view(np.int32)).to(dev)
    from defl_tpu_torch.ops.inflate_batch import step_budget

    tokens, st = decode_cu.decode_tokens(words, p.nbits, p.zflag, p.dst_cap,
                                         T=step_budget(BLOCK), K=CHUNK_K)
    toks = tokens[: st["tok_rows"]]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = resolve.resolve_tokens(toks, words, st["dst_pos"], C=BLOCK)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
    host = out.cpu().numpy()
    dst = st["dst_pos"].cpu().numpy()
    wrong = sum(host[i, : dst[i]].tobytes() != payloads[i]
                for i in range(N_STREAMS))
    if wrong or host[0, dst[0]:].any():
        raise AssertionError(f"device resolver: {wrong} lanes wrong")
    return times, peak, base, toks.numel() * 4


def phase_stream_session(dt, streams, payloads, resolve):
    """7: incremental feeds on the card.  The decoder stops at the final
    block's end, so a finished lane's input_pos is its stream's length
    less the 4-byte trailer."""
    n = SESSION_LANES
    zs, pays = streams[:n], payloads[:n]
    sess = dt.DeviceInflateSession(n, BLOCK, chunk_steps=CHUNK_K,
                                   resolve=resolve)
    cuts = (0.07, 0.31, 0.78, 1.0)
    t0 = time.perf_counter()
    prev = [0] * n
    feeds = 0
    for c in cuts:
        ends = [len(s) if c == 1.0 else int(len(s) * c) for s in zs]
        res = sess.feed([s[a:b] for s, a, b in zip(zs, prev, ends)])
        prev = ends
        feeds += 1
    while any(r == 2 for r in res):
        if feeds > 40:
            raise AssertionError("session: lanes still UNFINISHED after 40 "
                                 "feeds")
        res = sess.feed([b""] * n)
        feeds += 1
    wall = time.perf_counter() - t0
    res, outs = sess.outputs()
    if any(r != 0 for r in res) or outs != pays:
        raise AssertionError(f"session({resolve}): wrong statuses or bytes")
    pos = [sess.input_pos(i) for i in range(n)]
    if pos != [len(s) - 4 for s in zs]:
        raise AssertionError(f"session({resolve}): input_pos off")

    # EFULL -> resize_output -> resume
    m = 64
    small = dt.DeviceInflateSession(m, 4096, chunk_steps=CHUNK_K,
                                    resolve=resolve)
    res = small.feed(zs[:m])
    for _ in range(40):
        if all(r != 2 for r in res):
            break
        res = small.feed([b""] * m)
    if any(r != -105 for r in res):
        raise AssertionError(f"session({resolve}): expected EFULL at a "
                             f"4096-byte capacity, got {set(res)}")
    small.resize_output(BLOCK)
    for _ in range(40):
        res = small.feed([b""] * m)
        if all(r != 2 for r in res):
            break
    res, outs = small.outputs()
    if any(r != 0 for r in res) or outs != pays[:m]:
        raise AssertionError(f"session({resolve}): EFULL resume went wrong")
    return wall, feeds


def phase_split_comparator(decode_cu, large, native, fetch_tokens, payloads):
    """8a: the shared-input mode against its plain versions."""
    raw = b"".join(payloads)[:SPLIT_RAW_BYTES]
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 4)   # a block per 1023 symbols
    comp = co.compress(raw) + co.flush()
    body = np.frombuffer(comp, np.uint8)[2:]
    cands = large._find_candidates(body, 0, body.size // SPLIT_SEGMENT,
                                   8 * SPLIT_SEGMENT)
    kw = large.lane_args(body.size, cands)
    args = (kw.pop("nbits"), kw.pop("zflag"), kw.pop("cap"))
    kw.update(dict_len=large.WINDOW, shared_input=True)
    words = torch.from_numpy(decode_cu.pad_body(body)).view(
        torch.int32).cuda()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    got = decode_cu.decode_tokens(words, *args, **kw)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1)
    t0 = time.perf_counter()
    twin = decode_cu.decode_tokens(words, *args, K=PLAIN_K, **kw,
                                   _chunk=decode_cu.decode_chunk_ref)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    kern = decode_cu.decode_tokens(words, *args, K=PLAIN_K, **kw,
                                   _chunk=decode_cu.decode_chunk)
    torch.cuda.synchronize()
    err = max(compare_runs(kern, twin, "split decode"),
              held_equal(decode_cu, got, twin, "split decode"))
    st = got[1]
    status = st["status"].cpu().numpy()
    bit_end = st["bitpos"].cpu().numpy().astype(np.int64)
    valid = int(((status[:-1] == 0)
                 & (bit_end[:-1] == np.asarray(cands[1:]))).sum()) \
        + int(status[-1] == 0)
    if valid < 0.8 * len(cands):
        raise AssertionError(f"split decode: {valid} of {len(cands)} lanes "
                             f"valid")
    out = np.zeros(len(raw) + 64, np.uint8)
    r, total, _ = native.stitch(
        native.load(), body, cands,
        (fetch_tokens([(got[0], st["tok_rows"])]),
         st["dst_pos"].cpu().numpy(), status, st["final"].cpu().numpy(),
         bit_end), out)
    if int(r) != 0 or out[:total].tobytes() != raw:
        raise AssertionError(f"split decode: stitched bytes wrong ({r})")
    return (err, ms, plain_ms, len(cands), valid, twin[1]["tok_rows"] // 2,
            len(comp))


def held_split_lanes(decode_cu, lane_rows, call, tail, max_rows=None):
    """Lanes of a split decode's launch, as ``inflate_large`` made it,
    against the plain version at the same shape: ``call`` holds that
    launch's arguments and what it returned.  The lanes' arguments are
    indexed and the body stays the one on the card, so the cursors, limits
    and word offsets are the launch's own.  ``max_rows``: hold only lanes
    of at most that many token rows (the twin's time is its longest
    lane's), none when no lane is that short."""
    (words, nbits, zflag, cap), kw, (tok, carry) = call
    M = int(nbits.shape[0])
    used = lane_rows(tok, carry["tok_rows"]).cpu().numpy()
    order = np.argsort(used, kind="stable")
    if max_rows is not None:
        order = order[used[order] <= max_rows]
        if not order.size:
            return {"err": 0, "lanes": [], "rows": [], "start_bits": [],
                    "plain_ms": 0.0, "plain_steps": 0}
    pick = order[:SPLIT_HELD]
    if tail:
        last = np.arange(max(0, M - SPLIT_TAIL), M)
        pick = np.concatenate([
            pick, last[np.argsort(used[last], kind="stable")[:SPLIT_HELD]],
            [M - 1]])
    pick = np.unique(pick)
    per_lane = {k: np.asarray(kw[k])[pick]
                for k in ("limit", "start_bit", "dict_reach", "in_base")}
    sub = (words, nbits[pick], zflag[pick], cap[pick])
    skw = dict(T=kw["T"], K=PLAIN_K, dict_len=kw["dict_len"],
               shared_input=True, **per_lane)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    twin = decode_cu.decode_tokens(*sub, **skw,
                                   _chunk=decode_cu.decode_chunk_ref)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    kern = decode_cu.decode_tokens(*sub, **skw, _chunk=decode_cu.decode_chunk)
    torch.cuda.synchronize()
    what = f"split decode, {pick.size} lanes of {M}"
    err = max(compare_runs(kern, twin, what),
              held_equal(decode_cu,
                         decode_cu.select_lanes((tok, carry), pick.tolist()),
                         twin, what))
    return {"err": err, "lanes": pick.tolist(), "rows": used[pick].tolist(),
            "start_bits": per_lane["start_bit"].tolist(),
            "plain_ms": plain_s * 1e3, "plain_steps": twin[1]["tok_rows"] // 2}


def big_stream(payloads, n_payloads):
    """(raw, one zlib level 6 stream of it, seconds it took to make)."""
    raw = b"".join(payloads[:n_payloads])
    t0 = time.perf_counter()
    comp = zlib.compress(raw, 6)
    return raw, comp, time.perf_counter() - t0


def phase_large(dt, decode_cu, lane_rows, large_stages, stream, flags, tail):
    """8b: one big stream through the entry points, lanes of its launch
    against the plain version, then its stages and the host engines beside
    it."""
    raw, comp, made = stream
    buf = np.zeros(len(raw) + 64, np.uint8)
    buf.fill(1)
    st = {}
    calls = []
    decode = decode_cu.decode_tokens

    def kept(*a, **k):
        out = decode(*a, **k)
        calls.append((a, k, out))
        return out

    decode_cu.launches = 0
    decode_cu.decode_tokens = kept      # the launch's arguments and tokens
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r, n = dt.inflate_large(comp, flags, use_device=True, out=buf,
                                stats_out=st)
        wall = time.perf_counter() - t0
    finally:
        decode_cu.decode_tokens = decode
    launches = decode_cu.launches
    if int(r) != 0 or n != len(raw) or buf[:n].tobytes() != raw:
        raise AssertionError(f"inflate_large: result {r}, {n} bytes, or "
                             f"bytes wrong")
    if st["route"] != "device" or launches != 1 or len(calls) != 1:
        raise AssertionError(f"inflate_large: route {st['route']}, "
                             f"{launches} launches")
    if st["lanes_valid"] < 0.8 * st["lanes"]:
        raise AssertionError(f"inflate_large: {st['lanes_valid']} of "
                             f"{st['lanes']} lanes valid")
    held = held_split_lanes(decode_cu, lane_rows, calls.pop(), tail)
    decode_cu.launches = 0
    t0 = time.perf_counter()
    res, outs = dt.inflate_batch([comp], flags, backend="device",
                                 dst_capacities=[len(raw)])
    bwall = time.perf_counter() - t0
    if [int(x) for x in res] != [0] or outs[0] != raw \
            or decode_cu.launches != 1:
        raise AssertionError(f"inflate_batch of one big stream: {res}, "
                             f"{decode_cu.launches} launches")
    del outs
    rec = large_stages(raw, comp, 1, flags)
    dev = rec["device"][0]
    # the launch's bound: the body read once, the tokens it stored, state
    # and tables of its lanes read and written once, the lane order
    M = dev["lanes"]
    state_bytes = 4 * M * (20 + 14 + 2 * 40 + 2 * (3 * 48 + 3 + 116) + 1)
    moved = len(comp) + 4 * dev["tokens"] + state_bytes
    ops = dev["steps"] * STREAM_OPS_PER_STEP
    return {"raw": len(raw), "comp": len(comp), "made_s": made,
            "first_call": {"wall_s": wall, **st}, "batch_wall_s": bwall,
            "launches": launches, "stages": dev, "held": held,
            "launch_ms": dev["launch_ms"][0], "bound": roofline(moved, ops),
            "moved": moved, "ops": ops,
            "host_parallel_s": rec["host_parallel"][0]["wall_s"],
            "serial_s": rec["serial"][0]["wall_s"]}



def kodak_batch(seed: int):
    """(raw scanlines, IDAT chunk lists) of one batch of kodak32.batch's
    configuration, made by the benchmark's own generator."""
    from codec_bench.data import png_kodak

    with open("codec_bench/configs/kodak_png_idat8k.json") as f:
        cfg = json.load(f)
    b = png_kodak.make_pool(cfg["format"], seed, 1, cfg["batch_images"])[0]
    return b.raw, b.inputs


#: device_inflate's spans, as [8c] reports them
SPLIT_SPANS = ("pack", "split.find", "upload", "decode", "fetch", "resolve",
               "lane_bytes")


def split_call(dt, metrics, streams, cap):
    """One device_inflate call: (results, outputs, stats, seconds by span
    and ``wall``)."""
    m0 = metrics.snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, outs, st = dt.device_inflate(streams, dst_capacities=cap)
    wall = time.perf_counter() - t0
    m1 = metrics.snapshot()
    secs = {k: (m1.get(f"defl.{k}.ns", 0) - m0.get(f"defl.{k}.ns", 0)) / 1e9
            for k in SPLIT_SPANS}
    return res, outs, st, {**secs, "wall": wall}


def median_calls(dt, metrics, streams, cap, raw, n):
    """``n`` calls after a warm one, each checked: the median of each
    span's seconds, the wall's, and the last call's stats."""
    split_call(dt, metrics, streams, cap)
    runs = []
    for _ in range(n):
        res, outs, st, secs = split_call(dt, metrics, streams, cap)
        if [int(r) for r in res] != [0] * len(raw) or outs != raw:
            raise AssertionError("batch split: a stream is not OK or its "
                                 "bytes are wrong")
        runs.append(secs)
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}, st


def held_valid_lanes(decode_cu, call):
    """Every lane of a split launch that validated (status OK, and ended on
    its limit, the next lane's start, or in its stream's final block)
    against the chunk loop over the chunk kernel at the same arguments, by
    the comparator.  Returns (lanes held, max_abs_err, the loop's ms)."""
    (words, nbits, zflag, cap), kw, (tok, carry) = call
    status = carry["status"].cpu().numpy()
    final = carry["final"].cpu().numpy()
    bitpos = carry["bitpos"].cpu().numpy().astype(np.int64)
    limit = np.asarray(kw["limit"], np.int64)
    nbits = np.asarray(nbits)
    valid = np.flatnonzero((status == 0) & (
        (final > 0) | ((bitpos == limit) & (limit != nbits))))
    per_lane = {k: np.asarray(kw[k])[valid]
                for k in ("limit", "start_bit", "dict_reach", "in_base")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = decode_cu.decode_tokens(
        words, nbits[valid], np.asarray(zflag)[valid], np.asarray(cap)[valid],
        T=kw["T"], K=CHUNK_K, dict_len=kw["dict_len"], shared_input=True,
        **per_lane, _chunk=decode_cu.decode_chunk)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    err = held_equal(decode_cu, decode_cu.select_lanes((tok, carry),
                                                       valid.tolist()),
                     loop, f"batch split, {valid.size} valid lanes")
    return int(valid.size), err, ms


def phase_batch_split(dt, decode_cu, metrics, split, lane_rows):
    """8c: device_inflate on a batch of 32 Kodak-size PNGs: one launch over
    every segment of every stream, its lanes against the plain versions,
    the call's stages, the one-lane route beside it, and the sweep of the
    segment target."""
    raw, streams = kodak_batch(BATCH_SPLIT_SEED)
    cap = len(raw[0])
    comp = sum(sum(len(c) for c in s) for s in streams)
    calls = []
    decode = decode_cu.decode_tokens

    def kept(*a, **k):
        out = decode(*a, **k)
        calls.append((a, k, out))
        return out

    decode_cu.launches = 0
    decode_cu.decode_tokens = kept      # the launch's arguments and tokens
    try:
        res, outs, st, first = split_call(dt, metrics, streams, cap)
    finally:
        decode_cu.decode_tokens = decode
    launches = decode_cu.launches
    if [int(r) for r in res] != [0] * len(raw) or outs != raw:
        raise AssertionError("batch split: a stream is not OK or its bytes "
                             "are wrong")
    if st["split_streams"] != len(raw) or launches != 1 or len(calls) != 1:
        raise AssertionError(f"batch split: {st['split_streams']} streams "
                             f"split, {launches} launches")
    if st["split_lanes_valid"] < 0.8 * st["split_lanes"]:
        raise AssertionError(f"batch split: {st['split_lanes_valid']} of "
                             f"{st['split_lanes']} lanes valid")
    call = calls.pop()
    a, k, (tok, carry) = call
    launch_ms, _ = cuda_ms(lambda: decode(*a, **k), reps=3)
    n_valid, err_valid, valid_ms = held_valid_lanes(decode_cu, call)
    held = held_split_lanes(decode_cu, lane_rows, call, tail=False,
                            max_rows=BATCH_SPLIT_TWIN_ROWS)
    warm, _ = median_calls(dt, metrics, streams, cap, raw, BATCH_SPLIT_CALLS)
    seg0 = split.SEGMENT_BYTES
    sweep = {}
    try:
        split.SEGMENT_BYTES = 1 << 30   # no stream long enough: one lane each
        one_lane, st1 = median_calls(dt, metrics, streams, cap, raw, 1)
        if "split_streams" in st1:
            raise AssertionError("batch split: the one-lane route split")
        for seg in BATCH_SPLIT_SWEEP:
            split.SEGMENT_BYTES = seg
            secs, sst = median_calls(dt, metrics, streams, cap, raw,
                                     BATCH_SPLIT_CALLS)
            sweep[seg] = {**secs, "lanes": sst["split_lanes"],
                          "lanes_valid": sst["split_lanes_valid"]}
    finally:
        split.SEGMENT_BYTES = seg0
    return {"images": len(raw), "raw": sum(len(r) for r in raw),
            "comp": comp, "launches": launches, "lanes": st["split_lanes"],
            "lanes_valid": st["split_lanes_valid"],
            "fallbacks": len(st["host_fallbacks"]),
            "tok_rows": int(carry["tok_rows"]), "T": st["T"],
            "launch_ms": launch_ms, "first_call": first, "warm": warm,
            "one_lane": one_lane, "held_valid": n_valid,
            "err": max(err_valid, held["err"]), "valid_loop_ms": valid_ms,
            "held": held, "sweep": sweep, "segment": seg0}

def phase_deflate(dt, native, hp, deflate_stages, payloads):
    """9: the hybrid encode against the C++ encoder, and the closed-form
    scan pack against the reservoir loop."""
    pays = payloads[:DEFLATE_STREAMS]
    rec = deflate_stages(pays, 1)        # byte-identity is held in there
    _, want = native.native_deflate_batch(pays, level=6)
    for pack in ("scan", "scatter"):
        st = {}
        outs = dt.device_deflate(pays, level=6, pack=pack, stats_out=st)
        if outs != want or st["device_fallbacks"]:
            raise AssertionError(f"device_deflate({pack}): differs from the "
                                 f"C++ encoder, or fell back")
        bad = [i for i, (o, p) in enumerate(zip(outs, pays))
               if zlib.decompress(o) != p]
        if bad:
            raise AssertionError(f"device_deflate({pack}): zlib disagrees "
                                 f"on lanes {bad[:5]}")
    # 64 lanes spread over the batch, the fields as the encode makes them
    pick = pays[:: DEFLATE_STREAMS // PACK_LOOP_LANES][:PACK_LOOP_LANES]
    fields, n_fields, total_bits, _, _ = native.native_deflate_fields(pick)
    fd = torch.from_numpy(fields.view(np.int32)).cuda()
    nd = torch.from_numpy(n_fields.astype(np.int32)).cuda()
    ms, _ = cuda_ms(lambda: hp.pack_fields_scan(fd, nd), reps=3)
    got = hp.pack_fields_scan(fd, nd)
    # the loop pays for every step, so it runs over the steps that hold a
    # field; past them a lane never flushes and the slots must be zero
    used = int(n_fields.max())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = hp.pack_fields_scan_ref(fd[:, :used].contiguous(), nd)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    err = max_abs_diff([(got[0][:, :used], ref[0]), (got[1], ref[1]),
                        (got[2], ref[2])])
    if err or got[2].cpu().tolist() != total_bits.tolist() \
            or bool(got[0][:, used:].any()):
        raise AssertionError(f"pack_fields_scan: closed form and reservoir "
                             f"loop differ (max {err})")
    return rec, ms, loop_s, fields.shape, used


def phase_sharded(decode_cu, metrics, streams, payloads, raw):
    """10: the sharded decode on the card.  Returns the record of the
    kernels' JSON line."""
    import tempfile

    import torch.distributed as dist

    from defl_tpu_torch import bench_scaling, dryrun
    from defl_tpu_torch.parallel import multihost
    from defl_tpu_torch.parallel.mesh import make_stream_mesh
    from defl_tpu_torch.parallel.shard import DistributedCodec

    t_phase = time.perf_counter()

    def decode_batch(codec, what):
        f0 = metrics.snapshot().get("host_fallback_lanes", 0)
        decode_cu.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, outs, st = codec.inflate(streams, dst_capacities=BLOCK)
        wall = time.perf_counter() - t0
        launches = decode_cu.launches
        fallbacks = metrics.snapshot().get("host_fallback_lanes", 0) - f0
        bad = [i for i, (r, o) in enumerate(zip(res, outs))
               if r != 0 or o != payloads[i]]
        if bad or len(outs) != N_STREAMS:
            raise AssertionError(f"{what}: {len(bad)} lanes wrong or out of "
                                 f"order, first {bad[:5]}")
        if st["ok_lanes"] != N_STREAMS or st["total_bytes"] != raw:
            raise AssertionError(f"{what}: ok_lanes {st['ok_lanes']}, "
                                 f"total_bytes {st['total_bytes']}")
        if launches != 1 or st["decode_launches"] != 1:
            raise AssertionError(f"{what}: {launches} decode_stream launches")
        if fallbacks or st["host_fallbacks"]:
            raise AssertionError(f"{what}: host fallbacks {fallbacks}")
        return wall, launches, st

    # (a) one shard on cuda:0, no group
    codec = DistributedCodec(make_stream_mesh(["cuda:0"]))
    wall_a, launches_a, _ = decode_batch(codec, "[10a]")
    log(f"[10a] DistributedCodec(cuda:0): {N_STREAMS} lanes OK and "
        f"byte-equal in submission order, ok_lanes {N_STREAMS}, total_bytes "
        f"{raw}, {launches_a} decode_stream launch, 0 host fallbacks; wall "
        f"{wall_a:.3f} s = {raw / wall_a / 1e9:.4f} GB/s")
    ov = bench_scaling.measure_overhead(block=BLOCK, reps=3, device="cuda:0",
                                        batch=(payloads, streams))
    log(f"[10a] bench_scaling overhead (3 interleaved rounds, best of each): "
        f"dist_overhead_pct {ov['dist_overhead_pct']:.2f}, codec "
        f"{ov['codec1_s']:.4f} s {ov['codec1_rounds_s']}, raw device_inflate "
        f"{ov['raw_device_inflate_s']:.4f} s {ov['raw_rounds_s']} "
        f"({ov['device']})")

    # (b) an NCCL group of one rank
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        multihost.initialize(f"file://{tmp}/store", 1, 0, backend="nccl",
                             device="cuda:0", timeout_s=300)
        try:
            codec = DistributedCodec(make_stream_mesh(["cuda:0"]))
            if not codec.mesh.grouped or dist.get_backend() != "nccl":
                raise AssertionError("[10b]: no NCCL group under the mesh")
            wall_b, launches_b, st_b = decode_batch(codec, "[10b]")
            dcodec = DistributedCodec(make_stream_mesh(["cuda:0"]),
                                      dictionary=dryrun.DICTIONARY)
            dpay, dstr = dryrun.dict_streams(64)
            dres, douts, dst = dcodec.inflate(dstr, dst_capacities=512)
            if douts != dpay or any(int(r) != 0 for r in dres) \
                    or dst["ok_lanes"] != 64:
                raise AssertionError("[10b]: dictionary streams wrong")
            if st_b["reduced_on"] != "cuda:0" \
                    or dst["reduced_on"] != "cuda:0":
                raise AssertionError(f"[10b]: stats reduced on "
                                     f"{st_b['reduced_on']}")
        finally:
            dist.destroy_process_group()
    log(f"[10b] NCCL group of one rank (FileStore, device_id cuda:0): "
        f"{N_STREAMS} lanes OK and byte-equal, {launches_b} launch, stats "
        f"all-reduced on {st_b['reduced_on']}; 64 dictionary streams "
        f"through the broadcast OK; wall {wall_b:.3f} s; group destroyed")

    # (c) two processes that share cuda:0 under gloo
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gloo_") as tmp:
        t0 = time.perf_counter()
        np.save(f"{tmp}/lengths.npy",
                np.array([len(x) for x in streams], np.int64))
        with open(f"{tmp}/streams.bin", "wb") as f:
            for x in streams:
                f.write(x)
        written = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = dryrun.run_workers(
            "shared_device_worker", 2, "gloo", ["cuda:0", "cuda:0"],
            dict(n_streams=N_STREAMS, block=BLOCK, device="cuda:0"),
            timeout_s=600, workdir=tmp)
        wall_c = time.perf_counter() - t0
    half = N_STREAMS // 2
    for r in ranks:
        k = r["rank"]
        log(f"[10c] rank {k}: {json.dumps(r)}")
        if r["rows"] != [k * half, (k + 1) * half] or r["launches"] != 1 \
                or r["ok_lanes"] != N_STREAMS or r["total_bytes"] != raw \
                or r["host_fallbacks"] or r["reduced_on"] != "cpu" \
                or r["dict_ok_lanes"] != 64:
            raise AssertionError(f"[10c] rank {k}: {r}")
    log(f"[10c] 2 gloo processes on cuda:0: each decoded its {half} "
        f"host-major rows in 1 launch, OK and byte-equal, ok_lanes "
        f"{N_STREAMS} and total_bytes {raw} over both; rank 1 decoded the "
        f"dictionary streams with rank 0's dictionary; streams file written "
        f"in {written:.2f} s, workers {wall_c:.2f} s (start-up included), "
        f"their decodes {[round(r['wall_s'], 4) for r in ranks]} s")
    log(f"[10] the sharded decode took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": {"10a": launches_a, "10b": launches_b,
                         "10c": [r["launches"] for r in ranks]},
            "wall_s": {"10a": wall_a, "10b": wall_b,
                       "10c": [r["wall_s"] for r in ranks]},
            "dist_overhead_pct": ov["dist_overhead_pct"],
            "codec1_s": ov["codec1_s"],
            "raw_device_inflate_s": ov["raw_device_inflate_s"]}


def phase_mixed_launch(decode_cu, ib, pack, native, mixed, bad, streams,
                       payloads):
    """11a: the clean and the mixed batch in one launch each, in turns;
    the corpus lanes of the mixed launch against the clean launch, its
    malformed lanes against the chunk loop."""
    dev = torch.device("cuda")
    up = lambda a: torch.from_numpy(a).to(dev)
    T = ib.step_budget(BLOCK)
    args, packed = {}, {}
    for name, batch in (("clean", streams), ("mixed", mixed)):
        p = pack.pack_streams(batch, 1, BLOCK)
        packed[name] = p
        args[name] = (up(p.words.view(np.int32)), up(p.nbits), up(p.zflag),
                      up(p.dst_cap))
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    launch = decode_cu._launch_stream

    def timed_launch(*a, **k):
        e0.record()
        launch(*a, **k)
        e1.record()

    times = {"clean": [], "mixed": []}
    runs = {}
    decode_cu._launch_stream = timed_launch
    try:
        for _ in range(MIXED_ROUNDS + 1):    # the first round warms up
            for name in ("clean", "mixed"):
                runs[name] = None            # one token buffer at a time
                runs[name] = decode_cu.decode_tokens(*args[name], T=T)
                torch.cuda.synchronize()
                times[name].append(e0.elapsed_time(e1))
    finally:
        decode_cu._launch_stream = launch
    times = {k: v[1:] for k, v in times.items()}

    # the corpus lanes: the clean launch's end state, and their payloads
    good = np.setdiff1d(np.arange(N_STREAMS), bad)
    state = {name: {k: c[k].cpu().numpy() for k in ("status", "dst_pos",
                                                    "bitpos")}
             for name, (_, c) in runs.items()}
    moved = sorted({int(i) for k in state["clean"] for i in good[
        state["clean"][k][good] != state["mixed"][k][good]]})
    tok, carry = runs["mixed"]
    del runs
    dst = state["mixed"]["dst_pos"]
    toks = tok[:carry["tok_rows"]].T.contiguous().cpu().numpy().view(
        np.uint32)
    out = native.native_resolve_tokens(toks, packed["mixed"].words, dst,
                                       BLOCK)
    del toks
    wrong = [int(i) for i in good
             if out[i, : dst[i]].tobytes() != payloads[i]]
    if moved or wrong:
        raise AssertionError(f"[11a] corpus lanes of the mixed launch: "
                             f"{len(moved)} ended elsewhere than in the clean "
                             f"launch (first {moved[:5]}), {len(wrong)} not "
                             f"their payload (first {wrong[:5]})")
    del out

    # the malformed lanes of that launch against the chunk loop over the
    # same lanes of its arguments
    sub = [a[torch.as_tensor(bad, device=dev)] for a in args["mixed"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts, pc = [], None
    for _ in range(40):
        ptok, pc = decode_cu.decode_tokens(*sub, T=T, K=PLAIN_K, carry=pc,
                                           _chunk=decode_cu.decode_chunk_ref)
        parts.append((ptok, pc["tok_rows"]))
        if not (pc["status"] == ib.STATUS_RUNNING).any():
            break
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = held_equal(decode_cu, decode_cu.select_lanes((tok, carry), bad),
                     (parts, pc), f"[11a] {len(bad)} malformed lanes")
    classes = {str(k): int(v) for k, v in zip(*np.unique(
        state["mixed"]["status"][bad], return_counts=True))}
    return {"ms": float(np.median(times["mixed"])),
            "clean_ms": float(np.median(times["clean"])), "times": times,
            "malformed_lanes": len(bad), "device_classes": classes,
            "corpus_lanes_moved": len(moved), "corpus_lanes_wrong": len(wrong),
            "max_abs_err": err, "plain_ms": plain_ms,
            "plain_steps": sum(r for _, r in parts) // 2}


def run_bounded(cmd, budget_s, cwd):
    """``cmd`` in a session of its own, killed with everything it started
    when it outlasts ``budget_s``: (exit code or None, output)."""
    import os
    import signal

    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=budget_s)
        return proc.returncode, out
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        return None, out


def phase_sanitizer():
    """11c: the malformed check of defl_tpu_torch.malformed (both
    resolvers, the split decode) in a subprocess under compute-sanitizer:
    memcheck, then racecheck if it ends within its budget.  None when the
    tool is absent, or present but refusing the card (its own "Device not
    supported": it then checks nothing)."""
    import os

    from defl_tpu_torch.malformed import sanitizer_path, sanitizer_refusal

    san = sanitizer_path()
    if san is None:
        log("[11c] compute-sanitizer is absent (not on the PATH, not under "
            "the CUDA toolkit): the sanitizer did NOT run")
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    rec = {"tool": san}
    for tool, lanes, budget in SANITIZER_RUNS:
        cmd = [san, "--tool", tool, "--error-exitcode", "1", sys.executable,
               "-m", "defl_tpu_torch.malformed", "--lanes", str(lanes)]
        t0 = time.perf_counter()
        rc, out = run_bounded(cmd, budget, here)
        secs = time.perf_counter() - t0
        summary = [ln.strip() for ln in out.splitlines()
                   if "ERROR SUMMARY" in ln or "RACECHECK SUMMARY" in ln]
        refused = sanitizer_refusal(out)
        if refused:
            log(f"[11c] {san} is present but refuses this card ({refused!r}, "
                f"after {secs:.0f} s): the sanitizer did NOT run, and no "
                f"tool checked the launches")
            return None
        if rc is None and tool != "memcheck":
            rec[tool] = {"lanes": lanes, "finished": False, "budget_s": budget}
            log(f"[11c] {tool} over {lanes} lanes did not end within its "
                f"{budget} s budget: not run to its end")
            continue
        if rc != 0:
            raise AssertionError(f"[11c] {tool} over {lanes} lanes: exit {rc} "
                                 f"after {secs:.0f} s, {summary}; output "
                                 f"ends:\n{out[-3000:]}")
        rec[tool] = {"lanes": lanes, "finished": True, "errors": 0,
                     "s": secs, "summary": summary[-1:]}
        log(f"[11c] {tool} over the {lanes}-lane mixed batch, both "
            f"resolvers and the mutated split decode: clean "
            f"({summary[-1] if summary else 'no summary line'}), "
            f"{secs:.1f} s; the checked run's line: "
            f"{out.strip().splitlines()[-1][:300] if out.strip() else ''}")
    return rec


def phase_bench(tok_rows):
    """12: ``python -m defl_tpu_torch.bench`` at its defaults (8192 x 64 KiB,
    on the card) in a process of its own, killed past its budget.  Its line
    must carry no error, every ``*_ok`` true, the card's name, a value above
    0, a token fetch of exactly ``tok_rows`` (the whole-batch launch's of
    [2c]) x 8192 x 4 B a batch, the 64 MiB stream on the device route, and
    the keys of the scaling modes it ran at its own size (``overhead``;
    ``scaling`` with two cards or more); and the bench must have launched
    the decode kernel and never the checked build (the counts its process
    logs).  Returns (the line, its log lines, decode_stream launches,
    seconds)."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    rc, out = run_bounded([sys.executable, "-m", "defl_tpu_torch.bench"],
                          BENCH_BUDGET_S, here)
    secs = time.perf_counter() - t0
    lines = out.strip().splitlines()
    if rc is None:
        raise AssertionError(f"[12] the bench did not end within "
                             f"{BENCH_BUDGET_S} s; output ends:\n"
                             f"{out[-3000:]}")
    line = json.loads(lines[-1]) if lines else {}
    launched = [json.loads(ln[len("launches: "):]) for ln in lines
                if ln.startswith("launches: ")]
    want = tok_rows * N_STREAMS * 4
    wrong = [k for k in BENCH_OK_KEYS if line.get(k) is not True]
    n_cards = torch.cuda.device_count()
    scaling_keys = ["dist_overhead_pct", "codec1_s", "raw_device_inflate_s"]
    if n_cards > 1:
        scaling_keys += ["shard1_s", f"shard{n_cards}_s"]
    missing = [k for k in scaling_keys if k not in line]
    if rc != 0 or "error" in line or wrong or missing \
            or line.get("device") != torch.cuda.get_device_name(0) \
            or not line.get("value", 0) > 0 \
            or line.get("pipeline_fetch_bytes_per_batch") != want \
            or line.get("large64_device_route") != "device" \
            or not launched or launched[-1]["decode_stream"] <= 0 \
            or any(launched[-1]["checked"].values()):
        raise AssertionError(f"[12] the bench: exit {rc}, not true: {wrong}, "
                             f"keys missing: {missing}, fetch bytes a batch "
                             f"against {want}, launches {launched}; output "
                             f"ends:\n{out[-4000:]}")
    return line, lines[:-1], launched[-1]["decode_stream"], secs


def ptxas_kernels(log: str, what: str) -> dict:
    """Each kernel's registers, spill stores and loads, stack frame and
    static shared memory, from the ``nvcc -Xptxas -v`` report of the build
    ``what``; fails unless the report has every kernel of
    ``KERNEL_NAMES``."""
    import re

    out, entry, props = {}, None, None
    pick = lambda name: next((k for k in KERNEL_NAMES if k in name), None)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            entry = pick(m.group(1))
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            props = pick(m.group(1))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and props:
            out.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
            props = None
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry:
            sm = re.search(r"(\d+) bytes smem", ln)
            out.setdefault(entry, {}).update(
                registers=int(m.group(1)), smem=int(sm.group(1)) if sm else 0)
            entry = None
    missing = [k for k in KERNEL_NAMES if "registers" not in out.get(k, {})]
    if missing:
        raise AssertionError(f"the {what} build's ptxas report ({len(log)} "
                             f"chars) has no line for {missing}")
    return out


class timed_entry:
    """While active, every call of the library entry point ``name`` of
    ``lib`` is bracketed by CUDA events on the current stream: ``ms`` lists
    the launches' device times (read after a sync)."""

    def __init__(self, lib, name):
        self.lib, self.name, self.events = lib, name, []

    def __enter__(self):
        self.fn = getattr(self.lib, self.name)

        def call(*a):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            rc = self.fn(*a)
            e1.record()
            self.events.append((e0, e1))
            return rc

        setattr(self.lib, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.lib, self.name, self.fn)

    @property
    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def held_identical(decode_cu, plain, checked, what) -> int:
    """A checked decode against the unchecked one, call by call, bit for
    bit (``decode_cu.identical_decodes``): the token rows, every tensor of
    the carry (state rows, lens, count/first/offs/maxlen/syms) and the
    totals but the clock's."""
    if len(plain) != len(checked):
        raise AssertionError(f"{what}: {len(plain)} unchecked calls, "
                             f"{len(checked)} checked")
    for i, (a, b) in enumerate(zip(plain, checked)):
        differ = decode_cu.identical_decodes(a, b)
        if differ:
            raise AssertionError(f"{what}: call {i}'s checked launch differs "
                                 f"from the unchecked one in {differ}")
    return 0


def checked_runs(decode_cu, ib, args, kw, revive=None):
    """``decode_tokens`` over the same calls unchecked and checked: each a
    list of (tokens, carry), one per call, until no lane is RUNNING; with
    ``revive`` (a capacity tensor), EFULL lanes are then revived once with
    it and run on."""
    out = []
    for checked in (False, True):
        words, nbits, zflag, cap = args
        calls, carry, rev = [], None, revive
        for _ in range(12):
            tok, carry = decode_cu.decode_tokens(
                words, nbits, zflag, cap, carry=carry, checked=checked, **kw)
            calls.append((tok, carry))
            if not (carry["status"] == ib.STATUS_RUNNING).any():
                if rev is None:
                    break
                cap, carry, rev = rev, ib.revive_carry(carry, new_cap=rev), None
        else:
            raise AssertionError("[13]: lanes still RUNNING after 12 calls")
        out.append(calls)
    return out


def injected(fn, kernel, site, lane, block, slot) -> int:
    """``fn`` makes a checked launch with one access injected at ``site``
    in ``lane``: it must raise with that kernel, site, lane, block and
    slot.  Returns 1."""
    from defl_tpu_torch.ops.cuda import build

    try:
        fn()
    except build.KernelFault as e:
        got = (e.kernel, e.site, e.lane, e.block, e.slot)
        if got != (kernel, site, lane, block, slot):
            raise AssertionError(f"[13] the access injected at {site!r} in "
                                 f"lane {lane} (block {block}, slot {slot}) "
                                 f"of {kernel} came back as {e}")
        return 1
    raise AssertionError(f"[13] {kernel}: the access injected at {site!r} "
                         f"in lane {lane} was not caught")


def phase_checked(dt, decode_cu, checksums_cu, ib, pack, malformed, streams,
                  payloads, mixed, big64, flags):
    """13: the kernels' checked build over every malformed and edge input
    of the port (module doc).  Returns the "checked" record of each kernel
    on the kernels' line."""
    from defl_tpu_torch import corpus
    from defl_tpu_torch.ops.cuda import build

    dev = torch.device("cuda")
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    lanes = decode_cu.STREAM_THREADS // 32 * decode_cu.STREAM_LANES_PER_WARP
    mid = lanes // 2
    decode_cu.checked_launches = decode_cu.checked_chunk_launches = 0
    checksums_cu.checked_launches = 0
    build.faults.update(dict.fromkeys(build.faults, 0))
    libs = (build.load(), build.load(checked=True))
    T = ib.step_budget(BLOCK)
    inputs = {"batch": 0, "shared_input": 0, "chunk": 0, "adler32": 0}

    # 1. the bench batch, clean (timed in turns with the unchecked launch)
    # and with every 8th lane malformed
    times = {}
    for name, batch in (("clean", streams), ("mixed", mixed)):
        p = pack.pack_streams(batch, 1, BLOCK)
        args = (up(p.words.view(np.int32)), up(p.nbits), up(p.zflag),
                up(p.dst_cap))
        del p
        turns = (False, True, True, False) * (
            CHECKED_ROUNDS if name == "clean" else 1)
        # the first launch of each build warms up (the module's first load)
        runs = {c: decode_cu.decode_tokens(*args, T=T, checked=c)
                for c in (False, True)}
        timers = [timed_entry(lib, "decode_stream_launch") for lib in libs]
        with timers[0], timers[1]:
            for checked in turns:
                runs[checked] = None        # one token buffer a build
                runs[checked] = decode_cu.decode_tokens(*args, T=T,
                                                        checked=checked)
        times[name] = [t.ms for t in timers]
        held_identical(decode_cu, [runs[False]], [runs[True]],
                       f"[13] {name} batch")
        if (runs[True][1]["status"] == ib.STATUS_RUNNING).any():
            raise AssertionError(f"[13] {name} batch: lanes still RUNNING")
        inputs["batch"] += 1
        del runs, args
        torch.cuda.empty_cache()

    # 2. the fuzz cases, the C4/C5 cut streams, [2a]'s matrix with its
    # EFULL resume, and its dictionary stream
    base = corpus.fuzz_payloads(payloads)
    small = [(f"fuzz seed {seed}", pack.pack_streams(
        [d for _, d in corpus.fuzz_cases(seed, 60, base)], 1, 1024),
        {"T": ib.step_budget(1024)}, None) for seed in CHECKED_FUZZ_SEEDS]
    small.append(("C4/C5 cut streams", pack.pack_streams(
        [bytes.fromhex(h) for h in BAD_CODE_CUT_SHORT], 0, 1024),
        {"T": ib.step_budget(1024)}, None))
    pm, _, (pd, d, _) = small_matrix(pack)
    small.append(("[2a] matrix, EFULL and its resume", pm,
                  {"T": 4096, "K": 64},
                  torch.full((pm.n,), 8192, dtype=torch.int32, device=dev)))
    small.append(("[2a] dictionary stream", pd,
                  {"T": 4096, "K": 64, "has_dict": True,
                   "dict_len": pack.pack_dictionary(d)[1]}, None))
    for what, pk, kw, revive in small:
        plain, chk = checked_runs(decode_cu, ib, (pk.words, pk.nbits,
                                                  pk.zflag, pk.dst_cap),
                                  kw, revive)
        held_identical(decode_cu, plain, chk, f"[13] {what}")
        inputs["batch"] += 1

    # 3. the 64 MiB stream's split decode, the very launch inflate_large
    # makes: clean, and with [11b]'s 16 bit flips and cut tail
    shared_args = None
    mutated = malformed.mutate(big64[1], MIXED_SEED, malformed.FLIPS, True)
    for what, data in (("clean", big64[1]),
                       ("16 bit flips and a cut tail", mutated)):
        calls = []
        decode = decode_cu.decode_tokens

        def kept(*a, **k):
            out = decode(*a, **k)
            calls.append((a, k, out))
            return out

        decode_cu.decode_tokens = kept
        try:
            dt.inflate_large(data, flags, use_device=True)
        finally:
            decode_cu.decode_tokens = decode
        if len(calls) != 1:
            raise AssertionError(f"[13] split decode, {what}: {len(calls)} "
                                 f"decodes")
        a, k, out = calls.pop()
        held_identical(decode_cu, [out],
                       [decode_cu.decode_tokens(*a, **k, checked=True)],
                       f"[13] split decode, {what}")
        inputs["shared_input"] += 1
        shared_args = shared_args or (a, k)
        del out

    # 4. the chunk kernel on [2b]'s chunk, timed in turns
    packed = pack.pack_streams(streams, 1, BLOCK)
    chunk_in, words = big_chunk(decode_cu, ib, packed)
    del packed
    outs = {}
    timers = [timed_entry(lib, "decode_chunk_launch") for lib in libs]
    with timers[0], timers[1]:
        for checked in (False, True) + (False, True, True, False):
            x = [t.clone() for t in chunk_in]
            outs[checked] = decode_cu.decode_chunk(
                x[0], x[1], words, *x[2:], K=CHUNK_K, checked=checked)
    chunk_ms = [t.ms[1:] for t in timers]         # after a warm-up each
    if not all(torch.equal(a, b) for a, b in zip(outs[False], outs[True])):
        raise AssertionError("[13] the checked chunk kernel differs from the "
                             "unchecked one (tokens, state rows or lens)")
    inputs["chunk"] += 1
    del outs

    # 5. adler32 on the bench's rows (timed in turns), and at lengths -1,
    # 0, C and C + 1 over rows that start off a 16-byte boundary
    host = np.zeros((N_STREAMS, BLOCK), np.uint8)
    for i, pl in enumerate(payloads):
        host[i, : len(pl)] = np.frombuffer(pl, np.uint8)
    data = up(host)
    del host
    lengths = up(np.asarray([len(pl) for pl in payloads], np.int32))
    sums = {}
    timers = [timed_entry(lib, "adler32_batch_launch") for lib in libs]
    with timers[0], timers[1]:
        for checked in (False, True) + (False, True, True, False) * \
                CHECKED_ROUNDS:
            sums[checked] = checksums_cu.adler32_batch_cuda(
                data, lengths, checked=checked)
    adler_ms = [t.ms[1:] for t in timers]         # after a warm-up each
    C = 6001
    g = torch.Generator(device="cpu").manual_seed(13)
    wide = torch.randint(0, 256, (8, C + 67), dtype=torch.uint8,
                         generator=g).to(dev)
    edge = torch.tensor([-1, 0, C, C + 1, 1, 15, 17, C - 1],
                        dtype=torch.int32, device=dev)
    edges = [checksums_cu.adler32_batch_cuda(wide[:, 3:3 + C], edge,
                                             checked=checked)
             for checked in (False, True)]
    if not torch.equal(sums[False], sums[True]) \
            or not torch.equal(*edges):
        raise AssertionError("[13] the checked adler32 kernel differs from "
                             "the unchecked one")
    inputs["adler32"] += 2
    # the fault records' counts over every input (each launch raised on a
    # fault already)
    faults = dict(build.faults)
    if any(faults.values()):
        raise AssertionError(f"[13] faults over the inputs: {faults}")

    # one injected access a site, in the middle slot of a block in the
    # middle of each launch
    caught = {"batch": 0, "shared_input": 0, "chunk": 0, "adler32": 0}
    pk = pack.pack_streams(streams[:INJECT_LANES], 1, BLOCK)
    args = (up(pk.words.view(np.int32)), up(pk.nbits), up(pk.zflag),
            up(pk.dst_cap))
    b = INJECT_LANES // lanes // 2
    lane = int(decode_cu.stream_order(pk.nbits)[b * lanes + mid])
    for site in STREAM_SITES:
        caught["batch"] += injected(
            lambda: decode_cu.decode_tokens(*args, T=T, inject=(site, lane)),
            "decode_stream", site, lane, b, mid)
    a, k = shared_args
    b = len(a[1]) // lanes // 2
    lane = int(decode_cu.stream_order(a[1], k["limit"], k["start_bit"])[
        b * lanes + mid])
    for site in STREAM_SITES:
        caught["shared_input"] += injected(
            lambda: decode_cu.decode_tokens(*a, **k, inject=(site, lane)),
            "decode_stream", site, lane, b, mid)
    b = chunk_in[0].shape[1] // 128 // 2
    lane = b * 128 + 64
    for site in CHUNK_SITES:
        x = [t.clone() for t in chunk_in]
        caught["chunk"] += injected(
            lambda: decode_cu.decode_chunk(x[0], x[1], words, *x[2:],
                                           K=CHUNK_K, inject=(site, lane)),
            "decode_chunk", site, lane, b, 64)
    lane = N_STREAMS // 2
    caught["adler32"] += injected(
        lambda: checksums_cu.adler32_batch_cuda(data, lengths,
                                                inject=("adler32", lane)),
        "adler32_batch", "adler32", lane, lane, 0)

    med = lambda v: float(np.median(v))
    return {
        "inputs": inputs, "caught": caught,
        "launches": {"decode_stream": decode_cu.checked_launches,
                     "decode_chunk": decode_cu.checked_chunk_launches,
                     "adler32_batch": checksums_cu.checked_launches},
        "ms": {"clean": [med(times["clean"][1]), med(times["clean"][0])],
               "mixed": [med(times["mixed"][1]), med(times["mixed"][0])],
               "chunk": [med(chunk_ms[1]), med(chunk_ms[0])],
               "adler32": [med(adler_ms[1]), med(adler_ms[0])]},
        "times": {"clean": times["clean"], "chunk": chunk_ms,
                  "adler32": adler_ms},
        "faults": faults,
        "ptxas": {"unchecked": ptxas_kernels(build.build_log, "unchecked"),
                  "checked": ptxas_kernels(build.checked_build_log,
                                           "checked")}}


def find_scanned_bytes(finds, hits) -> int:
    """The bytes the finds must read: each window from its start up to its
    hit, or whole where it has none (the bound of [14])."""
    _, lens, lo, hi = (np.asarray(x, np.int64) for x in finds)
    a, b = np.maximum(lo, 0), np.minimum(hi, 8 * lens - FIND_TAIL_BITS)
    hits = np.asarray(hits, np.int64)
    upto = np.where(hits >= 0, hits + 1, b)
    return int(np.maximum(upto - a, 0).sum() // 8)


def kodak_find_args(seed: int):
    """A kodak32.batch call's joined body and its finds, as split._pack
    makes them: the IDAT bodies without their zlib headers, one find at
    every segment target of every stream."""
    from defl_tpu_torch.runtime import split

    _, inputs = kodak_batch(seed)
    bodies = [b"".join(bytes(c) for c in chunks)[2:] for chunks in inputs]
    offs, lens, lo, hi, at = [], [], [], [], 0
    seg = split.SEGMENT_BYTES
    for b in bodies:
        n_seg = len(b) // seg
        for k in range(1, n_seg):
            t = k * 8 * len(b) // n_seg
            offs.append(at)
            lens.append(len(b))
            lo.append(t)
            hi.append(min(t + 16 * seg, 8 * len(b)))
        at += len(b)
    return np.frombuffer(b"".join(bodies), np.uint8), (offs, lens, lo, hi)


def silesia_stream(seed: int) -> bytes:
    """One silesia.large archive as its zlib stream (211,957,760 B raw),
    made by the benchmark's generator."""
    from codec_bench.data import silesia_tar

    with open("codec_bench/configs/silesia_tar_zlib6.json") as f:
        fmt = json.load(f)["format"]
    return silesia_tar.make_pool(fmt, seed, 1, 1)[0].streams[0]


def silesia_find_args(stream: bytes):
    """The large route's finds over an archive's body: one at every
    SEGMENT_BYTES target (large._find_candidates)."""
    from defl_tpu_torch.runtime import large

    body = np.frombuffer(stream, np.uint8)[2:]
    seg = large.SEGMENT_BYTES
    lo = [k * 8 * seg for k in range(1, body.size // seg)]
    return body, ([0] * len(lo), [body.size] * len(lo), lo,
                  [min(t + 16 * seg, 8 * body.size) for t in lo])


def find_fuzz_args():
    """The fuzz corpus's streams (seeds of tests/test_fuzz.py), random
    bytes and streams of small blocks, back to back in one body at odd
    offsets, each searched every 256 bytes, whole, and past its ends."""
    from defl_tpu_torch import corpus

    blocks = corpus.make_silesia_like(8 * 65536)
    pays = corpus.fuzz_payloads(blocks)
    rng = np.random.default_rng(11)
    streams = [d for s in CHECKED_FUZZ_SEEDS
               for _, d in corpus.fuzz_cases(s, 60, pays) if d]
    streams.append(rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
    for ml in (4, 8):
        co = zlib.compressobj(6, zlib.DEFLATED, -15, ml)
        streams.append(co.compress(blocks[1]) + co.flush())
    parts, offs, lens, lo, hi, at = [b"\x5a"], [], [], [], [], 1
    for d in streams:
        n = len(d)
        wins = [(8 * t, 8 * (t + 2048)) for t in range(0, n, 256)]
        wins += [(-37, 8 * n + 999), (0, 8 * n), (8 * n - 300, 8 * n)]
        for a, b in wins:
            offs.append(at)
            lens.append(n)
            lo.append(a)
            hi.append(b)
        parts += [d, b"\xa5\x5a\xff"]
        at += n + 3
    return np.frombuffer(b"".join(parts), np.uint8), (offs, lens, lo, hi)


def find_on_card(find_cu, body_dev, finds, **kw):
    return find_cu.find_block_starts(body_dev, *finds, **kw).numpy()


def phase_find_shape(find_cu, native, name, body, finds):
    """[14] at one shape: the kernel against the native finder and the
    plain version on every find, the three timed; the checked build on the
    same finds.  Returns its record."""
    lib = native.load()
    dev = torch.device("cuda")
    body_dev = torch.from_numpy(body.copy()).to(dev)
    torch.cuda.synchronize()
    want = native.find_block_starts(lib, body, *finds)
    host_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        native.find_block_starts(lib, body, *finds)
        host_s.append(time.perf_counter() - t0)
    l0 = find_cu.launches
    got = find_on_card(find_cu, body_dev, finds)
    if find_cu.launches != l0 + 1:
        raise AssertionError(f"[14] {name}: not one launch")
    err = int(np.abs(got - want).max(initial=0))
    wrong = np.flatnonzero(got != want)
    if wrong.size:
        raise AssertionError(f"[14] {name}: {wrong.size} of {len(want)} "
                             f"finds differ from the native finder, first "
                             f"{wrong[:5].tolist()}: kernel "
                             f"{got[wrong[:5]].tolist()}, native "
                             f"{want[wrong[:5]].tolist()}")
    ms, times = cuda_ms(lambda: find_cu.find_block_starts(body_dev, *finds),
                        reps=7)
    t0 = time.perf_counter()
    ref = find_cu.find_block_starts(torch.from_numpy(body.copy()),
                                    *finds).numpy()
    ref_s = time.perf_counter() - t0
    if ref.tolist() != want.tolist():
        raise AssertionError(f"[14] {name}: the plain version differs")
    ck = find_on_card(find_cu, body_dev, finds, checked=True)
    if ck.tolist() != want.tolist():
        raise AssertionError(f"[14] {name}: the checked build differs")
    ck_ms, _ = cuda_ms(lambda: find_cu.find_block_starts(
        body_dev, *finds, checked=True), reps=3)
    scanned = find_scanned_bytes(finds, want)
    bound_ms, bound_by = roofline(scanned, 0)
    return {"finds": len(want), "hits": int((want >= 0).sum()),
            "body_bytes": int(body.size), "max_abs_err": err,
            "ms": ms, "times": times,
            "host_s": float(np.median(host_s)), "host_times": host_s,
            "plain_s": ref_s,
            "checked_ms": ck_ms, "scanned_bytes": scanned,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_find(dt, find_cu, native, build, metrics, silesia):
    """[14]: the block finder on the card (module docstring)."""
    from defl_tpu_torch.runtime import large

    rec = {}
    faults0 = build.faults["find_starts"]
    for name, make in (("fuzz", find_fuzz_args),
                       ("kodak32", lambda: kodak_find_args(BATCH_SPLIT_SEED)),
                       ("silesia", lambda: silesia_find_args(silesia))):
        body, finds = make()
        rec[name] = phase_find_shape(find_cu, native, name, body, finds)
        log_find_shape(name, rec[name])
        if name == "fuzz":
            fuzz = torch.from_numpy(body.copy()).cuda(), finds, \
                native.find_block_starts(native.load(), body, *finds)
        del body

    # the two routes: one launch each, and the native finder's lanes
    seen = []
    orig = large.find_lane_starts

    def spy(body, spans, seg_bits, n_threads=None, body_dev=None):
        m0 = metrics.snapshot()
        got = orig(body, spans, seg_bits, n_threads, body_dev)
        m1 = metrics.snapshot()
        seen.append({
            "equal": got == orig(body, spans, seg_bits),
            "on_card": body_dev is not None
            and body_dev.device.type == "cuda",
            "finds": sum(len(s[3]) for s in spans),
            **{k: m1.get(k, 0) - m0.get(k, 0)
               for k in ("lane_finds", "lane_finds_card")}})
        return got

    large.find_lane_starts = spy
    try:
        raw, inputs = kodak_batch(BATCH_SPLIT_SEED)
        cap = max(len(r) for r in raw)
        routes = {}
        for name, call in (
                ("inflate_large", lambda: dt.inflate_large(
                    silesia, use_device=True)),
                ("inflate_batch", lambda: dt.inflate_batch(
                    inputs, backend="device", dst_capacities=cap))):
            l0 = find_cu.launches
            del seen[:]
            res = call()
            ok = res[0] == 0 if name == "inflate_large" else \
                [int(r) for r in res[0]] == [0] * len(raw) and res[1] == raw
            if not ok:
                raise AssertionError(f"[14] {name}: not OK")
            if find_cu.launches - l0 != 1 or len(seen) != 1 \
                    or not (seen[0]["equal"] and seen[0]["on_card"]) \
                    or seen[0]["lane_finds"] != seen[0]["finds"] \
                    or seen[0]["lane_finds_card"] != seen[0]["finds"]:
                raise AssertionError(f"[14] {name}: launches "
                                     f"{find_cu.launches - l0}, finds "
                                     f"{seen}")
            routes[name] = {"launches": find_cu.launches - l0, **seen[0]}
            del res
        rec["routes"] = routes
    finally:
        large.find_lane_starts = orig

    # the fault records' counts over the three shapes' checked launches
    rec["faults"] = build.faults["find_starts"] - faults0
    if rec["faults"]:
        raise AssertionError(f"[14] faults over the inputs: {rec['faults']}")

    # one injected read outside a find's stream, in thread 0 of the first
    # find that has a hit (so its window is not empty)
    fuzz_dev, finds, hits = fuzz
    k = int(np.flatnonzero(hits >= 0)[0])
    try:
        find_on_card(find_cu, fuzz_dev, finds, inject=k)
    except build.KernelFault as e:
        if (e.site, e.lane, e.slot) != ("find", k, find_cu.INJECT_SLOT) \
                or e.index < e.extent:
            raise AssertionError(f"[14] injection caught at the wrong "
                                 f"place: {e}") from e
        rec["injection"] = {k2: getattr(e, k2) for k2 in (
            "site", "lane", "block", "slot", "index", "extent")}
    else:
        raise AssertionError("[14] the injected read was not caught")
    rec["checked_launches"] = find_cu.checked_launches
    rec["ptxas"] = {b: ptxas_kernels(log, b).get("find_starts_kernel")
                    for b, log in (("unchecked", build.build_log),
                                   ("checked", build.checked_build_log))}
    return rec


def find_only() -> int:
    """[14] alone, after the builds [1] makes:
    ``python3 -c "import sys, chip_smoke as cs; sys.exit(cs.find_only())"``.
    """
    import defl_tpu_torch as dt
    from defl_tpu_torch import metrics
    from defl_tpu_torch.ops.cuda import build, find_cu
    from defl_tpu_torch.runtime import native

    smi = nvidia_smi()
    log(f"[14] card: {smi}")
    with ThreadPoolExecutor(max_workers=3) as ex:
        jobs = [ex.submit(native.load), ex.submit(build.load, True)]
        build.load()
        for j in jobs:
            j.result()
    t0 = time.perf_counter()
    silesia = silesia_stream(FIND_SILESIA_SEED)
    log(f"[14] the archive's stream: {len(silesia)} B, made in "
        f"{time.perf_counter() - t0:.1f} s")
    rec = phase_find(dt, find_cu, native, build, metrics, silesia)
    log_find(rec)
    print(json.dumps({"find_starts": rec}))
    print(smi)
    return 0


def log_find_shape(shape, r) -> None:
    log(f"[14] {shape}: {r['finds']} finds ({r['hits']} hits) over "
        f"{r['body_bytes']} B: kernel == native finder == the plain version "
        f"on every find (max_abs_err {r['max_abs_err']}), checked build "
        f"== both; kernel "
        f"{r['ms']:.4f} ms (median of {len(r['times'])}: "
        f"{[round(t, 4) for t in r['times']]}), native finder "
        f"{r['host_s'] * 1e3:.2f} ms on the host's threads, plain version "
        f"{r['plain_s']:.2f} s, checked {r['checked_ms']:.4f} ms; bound "
        f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['scanned_bytes']} B "
        f"scanned)")


def log_find(rec) -> None:
    for name, r in rec["routes"].items():
        log(f"[14] {name}: {r['launches']} find launch, {r['lane_finds']} "
            f"finds all on the card, lanes == the native finder's")
    log(f"[14] checked build: {rec['faults']} faults over the three shapes")
    log(f"[14] injected read outside find {rec['injection']['lane']}'s "
        f"stream caught: {json.dumps(rec['injection'])}; checked launches "
        f"{rec['checked_launches']}; ptxas {json.dumps(rec['ptxas'])}")


def no_checked_launches(decode_cu, checksums_cu, where):
    """The main path never launches the checked build."""
    from defl_tpu_torch.ops.cuda import find_cu

    n = (decode_cu.checked_launches, decode_cu.checked_chunk_launches,
         checksums_cu.checked_launches, find_cu.checked_launches)
    if any(n):
        raise AssertionError(f"{where}: checked launches (decode_stream, "
                             f"decode_chunk, adler32_batch, find_starts) {n}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1

    import defl_tpu_torch as dt
    from defl_tpu_torch import corpus, malformed, metrics
    from defl_tpu_torch.breakdown import (deflate_stages, lane_rows,
                                          large_stages)
    from defl_tpu_torch.corpus import make_silesia_like
    from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB
    from defl_tpu_torch.ops import checksums as ck
    from defl_tpu_torch.ops import huffman_pack as hp
    from defl_tpu_torch.ops import inflate_batch as ib
    from defl_tpu_torch.ops import resolve
    from defl_tpu_torch.ops.cuda import build, checksums_cu, decode_cu, find_cu
    from defl_tpu_torch.runtime import large, native, pack, split
    from defl_tpu_torch.runtime.session import fetch_tokens

    # ---- 1. device, and the three builds started together ----
    smi = nvidia_smi()
    log(f"[1] card: {smi}")
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as ex:
        host_build = ex.submit(native.load)
        checked_build = ex.submit(build.load, True)   # [13]'s
        build.load()
        host_build.result()
        checked_build.result()
    log(f"[1] builds: nvcc (decode_stream.cu, adler32_batch.cu, "
        f"find_starts.cu) "
        f"{build.build_seconds:.2f} s, its checked build (-DDEFL_CHECKED "
        f"-lineinfo) {build.checked_build_seconds:.2f} s, g++ (defl_batch.cc) "
        f"{native.build_seconds:.2f} s, together "
        f"{time.perf_counter() - t0:.2f} s; {build.lib_path()}, "
        f"{build.lib_path(True)}, {native.lib_path()}")
    for tag, text in (("", build.build_log),
                      ("checked ", build.checked_build_log)):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[1]   {tag}ptxas: {line.strip()}")

    # ---- 2a. small matrix ----
    err_small = phase_small_matrix(decode_cu, ib, pack, native)
    log(f"[2a] small matrix: stream kernel == chunk loop by the comparator "
        f"(also after EFULL -> revive_carry -> resume), chunk kernel == twin "
        f"slot for slot, bytes OK (max_abs_err {err_small})")

    # ---- corpus: the bench's own, 8192 zlib-6 streams x 64 KiB ----
    t0 = time.perf_counter()
    payloads = make_silesia_like(N_STREAMS * BLOCK, BLOCK)[:N_STREAMS]
    pool = ThreadPoolExecutor(max_workers=8)     # zlib releases the GIL
    streams = list(pool.map(lambda p: zlib.compress(p, 6), payloads))
    raw = sum(len(p) for p in payloads)
    comp = sum(len(s) for s in streams)
    log(f"[2b] corpus: {N_STREAMS} x {BLOCK} B, raw {raw} B, compressed "
        f"{comp} B, made in {time.perf_counter() - t0:.1f} s")

    # ---- 2b. one main-path chunk ----
    packed = pack.pack_streams(streams, 1, BLOCK)
    (err_big, ms, plain_ms, times, states, (dec_bound, dec_by),
     (moved, live_steps)) = phase_big_chunk(decode_cu, ib, packed)
    log(f"[2b] chunk N={N_STREAMS} K={CHUNK_K}: chunk kernel == twin bit for "
        f"bit; kernel {ms:.4f} ms (median of {times}), twin {plain_ms:.1f} "
        f"ms; bound {dec_bound:.4f} ms by {dec_by} ({moved} B moved, "
        f"{live_steps} working steps x {DECODE_OPS_PER_STEP} operations); "
        f"lane states after it {states}")

    # the big streams of [8b] are compressed meanwhile: [2c]'s times are
    # the card's, by CUDA events, and its plain run keeps one host thread
    # busy for longer than the compression lasts
    big = [pool.submit(big_stream, payloads, n) for n in LARGE_PAYLOADS]

    # ---- 2c. the whole batch in one launch ----
    (err_all, s_ms, s_times, s_stats, (s_bound, s_by), (s_moved, s_ops),
     s_plain_ms, s_rows, s_plain_steps) = phase_whole_batch(
        decode_cu, ib, native, lane_rows, packed, payloads)
    s_lanes = len(s_rows)
    log(f"[2c] whole batch N={N_STREAMS} x {BLOCK} B in one launch "
        f"({decode_cu.STREAM_THREADS} threads a block, "
        f"{decode_cu.STREAM_LANES_PER_WARP} lanes a warp): {N_STREAMS} lanes "
        f"OK and byte-equal; kernel {s_ms:.4f} ms (median of {s_times}); "
        f"tok_rows {s_stats['tok_rows']}, {s_stats['steps']} steps, "
        f"{s_stats['tokens']} tokens stored, "
        f"{s_stats['builds']} builds sorting {s_stats['sorted_symbols']} "
        f"symbols, builds' share of the lanes' cycles "
        f"{s_stats['build_share']:.4f}; bound {s_bound:.4f} ms by {s_by} "
        f"({s_moved} B moved, {s_ops} operations); {s_lanes} lanes of that "
        f"launch == the chunk loop by the comparator (max_abs_err {err_all}; "
        f"the chunk loop took {s_plain_ms:.0f} ms for those lanes, "
        f"{s_plain_steps} steps of K={PLAIN_K} chunks; token rows those "
        f"lanes used in the launch: {s_rows})")
    del packed
    big = [f.result() for f in big]     # before anything the host times
    pool.shutdown()

    # ---- 3. the main path, once ----
    m0 = metrics.snapshot()
    decode_cu.launches = 0
    checksums_cu.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, outputs = dt.inflate_batch(
        streams, backend="device", dst_capacities=BLOCK)
    wall = time.perf_counter() - t0
    launches = decode_cu.launches
    m1 = metrics.snapshot()
    fallbacks = m1.get("host_fallback_lanes", 0) - m0.get(
        "host_fallback_lanes", 0)
    bad = [i for i, (r, o) in enumerate(zip(results, outputs))
           if r != 0 or o != payloads[i]]
    if bad:
        raise AssertionError(f"main path: {len(bad)} lanes wrong, first "
                             f"{bad[:5]}")
    if fallbacks:
        raise AssertionError(f"main path: {fallbacks} host fallbacks")
    if launches <= 0:
        raise AssertionError("main path never launched the decode kernel")
    no_checked_launches(decode_cu, checksums_cu, "[3] main path")
    fetched = m1["token_fetch_bytes"] - m0.get("token_fetch_bytes", 0)
    log(f"[3] inflate_batch: {N_STREAMS} lanes OK and byte-equal, "
        f"0 host fallbacks, {launches} decode_stream launches (0 of the "
        f"checked build), {fetched} token bytes fetched; wall {wall:.3f} s "
        f"= {raw / wall / 1e9:.4f} GB/s")
    del results, outputs

    # ---- 4. pipeline over two distinct batches ----
    B = 2
    batches = [streams[i:] + streams[:i] for i in range(B)]
    pays_rot = [payloads[i:] + payloads[:i] for i in range(B)]

    def sink(i, status, out, dst_pos):
        ok = int((status == 0).sum())
        wrong = sum(out[k, : dst_pos[k]].tobytes() != pays_rot[i][k]
                    for k in range(len(status)))
        return ok, wrong

    f0 = metrics.snapshot().get("token_fetch_bytes", 0)
    l0 = decode_cu.launches
    per_batch, pwall = dt.pipeline_inflate(batches, BLOCK, sink=sink)
    fetched = metrics.snapshot()["token_fetch_bytes"] - f0
    if any(v != (N_STREAMS, 0) for v in per_batch):
        raise AssertionError(f"pipeline: (ok, wrong) per batch {per_batch}")
    if decode_cu.launches <= l0:
        raise AssertionError("pipeline never launched the decode kernel")
    no_checked_launches(decode_cu, checksums_cu, "[4] pipeline")
    # the warm-up decode of batch 0 fetches nothing: B fetches in the loop
    log(f"[4] pipeline_inflate: {B} batches, every lane OK and byte-equal; "
        f"wall {pwall:.3f} s, pipeline_wall_GBps "
        f"{raw * B / pwall / 1e9:.4f}, token fetch {fetched // B} B/batch")
    del batches, pays_rot, per_batch
    torch.cuda.empty_cache()

    # ---- 5. the adler32 kernel against its plain version ----
    err_a_small = phase_adler_small(ck)
    log(f"[5a] adler32 small matrix: kernel == plain version == zlib "
        f"(max_abs_err {err_a_small})")
    (err_a_full, a_ms, a_plain_ms, a_times, (a_bound, a_by),
     a_bytes) = phase_adler_full(ck, payloads)
    log(f"[5b] adler32 [{N_STREAMS}, {BLOCK}]: kernel == plain version == "
        f"zlib; kernel {a_ms:.4f} ms (median of {a_times}) = "
        f"{a_bytes / a_ms / 1e6:.1f} GB/s, plain version {a_plain_ms:.2f} "
        f"ms; bound {a_bound:.4f} ms by {a_by} ({a_bytes} B of lanes)")
    torch.cuda.empty_cache()

    # ---- 6. the device-resident inflate at full width ----
    flags = FLAG_ZLIB | FLAG_VERIFY_ADLER32
    dwall, (dec_l6, adler_l6) = phase_device_resident(
        dt, metrics, decode_cu, checksums_cu, streams, payloads, flags)
    log(f"[6] device_inflate(resolve='device', verify adler32): "
        f"{N_STREAMS} lanes OK and byte-equal, 0 host fallbacks, "
        f"{dec_l6} decode_stream and {adler_l6} adler32_batch launches, no "
        f"token fetched; bad trailers -> ERR and UNFINISHED; wall "
        f"{dwall:.3f} s = {raw / dwall / 1e9:.4f} GB/s (host-resolve route "
        f"in [3]: {wall:.3f} s)")
    torch.cuda.empty_cache()
    r_times, r_peak, r_base, tok_bytes = phase_resolve_alone(
        decode_cu, resolve, pack, streams, payloads)
    log(f"[6] resolve_tokens alone, {N_STREAMS} lanes x {BLOCK} B in slabs "
        f"of {resolve.SLAB_ELEMS // (BLOCK + 1)} lanes: {r_times} s; peak "
        f"device memory {r_peak} B, of which {r_base} B held before the "
        f"call (token rows {tok_bytes} B)")
    torch.cuda.empty_cache()

    # ---- 7. the streaming session ----
    for mode in ("host", "device"):
        decode_cu.launches = 0
        swall, feeds = phase_stream_session(dt, streams, payloads, mode)
        if decode_cu.launches <= 0:
            raise AssertionError("session never launched the decode kernel")
        log(f"[7] DeviceInflateSession(resolve='{mode}'): {SESSION_LANES} "
            f"lanes in {feeds} feeds OK and byte-equal, input_pos right, "
            f"EFULL -> resize_output -> resume OK, {decode_cu.launches} "
            f"decode_stream launches; wall {swall:.3f} s")

    # ---- 8. one huge stream, split and decoded on the card ----
    torch.cuda.empty_cache()
    (err_split, sp_ms, sp_plain_ms, sp_lanes, sp_valid, sp_steps,
     sp_comp) = phase_split_comparator(decode_cu, large, native,
                                       fetch_tokens, payloads)
    log(f"[8a] split decode, {SPLIT_RAW_BYTES} B raw in small blocks "
        f"({sp_comp} B), {SPLIT_SEGMENT} B segments, {sp_lanes} lanes over "
        f"one shared body: stream kernel == chunk loop by the comparator, "
        f"chunk kernel == twin slot for slot (max_abs_err {err_split}), "
        f"{sp_valid} lanes valid, stitched bytes equal; decode_tokens "
        f"{sp_ms:.3f} ms, the chunk loop over the twin {sp_plain_ms:.0f} ms "
        f"({sp_steps} steps of K={PLAIN_K} chunks)")
    larges = []
    for n_pay, stream in zip(LARGE_PAYLOADS, big):
        L = phase_large(dt, decode_cu, lane_rows, large_stages, stream,
                        flags, tail=n_pay == max(LARGE_PAYLOADS))
        larges.append(L)
        fc, sg, hd = L["first_call"], L["stages"], L["held"]
        stage = lambda d: ", ".join(
            f"{k[:-2]} {d[k]:.4f}" for k in ("find_s", "upload_s", "decode_s",
                                             "fetch_s", "stitch_s", "wall_s"))
        log(f"[8b] one stream of {n_pay} payloads: {L['raw']} B raw, "
            f"{L['comp']} B compressed (zlib level 6, made in "
            f"{L['made_s']:.1f} s): inflate_large(use_device=True, out=) OK, "
            f"byte-equal, adler32 verified, route device, {L['launches']} "
            f"launch, {fc['lanes_valid']} of {fc['lanes']} lanes valid, "
            f"tok_rows {fc['tok_rows']}; lanes {hd['lanes']} of that launch "
            f"(start bits {hd['start_bits']}, token rows {hd['rows']}) == "
            f"the chunk loop over the same body by the comparator, chunk "
            f"kernel == twin slot for slot on them (max_abs_err "
            f"{hd['err']}; the chunk loop took {hd['plain_ms']:.0f} ms, "
            f"{hd['plain_steps']} steps of K={PLAIN_K} chunks); "
            f"inflate_batch([stream], "
            f"backend='device') OK and byte-equal in {L['batch_wall_s']:.3f} "
            f"s; seconds, first call: {stage(fc)}; warm: {stage(sg)} = "
            f"{L['raw'] / sg['wall_s'] / 1e9:.4f} GB/s; the launch "
            f"{L['launch_ms']:.4f} ms, bound {L['bound'][0]:.4f} ms by "
            f"{L['bound'][1]} ({L['moved']} B moved, {sg['steps']} steps, "
            f"{sg['tokens']} tokens); host-parallel C++ engine "
            f"{L['host_parallel_s']:.4f} s, serial C++ engine "
            f"{L['serial_s']:.4f} s on the same buffer")
        torch.cuda.empty_cache()
    bs = phase_batch_split(dt, decode_cu, metrics, split, lane_rows)
    stage = lambda d: ", ".join(f"{k} {d[k]:.4f}" for k in (
        *SPLIT_SPANS, "wall"))
    hd = bs["held"]
    log(f"[8c] device_inflate of {bs['images']} Kodak-size PNGs "
        f"({bs['raw']} B raw, {bs['comp']} B of IDAT chunks), segment "
        f"target {bs['segment']} B: every stream OK and byte-equal, "
        f"{bs['launches']} launch of {bs['lanes']} lanes, "
        f"{bs['lanes_valid']} valid, {bs['fallbacks']} streams decoded in "
        f"part by the host, tok_rows {bs['tok_rows']}, T "
        f"{bs['T']}; the launch {bs['launch_ms']:.4f} ms; its "
        f"{bs['held_valid']} valid lanes == the chunk loop over the chunk "
        f"kernel by the comparator ({bs['valid_loop_ms']:.0f} ms), lanes "
        f"{hd['lanes']} (token rows {hd['rows']}) == the chunk loop over the "
        f"twin, chunk kernel == twin slot for slot on them ({hd['plain_ms']:.0f}"
        f" ms; max_abs_err {bs['err']}); seconds, first call: "
        f"{stage(bs['first_call'])}; warm (median of {BATCH_SPLIT_CALLS}): "
        f"{stage(bs['warm'])} = {bs['raw'] / bs['warm']['wall'] / 1e9:.4f} "
        f"GB/s; one lane a stream: {stage(bs['one_lane'])} = "
        f"{bs['raw'] / bs['one_lane']['wall'] / 1e9:.4f} GB/s")
    for seg, rec in bs["sweep"].items():
        log(f"[8c] sweep, segment target {seg} B: {rec['lanes']} lanes, "
            f"{rec['lanes_valid']} valid; {stage(rec)}")
    torch.cuda.empty_cache()

    # ---- 9. the hybrid encode ----
    d_rec, pk_ms, pk_loop_s, pk_shape, pk_used = phase_deflate(
        dt, native, hp, deflate_stages, payloads)
    for name in ("scan", "scatter"):
        d = d_rec[name][0]
        log(f"[9] device_deflate(pack='{name}'), {DEFLATE_STREAMS} x {BLOCK} "
            f"B, level 6: byte-identical to native_deflate_batch, zlib "
            f"decompresses every lane, no fallback; seconds: " + ", ".join(
                f"{k[:-2]} {d[k]:.4f}" for k in (
                    "fields_s", "upload_s", "pack_s", "fetch_s",
                    "assemble_s", "wall_s")))
    log(f"[9] native_deflate_batch on the same payloads "
        f"{d_rec['host'][0]['wall_s']:.4f} s ({d_rec['bytes_in']} B -> "
        f"{d_rec['bytes_out']} B); pack_fields_scan (closed form) == the "
        f"reservoir loop exactly on fields {list(pk_shape)}: {pk_ms:.3f} ms "
        f"against {pk_loop_s:.1f} s of the loop's {pk_used} eager steps (the "
        f"steps that hold a field; the slots past them are zero)")

    # ---- 10. the sharded decode ----
    torch.cuda.empty_cache()
    sharded = phase_sharded(decode_cu, metrics, streams, payloads, raw)

    # ---- 11. malformed lanes among the corpus's ----
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    mixed, bad = corpus.mixed_batch(streams, payloads, MIXED_SEED)
    mx = phase_mixed_launch(decode_cu, ib, pack, native, mixed, bad, streams,
                            payloads)
    log(f"[11a] the batch with every 8th lane malformed ({len(bad)} lanes: "
        f"truncated, bit-flipped, garbage, garbage after a zlib header; seed "
        f"{MIXED_SEED}), one launch: the {N_STREAMS - len(bad)} corpus lanes "
        f"end where they end in the clean launch (status, dst_pos, bitpos) "
        f"and are their payloads ({mx['corpus_lanes_moved']} moved, "
        f"{mx['corpus_lanes_wrong']} wrong); the {len(bad)} malformed lanes "
        f"== the chunk loop by the comparator (max_abs_err "
        f"{mx['max_abs_err']}; {mx['plain_ms']:.0f} ms, {mx['plain_steps']} "
        f"steps), device classes {mx['device_classes']}; launch "
        f"{mx['ms']:.4f} ms mixed against {mx['clean_ms']:.4f} ms clean "
        f"(medians of {MIXED_ROUNDS} rounds in turns: {mx['times']}; [2c] "
        f"{s_ms:.4f} ms)")
    mal = malformed.run(N_STREAMS, BLOCK, MIXED_SEED, "cuda",
                          batch=(payloads, streams))
    if not mal["ok"]:
        raise AssertionError(f"[11b] malformed lanes: {json.dumps(mal)}")
    for resolve in ("host", "device"):
        r = mal[f"resolve_{resolve}"]
        log(f"[11b] device_inflate(resolve='{resolve}'"
            f"{', verify adler32' if resolve == 'device' else ''}) of the "
            f"mixed batch: every lane its oracle class and an OK lane its "
            f"bytes ({r['n_differ']} lanes differ), corpus lanes' end state "
            f"the clean batch's ({len(r['corpus_lanes_moved'])} moved), "
            f"{r['host_fallbacks']} host fallbacks; classes {r['classes']}; "
            f"launches {r['launches']}; wall {r['wall_s']:.3f} s")
    lg = mal["large"]
    log(f"[11b] the 64 MiB stream with {lg['flips']} bit flips and a cut "
        f"tail ({lg['bytes']} B): inflate_large(use_device=True) class "
        f"{lg['class']}, the host-parallel engine's "
        f"{lg['host_parallel_class']}; route {lg['route']}, {lg['launches']} "
        f"launch, {lg['lanes_valid']} of {lg['lanes']} lanes valid")
    san = phase_sanitizer()
    log(f"[11] malformed input took {time.perf_counter() - t_phase:.1f} s")

    # ---- 12. the bench, whole, in a process of its own ----
    del mixed
    torch.cuda.empty_cache()
    b_line, b_log, b_launches, b_secs = phase_bench(s_stats["tok_rows"])
    no_checked_launches(decode_cu, checksums_cu, "[3]-[11]")
    for ln in b_log:
        log(f"[12]   {ln}")
    log(f"[12] {json.dumps(b_line)}")
    log(f"[12] python -m defl_tpu_torch.bench: no error, "
        f"{', '.join(BENCH_OK_KEYS)} true, device the card's, the 64 MiB "
        f"stream on the device route ({b_line['large64_device_lanes_valid']}"
        f" of {b_line['large64_device_lanes']} lanes valid), "
        f"dist_overhead_pct {b_line['dist_overhead_pct']} at the bench's "
        f"size, {b_launches} decode_stream launches and no checked one in "
        f"its process, token fetch "
        f"{b_line['pipeline_fetch_bytes_per_batch']} B a batch; value "
        f"{b_line['value']} GB/s; wall {b_secs:.1f} s")

    # ---- 13. the kernels' checked build ----
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    mixed, _ = corpus.mixed_batch(streams, payloads, MIXED_SEED)
    ck13 = phase_checked(dt, decode_cu, checksums_cu, ib, pack, malformed,
                         streams, payloads, mixed, big[0], flags)
    del mixed
    n_in, n_caught, n_launch = (ck13["inputs"], ck13["caught"],
                                ck13["launches"])
    ms13 = ck13["ms"]
    log(f"[13] checked build (csrc/checked.cuh: every device- and "
        f"shared-memory access checked against its extent, shared memory "
        f"also against a shadow of what the launch wrote): 0 faults over "
        f"{n_in['batch']} batch-mode inputs of the stream kernel (the bench "
        f"batch clean and mixed, fuzz seeds {list(CHECKED_FUZZ_SEEDS)}, the "
        f"C4/C5 cut streams, [2a]'s matrix with its EFULL resume, its "
        f"dictionary stream), {n_in['shared_input']} in shared-input mode "
        f"(the 64 MiB stream's split-decode launch, clean and with "
        f"{malformed.FLIPS} bit flips and a cut tail), {n_in['chunk']} of "
        f"the chunk kernel ([2b]'s N={N_STREAMS}, K={CHUNK_K} chunk) and "
        f"{n_in['adler32']} of adler32 ([{N_STREAMS}, {BLOCK}], and lengths "
        f"-1, 0, C, C+1 over rows 3 bytes off a 16-byte boundary); every "
        f"checked launch == the unchecked one bit for bit (tokens, carry, "
        f"totals); checked launches {n_launch}")
    log(f"[13] injected accesses caught, each with its own site and lane in "
        f"the middle slot of a block: stream kernel {n_caught['batch']} of "
        f"{len(STREAM_SITES)} in batch mode and {n_caught['shared_input']} "
        f"in shared-input mode ({', '.join(STREAM_SITES)}), chunk kernel "
        f"{n_caught['chunk']} of {len(CHUNK_SITES)} "
        f"({', '.join(CHUNK_SITES)}), adler32 {n_caught['adler32']} of 1")
    log(f"[13] ms, checked against unchecked, medians of launches in turns: "
        f"stream kernel at {N_STREAMS} x {BLOCK} B {ms13['clean'][0]:.4f} "
        f"against {ms13['clean'][1]:.4f} (mixed batch {ms13['mixed'][0]:.4f} "
        f"against {ms13['mixed'][1]:.4f}); chunk kernel "
        f"{ms13['chunk'][0]:.4f} against {ms13['chunk'][1]:.4f}; adler32 "
        f"{ms13['adler32'][0]:.4f} against {ms13['adler32'][1]:.4f}; all "
        f"times {json.dumps(ck13['times'])}")
    for build_name, rec in ck13["ptxas"].items():
        log(f"[13] ptxas, {build_name} build: {json.dumps(rec)}")
    log(f"[13] card: {smi}; the checked build took "
        f"{time.perf_counter() - t_phase:.1f} s")

    # ---- 14. the block finder ----
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    silesia = silesia_stream(FIND_SILESIA_SEED)
    fd = phase_find(dt, find_cu, native, build, metrics, silesia)
    del silesia
    log_find(fd)
    log(f"[14] the block finder took {time.perf_counter() - t_phase:.1f} s")

    # decode_stream: the whole-batch launch of [2c]; plain_ms is the chunk
    # loop's time for plain_lanes of its lanes (the twin's time hardly
    # depends on the lane count).  The chunk kernel of [2b] shares the
    # source and the step; it is off the main path and stands in the log.
    kernels = [{
        "name": "decode_stream", "route": "cuda",
        "source": "defl_tpu_torch/csrc/decode_stream.cu",
        "replaces": "defl_tpu/ops/pallas/decode_pl.py:663",
        "launches": launches,
        "max_abs_err": max(err_small, err_big, err_all, err_split, bs["err"],
                           *(L["held"]["err"] for L in larges)),
        "ms": s_ms, "plain_ms": s_plain_ms, "plain_lanes": s_lanes,
        "bound_ms": s_bound, "bound_by": s_by, "library_ms": None,
        "tok_rows": s_stats["tok_rows"], "chunk_kernel_ms": ms,
        "chunk_twin_ms": plain_ms,
        # the split decode of [8]: launches of the 64 MiB stream's run of
        # inflate_large, its launch beside its bound; kernel and plain
        # version on the same inputs in [8a], and on held_lanes of each big
        # stream's own launch in [8b] (held_plain_ms: the chunk loop's time
        # for each stream's held lanes)
        "shared_input": {
            "launches": larges[0]["launches"],
            "max_abs_err": max(err_split, bs["err"],
                               *(L["held"]["err"] for L in larges)),
            "ms": larges[0]["launch_ms"],
            "held_lanes": [len(L["held"]["lanes"]) for L in larges],
            "held_plain_ms": [L["held"]["plain_ms"] for L in larges],
            "bound_ms": larges[0]["bound"][0],
            "bound_by": larges[0]["bound"][1],
            "lanes": larges[0]["stages"]["lanes"],
            "small_ms": sp_ms, "small_plain_ms": sp_plain_ms,
            # [8c]: a batch of long streams split in one launch
            "batch_split": {k: bs[k] for k in (
                "launches", "lanes", "lanes_valid", "launch_ms",
                "held_valid", "err", "segment")}},
        # the sharded decode of [10]: launches of each part, one per shard
        "sharded": sharded,
        # [11]: the mixed batch's launch beside the clean one, its malformed
        # lanes against the chunk loop, the resolvers' classes, the mutated
        # large stream; and compute-sanitizer's runs (None: tool absent)
        "malformed": {**{k: mx[k] for k in (
            "ms", "clean_ms", "malformed_lanes", "device_classes",
            "corpus_lanes_moved", "corpus_lanes_wrong", "max_abs_err",
            "plain_ms")},
            "classes": {r: mal[f"resolve_{r}"]["classes"]
                        for r in ("host", "device")},
            "lanes_differ": sum(mal[f"resolve_{r}"]["n_differ"]
                                for r in ("host", "device")),
            "large": lg},
        "sanitizer": san,
        # [12]: launches in the bench's own process (its main path: the
        # decode, the pipelines, the split decode)
        "bench_launches": b_launches,
        # [13]: the checked build; faults: the fault records' counts over
        # [13]'s inputs (any fault fails the run); ms: the checked launch
        # at [2c]'s shape, unchecked_ms beside it
        "checked": {
            "launches": n_launch["decode_stream"],
            "faults": ck13["faults"]["decode_stream"],
            "inputs": n_in["batch"] + n_in["shared_input"],
            "injections_caught": n_caught["batch"] + n_caught["shared_input"],
            "ms": ms13["clean"][0], "unchecked_ms": ms13["clean"][1],
            "ptxas": {k: v["decode_stream_kernel"]
                      for k, v in ck13["ptxas"].items()},
            "shared_input": {"inputs": n_in["shared_input"],
                             "injections_caught": n_caught["shared_input"]},
            "chunk": {"launches": n_launch["decode_chunk"],
                      "faults": ck13["faults"]["decode_chunk"],
                      "inputs": n_in["chunk"],
                      "injections_caught": n_caught["chunk"],
                      "ms": ms13["chunk"][0],
                      "unchecked_ms": ms13["chunk"][1],
                      "ptxas": {k: v["decode_chunk_kernel"]
                                for k, v in ck13["ptxas"].items()}}}}, {
        "name": "adler32_batch", "route": "cuda",
        "source": "defl_tpu_torch/csrc/adler32_batch.cu",
        "replaces": "defl_tpu/ops/pallas/checksums_pl.py:53",
        "launches": adler_l6, "max_abs_err": max(err_a_small, err_a_full),
        "ms": a_ms, "plain_ms": a_plain_ms, "bound_ms": a_bound,
        "bound_by": a_by, "library_ms": None,
        "malformed_launches": mal["resolve_device"]["launches"][
            "adler32_batch"],
        "sanitizer": san,
        "checked": {
            "launches": n_launch["adler32_batch"],
            "faults": ck13["faults"]["adler32_batch"],
            "inputs": n_in["adler32"],
            "injections_caught": n_caught["adler32"],
            "ms": ms13["adler32"][0], "unchecked_ms": ms13["adler32"][1],
            "ptxas": {k: v["adler32_batch_kernel"]
                      for k, v in ck13["ptxas"].items()}}}, {
        "name": "find_starts", "route": "cuda",
        "source": "defl_tpu_torch/csrc/find_starts.cu",
        "replaces": None,
        # [14]: launches on the main path (the routes', each counted from
        # its call); max_abs_err: the kernel's bits against the native
        # finder's over each shape; each shape's kernel, bound, native
        # finder and plain version; the checked build's faults over the
        # shapes, before the injection
        "launches": sum(r["launches"] for r in fd["routes"].values()),
        "max_abs_err": max(fd[k]["max_abs_err"]
                           for k in ("fuzz", "kodak32", "silesia")),
        "library_ms": None,
        **{k: fd[k] for k in ("fuzz", "kodak32", "silesia", "routes")},
        "checked": {"launches": fd["checked_launches"],
                    "faults": fd["faults"], "injection": fd["injection"],
                    "ptxas": fd["ptxas"]}}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
