"""Smoke run of defl_tpu_torch on one CUDA card: the batched inflate main
path, the device-resident inflate, the streaming session, the split decode
of one huge stream, the hybrid encode, the sharded decode, and malformed
input among good streams.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. device: the card's name and power limit, torch/CUDA versions, and
     the builds from csrc/, started together: nvcc for the kernels
     (decode_stream.cu, adler32_batch.cu), g++ for the host engine
     (defl_host.cc);
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
     and serial C++ engines on the same buffer;
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
     so and records "sanitizer": null.
Each kernel's count of launches is set to 0 just before the path that
uses it and read just after.  The line before the last holds the card's
name and power limit, the one before it the kernels' JSON record; the
last line is the result JSON.  Without CUDA it fails at once and prints
no result.  It imports torch, numpy and defl_tpu_torch only.
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


def phase_small_matrix(decode_cu, ib, pack, native):
    """(a): full decodes through kernel and twin, bytes checked."""
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
    caps[2] = 1000            # EFULL, resumed below with a grown cap
    p = pack.pack_streams(streams, zflag, caps)
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
        cap = torch.full((len(streams),), 8192, dtype=torch.int32,
                         device="cuda")
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

    # a preset-dictionary stream
    d = b"a shared preset dictionary: hello world, the quick brown fox " * 4
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_DEFAULT_STRATEGY,
                          zdict=d)
    dp = b"hello world, the quick brown fox jumps " * 30
    pd = pack.pack_streams([co.compress(dp) + co.flush()], 1, 4096)
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


def phase_big_chunk(decode_cu, ib, packed):
    """(b): one N=8192, K=512 chunk from a mid-decode carry."""
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


def held_split_lanes(decode_cu, lane_rows, call, tail):
    """Lanes of a split decode's launch, as ``inflate_large`` made it,
    against the plain version at the same shape: ``call`` holds that
    launch's arguments and what it returned.  The lanes' arguments are
    indexed and the body stays the one on the card, so the cursors, limits
    and word offsets are the launch's own."""
    (words, nbits, zflag, cap), kw, (tok, carry) = call
    M = int(nbits.shape[0])
    used = lane_rows(tok, carry["tok_rows"]).cpu().numpy()
    pick = np.argsort(used, kind="stable")[:SPLIT_HELD]
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
    from defl_tpu_torch.ops.cuda import build, checksums_cu, decode_cu
    from defl_tpu_torch.runtime import large, native, pack
    from defl_tpu_torch.runtime.session import fetch_tokens

    # ---- 1. device, and the three builds started together ----
    smi = nvidia_smi()
    log(f"[1] card: {smi}")
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:
        host_build = ex.submit(native.load)
        build.load()
        host_build.result()
    log(f"[1] builds: nvcc (decode_stream.cu, adler32_batch.cu) "
        f"{build.build_seconds:.2f} s, g++ (defl_host.cc) "
        f"{native.build_seconds:.2f} s, together "
        f"{time.perf_counter() - t0:.2f} s; {build.lib_path()}, "
        f"{native.lib_path()}")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[1]   ptxas: {line.strip()}")

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
    fetched = m1["token_fetch_bytes"] - m0.get("token_fetch_bytes", 0)
    log(f"[3] inflate_batch: {N_STREAMS} lanes OK and byte-equal, "
        f"0 host fallbacks, {launches} decode_stream launches, "
        f"{fetched} token bytes fetched; wall {wall:.3f} s = "
        f"{raw / wall / 1e9:.4f} GB/s")
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

    # decode_stream: the whole-batch launch of [2c]; plain_ms is the chunk
    # loop's time for plain_lanes of its lanes (the twin's time hardly
    # depends on the lane count).  The chunk kernel of [2b] shares the
    # source and the step; it is off the main path and stands in the log.
    kernels = [{
        "name": "decode_stream", "route": "cuda",
        "source": "defl_tpu_torch/csrc/decode_stream.cu",
        "replaces": "defl_tpu/ops/pallas/decode_pl.py:663",
        "launches": launches,
        "max_abs_err": max(err_small, err_big, err_all, err_split,
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
            "max_abs_err": max(err_split,
                               *(L["held"]["err"] for L in larges)),
            "ms": larges[0]["launch_ms"],
            "held_lanes": [len(L["held"]["lanes"]) for L in larges],
            "held_plain_ms": [L["held"]["plain_ms"] for L in larges],
            "bound_ms": larges[0]["bound"][0],
            "bound_by": larges[0]["bound"][1],
            "lanes": larges[0]["stages"]["lanes"],
            "small_ms": sp_ms, "small_plain_ms": sp_plain_ms},
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
        "sanitizer": san}, {
        "name": "adler32_batch", "route": "cuda",
        "source": "defl_tpu_torch/csrc/adler32_batch.cu",
        "replaces": "defl_tpu/ops/pallas/checksums_pl.py:53",
        "launches": adler_l6, "max_abs_err": max(err_a_small, err_a_full),
        "ms": a_ms, "plain_ms": a_plain_ms, "bound_ms": a_bound,
        "bound_by": a_by, "library_ms": None,
        "malformed_launches": mal["resolve_device"]["launches"][
            "adler32_batch"],
        "sanitizer": san}]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
