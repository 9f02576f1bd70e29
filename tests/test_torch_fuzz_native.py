"""The port's C++ tier under malformed input, against ``defl_tpu``'s.

Counterpart of the second half of tests/test_fuzz.py: the entry points
that start at arbitrary bit offsets or trust arrays they are handed
(``find_block_start``, ``inflate_span``, ``resolve_tokens_into`` and
``native_resolve_tokens`` with adversarial token words, ``stitch`` with
corrupted lane metadata, ``inflate_large_parallel``) over mutated,
truncated and garbage bodies.  The port builds its own copy of the host
engine (``defl_tpu_torch/csrc/defl_host.cc``) and binds it itself, so each
call goes to both packages with the same input, and both must return the
same values and leave the same output buffer.  The bodies and offsets are
``tests.test_fuzz``'s own (``_mutated_bodies``, ``random.Random`` seeds),
so both files see the same streams.  A codec is exact: every comparison
is equality.
"""

import random
import zlib

import numpy as np
import pytest

from defl_tpu.runtime import native as jnative
from defl_tpu_torch.errors import Result
from defl_tpu_torch.runtime import native as tnative
from tests.test_fuzz import CORPUS, _mutated_bodies

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="the JAX package's native library is "
                                "unavailable")

_CLASSES = (Result.OK, Result.ERR, Result.UNFINISHED, Result.EFULL)


@pytest.fixture(scope="module")
def libs():
    return jnative.get_lib(), tnative.get_lib()


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_find_block_start_matches(libs, seed):
    jlib, tlib = libs
    rng = random.Random(seed)
    for body in _mutated_bodies(seed, 10):
        nbits = 8 * body.size
        for _ in range(8):
            lo = rng.randrange(0, max(1, nbits))
            hi = lo + rng.randrange(0, nbits + 256)
            r = tnative.find_block_start(tlib, body, lo, hi)
            assert r == jnative.find_block_start(jlib, body, lo, hi)
            assert r == -1 or lo <= r < nbits


@pytest.mark.parametrize("seed", [31, 32, 33])
def test_inflate_span_matches(libs, seed):
    """Random start and limit bits, a random window already in the output
    (the bytes a back-reference may reach): the same result, output
    position, end bit, and every byte of the buffer."""
    jlib, tlib = libs
    rng = random.Random(seed)
    cap = 1 << 16
    for body in _mutated_bodies(seed, 10):
        nbits = 8 * body.size
        for _ in range(8):
            start = rng.randrange(0, max(1, nbits))
            limit = start + rng.randrange(0, nbits)
            pos = rng.randrange(0, 64)
            window = np.frombuffer(rng.randbytes(cap), np.uint8)
            outs = [window.copy(), window.copy()]
            got = tnative.inflate_span(tlib, body, start, limit, outs[0], pos)
            want = jnative.inflate_span(jlib, body, start, limit, outs[1], pos)
            assert (int(got[0]), *got[1:]) == (int(want[0]), *want[1:])
            assert got[0] in _CLASSES and 0 <= got[1] <= cap
            assert np.array_equal(outs[0], outs[1])


@pytest.mark.parametrize("seed", [41, 42, 43])
def test_resolve_adversarial_tokens_matches(seed):
    """Random u32 token words: lying length fields, stored-run offsets far
    past the input row, distances before the window, lying dst_len and
    dst_start.  Both resolvers keep them inside the lane row, byte for
    byte alike."""
    rng = np.random.default_rng(seed)
    N, T, C = 16, 256, 2048
    tokens = rng.integers(0, 1 << 32, (N, T), dtype=np.uint64) \
        .astype(np.uint32)
    inputs = rng.integers(0, 1 << 32, (N, 64), dtype=np.uint64) \
        .astype(np.uint32)
    dst_len = rng.integers(-5, 4 * C, N).astype(np.int32)
    got = tnative.native_resolve_tokens(tokens, inputs, dst_len, C)
    want = jnative.native_resolve_tokens(tokens, inputs, dst_len, C)
    assert got.shape == (N, C) and np.array_equal(got, want)
    dst_start = rng.integers(-10, 2 * C, N).astype(np.int32)
    tnative.native_resolve_tokens(tokens, inputs, dst_len, C, out=got,
                                  dst_start=dst_start)
    jnative.native_resolve_tokens(tokens, inputs, dst_len, C, out=want,
                                  dst_start=dst_start)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", [44, 45])
def test_resolve_tokens_into_adversarial_tokens_matches(libs, seed):
    """One lane at a time, as the stitch chains segments: adversarial
    tokens into out[start:end) over a window of random bytes."""
    jlib, tlib = libs
    rng = np.random.default_rng(seed)
    size = 4096
    for _ in range(12):
        toks = rng.integers(0, 1 << 32, int(rng.integers(1, 300)),
                            dtype=np.uint64).astype(np.uint32)
        lane_input = rng.integers(0, 256, int(rng.integers(1, 600)),
                                  dtype=np.uint8)
        start = int(rng.integers(0, size))
        end = int(rng.integers(start, size + 1))
        window = rng.integers(0, 256, size, dtype=np.uint8)
        outs = [window.copy(), window.copy()]
        tnative.resolve_tokens_into(tlib, toks, lane_input, outs[0], start,
                                    end)
        jnative.resolve_tokens_into(jlib, toks, lane_input, outs[1], start,
                                    end)
        assert np.array_equal(outs[0], outs[1])
    with pytest.raises(ValueError):
        tnative.resolve_tokens_into(tlib, toks, lane_input, outs[0], 10, 5)


def _candidates(lib, body, py_rng):
    """A semi-plausible chain: the real block starts the finder sees every
    ~1000 bits, and a few junk offsets."""
    nbits = 8 * body.size
    cands, pos = [0], 0
    while True:
        nxt = tnative.find_block_start(lib, body, pos + 999, nbits)
        if nxt < 0:
            break
        cands.append(nxt)
        pos = nxt
    for _ in range(3):
        cands.append(py_rng.randrange(1, nbits))
    return sorted(set(cands))


def _corrupt_lanes(body, cands, rng, py_rng, T):
    """Untrusted lane metadata and garbage tokens for the chain ``cands``,
    half its seams made to validate."""
    nbits = 8 * body.size
    M = len(cands)
    toks = rng.integers(0, 1 << 32, (M, T), dtype=np.uint64).astype(np.uint32)
    dst_pos = rng.integers(-3, 1 << 20, M).astype(np.int32)
    status = rng.integers(-2, 3, M).astype(np.int32)
    final = rng.integers(0, 2, M).astype(np.int32)
    bit_end = rng.integers(-100, nbits + 100, M).astype(np.int64)
    for k in range(M - 1):
        if py_rng.random() < 0.5:
            bit_end[k] = cands[k + 1]
            status[k] = 0
    return toks, dst_pos, status, final, bit_end


@pytest.mark.parametrize("seed", [51, 52, 53])
def test_stitch_corrupt_lane_metadata_matches(libs, seed):
    """dt_stitch walks untrusted status, bit_end, dst_pos and final arrays
    and garbage tokens; some seams are made to validate so that the lane
    resolve runs on them.  Both packages return the same (result, total,
    end bit) and the same buffer; with no lanes (all span decodes) too.
    Then the port's dt_stitch_many on 8 threads, one chain of small blocks
    (many lanes, so that the two passes take it), against its dt_stitch:
    the same (result, total, end bit) and bytes, every byte of the buffer
    where the chain went back to the walk."""
    jlib, tlib = libs
    rng = np.random.default_rng(seed)
    py_rng = random.Random(seed)
    payload = (CORPUS["text"] + CORPUS["json"]) * 8
    body = np.frombuffer(zlib.compress(payload, 6)[2:], np.uint8)
    cands = _candidates(tlib, body, py_rng)
    info = _corrupt_lanes(body, cands, rng, py_rng, 128)
    for lane_info in (info, None):
        outs = [np.zeros(len(payload) + (1 << 16), np.uint8) for _ in range(2)]
        got = tnative.stitch(tlib, body, cands, lane_info, outs[0])
        want = jnative.stitch(jlib, body, cands, lane_info, outs[1])
        assert (int(got[0]), *got[1:]) == (int(want[0]), *want[1:])
        assert got[0] in _CLASSES and 0 <= got[1] <= outs[0].size
        assert np.array_equal(outs[0], outs[1])

    co = zlib.compressobj(6, zlib.DEFLATED, -15, 2)
    body = np.frombuffer(co.compress(payload) + co.flush(), np.uint8)
    cands = _candidates(tlib, body, py_rng)
    assert len(cands) >= 16
    info = _corrupt_lanes(body, cands, rng, py_rng, 128)
    modes = set()
    for lane_info in (info, (*info[:2], np.ones(len(cands), np.int32),
                             *info[3:])):
        outs = [np.zeros(len(payload) + (1 << 16), np.uint8) for _ in range(2)]
        want = tnative.stitch(tlib, body, cands, lane_info, outs[1])
        rs, totals, ends, mode = tnative.stitch_many(
            tlib, body, [0], [body.size], [0], [len(cands)], cands,
            lane_info, [outs[0]], n_threads=8)
        assert (rs[0], int(totals[0]), int(ends[0])) == want
        total = want[1]
        assert np.array_equal(outs[0][:total], outs[1][:total])
        if mode[0] == tnative.STITCH_PARALLEL:
            assert not outs[0][total:].any()
        else:
            assert np.array_equal(outs[0], outs[1])
        modes.add(int(mode[0]))
    # garbage tokens give the chain back to the walk; no lanes at all (each
    # gap decoded to tokens) is the two passes' own
    assert tnative.STITCH_PARALLEL in modes


@pytest.mark.parametrize("seed", [61, 62, 63])
def test_inflate_large_parallel_matches(libs, seed):
    """dt_inflate_large over mutated, truncated and garbage bodies at
    several segment sizes and thread counts: the same result, total and
    end bit as the JAX package's binding, the same bytes, and the serial
    engine's bytes whenever that accepts the body."""
    jlib, tlib = libs
    rng = random.Random(seed)
    for body in _mutated_bodies(seed, 8):
        cap = 64 * body.size + 4096
        segb = rng.choice([4096, 16384, 65536])
        threads = rng.choice([1, 3])
        res = []
        for mod, lib in ((tnative, tlib), (jnative, jlib)):
            out = np.zeros(cap, np.uint8)
            r, total, end_bit, st = mod.inflate_large_parallel(
                lib, body, out, seg_bytes=segb, n_threads=threads)
            mod.large_free(lib, st)
            res.append((int(r), total, end_bit, out[:total].tobytes()))
        assert res[0] == res[1]
        r, total = res[0][:2]
        assert Result(r) in _CLASSES and 0 <= total <= cap
        rs, serial = tnative.native_inflate(body.tobytes(), cap, flags=0)
        if rs is Result.OK:
            assert r == int(Result.OK) and res[0][3] == serial


def test_stitch_unsorted_candidates_rejected(libs):
    jlib, tlib = libs
    body = np.frombuffer(zlib.compress(b"x" * 1000, 6)[2:], np.uint8)
    for mod, lib in ((tnative, tlib), (jnative, jlib)):
        r, total, _ = mod.stitch(lib, body, [40, 10], None,
                                 np.zeros(4096, np.uint8))
        assert r == Result.ERR and total == 0
