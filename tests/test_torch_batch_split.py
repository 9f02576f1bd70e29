"""The split decode of a batch's long streams (``runtime/split.py``, taken
by ``session.device_inflate(resolve="host")``) on the CPU, where the decode
kernel's plain version runs its lanes.

Streams have small blocks (zlib ``memLevel`` 4 ends a block every 1023
symbols) and the segment target is set small inside the test, as
tests/test_torch_large.py does for one huge stream: a lane then takes
hundreds of steps of the eager twin.  Every comparison is exact: against
``zlib``, against ``defl_tpu.api.inflate_batch`` (its host route, the
oracle) for malformed streams, and against the port's own one-lane route
for the stats it reports.
"""

import os
import random
import zlib

import numpy as np
import pytest

import defl_tpu.api as japi
from defl_tpu.runtime import native as jnative
from defl_tpu_torch import metrics
from defl_tpu_torch.api import inflate_batch
from defl_tpu_torch.corpus import make_silesia_like
from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
from defl_tpu_torch.ops import inflate_batch as ib
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.runtime import large as tlarge
from defl_tpu_torch.runtime import native as tnative
from defl_tpu_torch.runtime import pack as tpack
from defl_tpu_torch.runtime import session as tsess
from defl_tpu_torch.runtime import split

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="native library unavailable")

SEG = 1024
COUNTERS = ("batch_split_streams", "batch_split_lanes",
            "batch_split_lanes_valid", "host_fallback_lanes")


def _small_blocks(raw: bytes, wbits: int = 15) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, wbits, 4)
    return co.compress(raw) + co.flush()


@pytest.fixture(scope="module")
def raws():
    text = b"".join(make_silesia_like(65536, 65536))
    return [text[:12000], text[30000:44000]]


@pytest.fixture(scope="module")
def comps(raws):
    return [_small_blocks(r) for r in raws]


@pytest.fixture(scope="module")
def rows():
    """A stream of high ratio (about 50): its first lane alone puts out
    more than a window, so the stitch takes every lane's tokens."""
    raw = b"".join(b"row %06d " % i + b"payload " * 16 + b"\n"
                   for i in range(3000))
    return raw, _small_blocks(raw)


@pytest.fixture
def small_segments(monkeypatch):
    monkeypatch.setattr(split, "SEGMENT_BYTES", SEG)


def _inflate(streams, flags=FLAG_ZLIB, caps=None):
    """device_inflate on the CPU, with the split counters it moved."""
    m0 = metrics.snapshot()
    r, o, st = tsess.device_inflate(streams, flags, dst_capacities=caps,
                                    device="cpu")
    m1 = metrics.snapshot()
    moved = {k: m1.get(k, 0) - m0.get(k, 0) for k in COUNTERS}
    return r, o, st, moved


def _chunked(data: bytes, size: int):
    view = memoryview(data)
    return [view[i:i + size] for i in range(0, len(data), size)]


def _one_lane(streams, flags=FLAG_ZLIB, caps=None):
    """The port's route with no stream split: one lane a stream."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(split, "SEGMENT_BYTES", 1 << 30)
        return tsess.device_inflate(streams, flags, dst_capacities=caps,
                                    device="cpu")


def test_long_streams_as_bytes_and_chunk_lists_equal_zlib(
        raws, comps, small_segments):
    streams = [comps[0], _chunked(comps[1], 700)]
    assert all(len(c) - 2 >= 3 * SEG for c in comps)
    r, o, st, moved = _inflate(streams)
    assert r == [Result.OK, Result.OK]
    assert o == raws == [zlib.decompress(c) for c in comps]
    assert moved["batch_split_streams"] == 2
    assert moved["batch_split_lanes"] == st["split_lanes"] >= 4
    assert moved["batch_split_lanes_valid"] == st["split_lanes_valid"] \
        == st["split_lanes"]
    # each stream's first lanes put out less than a window, so the stitch
    # decodes them serially (large.head_guard): the host decoded part of
    # both streams, and says so
    assert st["host_fallbacks"] == [0, 1] == list(range(
        moved["host_fallback_lanes"]))
    assert st["adler32_batch_launches"] == 0
    # the stats mean what the one-lane route's mean
    _, o1, st1 = _one_lane(streams)
    assert o1 == o
    for key in ("status", "dst_pos", "bitpos"):
        assert st[key].tolist() == st1[key].tolist(), key
    # the same through the public entry, and nothing kept between calls
    assert inflate_batch(streams, backend="device", device="cpu") == (r, o)


def test_lanes_after_a_window_resolve_from_their_tokens(rows,
                                                       small_segments):
    raw, comp = rows
    r, o, st, moved = _inflate([comp, _chunked(comp, 999)])
    assert r == [Result.OK, Result.OK] and o == [raw, raw]
    assert st["split_lanes"] == st["split_lanes_valid"] >= 8
    assert st["host_fallbacks"] == [] and moved["host_fallback_lanes"] == 0


def test_the_head_guard_marks_the_lanes_before_a_whole_window():
    W = tlarge.WINDOW
    cands = [0, 100, 200, 300, 400]
    toks = np.zeros((5, 4), np.uint32)
    final = np.array([0, 0, 0, 0, 1], np.int32)
    bit_end = np.array([100, 200, 300, 400, 500], np.int64)

    # a body that does not decode: where the chain of validated lanes
    # breaks before a window, every lane after the head is marked
    body = np.zeros(64, np.uint8)

    def marked(dst_pos, status=(0,) * 5, head=0):
        info = (toks, np.array(dst_pos, np.int32),
                np.array(status, np.int32), final, bit_end)
        got = tlarge.head_guard([head] + cands[1:], info, body)
        assert got[0] is toks and got[3] is final and got[4] is bit_end
        return np.flatnonzero((info[2] == 0) & (got[2] != 0)).tolist()

    assert marked([W, 5, 5, 5, 5]) == []
    assert marked([W - 1, 1, 5, 5, 5]) == [1]
    assert marked([9000, 9000, 9000, 9000, 9000]) == [1, 2, 3]
    assert marked([9000, 9000, 9000, 9000, 9000], head=50) == []
    # a lane that does not validate ends the chain of outputs that counts
    assert marked([9000, 9000, 9000, 9000, 9000],
                  status=(0, 2, 0, 0, 0)) == [2, 3, 4]
    assert marked([100] * 5) == [1, 2, 3, 4]
    one = (toks[:1], np.array([1], np.int32), np.array([0], np.int32),
           final[:1], bit_end[:1])
    assert tlarge.head_guard([0], one, body) is one


def test_raw_deflate_streams_are_split_too(raws, small_segments):
    bodies = [_small_blocks(r, wbits=-15) for r in raws]
    r, o, st, moved = _inflate(bodies, flags=0)
    assert r == [Result.OK, Result.OK] and o == raws
    assert moved["batch_split_streams"] == 2


def test_a_declared_capacity_filled_exactly_is_ok_and_one_short_is_efull(
        raws, comps, small_segments):
    exact = [len(x) for x in raws]
    r, o, _, moved = _inflate(comps, caps=exact)
    assert r == [Result.OK, Result.OK] and o == raws
    assert moved["batch_split_streams"] == 2
    short = [n - 1 for n in exact]
    r, o, st, _ = _inflate(comps, caps=short)
    assert r == [Result.EFULL, Result.EFULL]
    assert all(x.startswith(y) and len(y) <= n
               for x, y, n in zip(raws, o, short))
    # filled as far as the one-lane route fills it (up to the last token
    # that fits)
    _, o1, st1 = _one_lane(comps, caps=short)
    assert o1 == o and st["dst_pos"].tolist() == st1["dst_pos"].tolist()


def test_an_undeclared_capacity_grows(small_segments):
    raw = b"".join(bytes([i % 7]) * (300 + 50 * (i % 3)) for i in range(4000))
    comp = _small_blocks(raw)
    assert len(comp) - 2 >= 3 * SEG
    assert 64 * len(comp) < len(raw)      # past the first guess
    r, o, st, moved = _inflate([comp])
    assert r == [Result.OK] and o == [raw]
    assert moved["batch_split_streams"] == 1
    assert st["C"] >= len(raw)


def test_a_mixed_batch_of_long_and_short_streams(raws, comps,
                                                 small_segments):
    short = [zlib.compress(b"hello " * 40), zlib.compress(bytes(range(256))),
             zlib.compress(raws[0][:1500], 1)]
    streams = [short[0], comps[0], short[1], _chunked(comps[1], 333),
               short[2]]
    want = [zlib.decompress(bytes(s) if isinstance(s, bytes)
                            else b"".join(s)) for s in streams]
    r, o, st, moved = _inflate(streams)
    assert r == [Result.OK] * 5 and o == want
    # the short streams ride the launch as chains of one lane each; only
    # the long ones are counted as split
    assert moved["batch_split_streams"] == 2
    assert st["split_streams"] == 2
    _, _, st1 = _one_lane(streams)
    for key in ("status", "dst_pos", "bitpos"):
        assert st[key].tolist() == st1[key].tolist(), key


def test_a_short_stream_its_lane_cannot_finish_is_a_host_fallback(
        rows, small_segments):
    raw, comp = rows
    cut = zlib.compress(raw[:3000])[:-30]
    streams = [comp, cut, zlib.compress(b"hello " * 40)]
    r, o, st, moved = _inflate(streams)
    jr, jo = japi.inflate_batch(streams, backend="host")
    assert [int(x) for x in r] == [int(x) for x in jr] and o == jo
    assert r[1] is Result.UNFINISHED
    assert st["host_fallbacks"] == [1] and moved["host_fallback_lanes"] == 1
    assert moved["batch_split_streams"] == 1


def test_a_batch_of_short_streams_takes_the_one_lane_route(
        raws, small_segments, monkeypatch):
    streams = [zlib.compress(raws[0][:2000]), zlib.compress(raws[1][:2500])]
    assert all(len(s) - 2 < 3 * SEG for s in streams)
    assert not split.wanted(streams, True)

    def refused(*a, **k):
        raise AssertionError("the split route was taken")

    monkeypatch.setattr(split, "inflate", refused)
    r, o, st, moved = _inflate(streams)
    assert r == [Result.OK, Result.OK]
    assert o == [raws[0][:2000], raws[1][:2500]]
    assert moved == dict.fromkeys(COUNTERS, 0)
    # today's stats: no split keys, the step budget of the batch's bucket
    assert "split_streams" not in st
    assert st["T"] == ib.step_budget(st["C"])
    assert st["host_fallbacks"] == []


def test_device_resolve_and_dictionary_batches_keep_the_one_lane_route(
        raws, comps, monkeypatch):
    monkeypatch.setattr(split, "SEGMENT_BYTES", 512)

    def refused(*a, **k):
        raise AssertionError("the split route was taken")

    monkeypatch.setattr(split, "inflate", refused)
    zdict, raw = raws[0][:4000], raws[1][:5000]
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 4, zdict=zdict)
    with_dict = co.compress(raw) + co.flush()
    plain = _small_blocks(raw)
    assert min(len(with_dict), len(plain)) - 2 >= 3 * 512
    r, o, _ = tsess.device_inflate([with_dict], dictionary=zdict,
                                   device="cpu")
    assert r == [Result.OK] and o == [raw]
    r, o, _ = tsess.device_inflate([plain], resolve="device", device="cpu")
    assert r == [Result.OK] and o == [raw]


@pytest.mark.parametrize("flags", [FLAG_ZLIB, FLAG_ZLIB | FLAG_VERIFY_ADLER32])
def test_the_trailer_check_on_split_streams(raws, comps, small_segments,
                                            flags):
    good = comps[1]
    bad = bytearray(good)
    bad[-1] ^= 0x5A
    cut = good[:-2]
    r, o, _, moved = _inflate([good, bytes(bad), cut], flags)
    assert moved["batch_split_streams"] == 3
    if flags & FLAG_VERIFY_ADLER32:
        assert r == [Result.OK, Result.ERR, Result.UNFINISHED]
    else:
        assert r == [Result.OK] * 3
    assert o == [raws[1]] * 3
    jr, jo = japi.inflate_batch([good, bytes(bad), cut], flags,
                                backend="host")
    assert [int(x) for x in r] == [int(x) for x in jr] and o == jo


def _malformed(comp: bytes, seed: int) -> list[bytes]:
    """Truncated and bit-flipped copies of a long stream, a bad header and
    a preset-dictionary flag with no dictionary."""
    rng = random.Random(seed)
    cases = [comp[:rng.randrange(3 * SEG + 2, len(comp))] for _ in range(3)]
    for _ in range(4):
        d = bytearray(comp)
        d[rng.randrange(2, len(d))] ^= 1 << rng.randrange(8)
        cases.append(bytes(d))
    cases.append(b"\x79\x9c" + comp[2:])
    cmf, flg = comp[0], (comp[1] | 0x20) & ~0x1F
    flg |= (31 - ((cmf << 8) | flg) % 31) % 31
    cases.append(bytes([cmf, flg]) + comp[2:])
    return cases


@pytest.mark.parametrize("seed, flags", [
    (1, FLAG_ZLIB), (2, FLAG_ZLIB | FLAG_VERIFY_ADLER32)])
def test_malformed_long_streams_match_the_reference(comps, small_segments,
                                                    seed, flags):
    cases = _malformed(comps[0], seed)
    r, o, _, moved = _inflate(cases, flags)
    jr, jo = japi.inflate_batch(cases, flags, backend="host")
    assert [int(x) for x in r] == [int(x) for x in jr]
    assert o == jo
    assert r[-2:] == [Result.ERR, Result.ERR]   # bad header, FDICT
    assert any(x is Result.UNFINISHED for x in r[:3])
    assert moved["batch_split_streams"] == len(cases) - 2


def test_a_flip_that_reaches_before_the_stream_is_an_error(
        comps, small_segments):
    """A flipped bit turns a distance into one that reaches before the
    stream's first byte.  The lane after the flip starts at a block start
    with a whole window before it, so it decodes OK on the device; the
    stitch must not take its tokens (they resolve against bytes the stream
    does not have) and decodes serially to the engines' ERR.  Also
    ``inflate_large``'s split decode, which shares the stitch."""
    raw = b"".join(make_silesia_like(65536, 65536))[:20000]
    comp = bytearray(_small_blocks(raw))
    comp[4060] ^= 1 << 7
    comp = bytes(comp)
    jr, jo = japi.inflate_batch([comp], backend="host")
    assert jr == [Result.ERR]
    r, o, st, _ = _inflate([comp])
    assert r == [Result.ERR] and o == jo
    # every seam validates: only the resolve of the lane sees the fault
    assert st["split_lanes_valid"] == st["split_lanes"] > 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tlarge, "SEGMENT_BYTES", SEG)
        lr, lo = tlarge.inflate_large(comp, use_device=True, device="cpu")
    assert lr is Result.ERR and lo == jo[0]


def test_one_malformed_stream_changes_no_other_stream(raws, comps,
                                                      small_segments):
    good = [comps[0], _chunked(comps[1], 512)]
    r0, o0, st0, _ = _inflate(good)
    for bad in _malformed(comps[1], 7)[:5]:
        r, o, st, _ = _inflate([good[0], bad, good[1]])
        assert [r[0], r[2]] == r0 and [o[0], o[2]] == o0 == raws
        for key in ("status", "dst_pos", "bitpos"):
            assert [st[key][0], st[key][2]] == st0[key].tolist()


def test_a_batch_past_the_cursors_goes_in_more_than_one_launch(
        raws, comps, small_segments, monkeypatch):
    sizes = [len(c) - 2 for c in comps]
    assert split._groups(sizes) == [[0, 1]]
    bound = sizes[0] + 100
    monkeypatch.setattr(tlarge, "device_route_allowed",
                        lambda n: n < bound)
    assert split._groups(sizes + [50, 60]) == [[0], [1], [2, 3]]
    calls = []
    launch = tlarge.decode_chains

    def counted(body_dev, chains, *a, **k):
        calls.append([n for _, n, _, _ in chains])
        return launch(body_dev, chains, *a, **k)

    monkeypatch.setattr(tlarge, "decode_chains", counted)
    r, o, _, moved = _inflate(comps)
    assert r == [Result.OK, Result.OK] and o == raws
    assert calls == [[sizes[0]], [sizes[1]]]
    assert moved["batch_split_streams"] == 2


@pytest.mark.parametrize("route", ["batch", "large"])
def test_both_routes_launch_and_stitch_through_the_chain_path(
        raws, comps, small_segments, monkeypatch, route):
    """A batch of several long streams (kodak32.batch's shape, shrunk) and
    one ``inflate_large(use_device=True)`` call each reach the decode
    kernel through ``large.decode_chains``, once a launch, and the native
    stitch through ``large.stitch_chains``, once."""
    calls = {"decode_tokens": 0, "decode_chains": 0, "stitch_chains": 0}

    def counting(module, name):
        f = getattr(module, name)

        def counted(*a, **k):
            calls[name] += 1
            return f(*a, **k)
        monkeypatch.setattr(module, name, counted)

    counting(decode_cu, "decode_tokens")
    counting(tlarge, "decode_chains")
    counting(tlarge, "stitch_chains")
    if route == "batch":
        streams = [comps[0], _chunked(comps[1], 700), comps[1], comps[0]]
        r, o, _, moved = _inflate(streams)
        assert r == [Result.OK] * 4 and o == [raws[0], raws[1], raws[1],
                                              raws[0]]
        assert moved["batch_split_streams"] == 4
    else:
        monkeypatch.setattr(tlarge, "SEGMENT_BYTES", SEG)
        st = {}
        r, o = tlarge.inflate_large(comps[1], use_device=True, stats_out=st,
                                    device="cpu")
        assert r is Result.OK and o == raws[1] and st["route"] == "device"
    assert calls == {"decode_tokens": 1, "decode_chains": 1,
                     "stitch_chains": 1}


def test_header_verdicts():
    assert tlarge.header_result(b"\x78\x9c") is None
    assert tlarge.header_result(b"\x78") is Result.UNFINISHED
    assert tlarge.header_result(b"") is Result.UNFINISHED
    for bad in (b"\x79\x9c", b"\x78\x9d", b"\x88\x98", b"\x78\xbb"):
        assert tlarge.header_result(bad) is Result.ERR, bad
    assert tpack.stream_head([b"x", b"", memoryview(b"\x9cabc")], 2) == \
        b"x\x9c"


def test_stream_choice(comps, small_segments):
    assert split.wanted([comps[0]], True)
    assert split.wanted([b"\x78\x9c", comps[0]], True)
    assert not split.wanted([b"\x79\x9c" + comps[0][2:]], True)
    assert not split.wanted([comps[0][:3 * SEG + 1]], True)
    assert split.wanted([comps[0][:3 * SEG + 2]], True)
    assert split.wanted([comps[0][2:]], False)
    assert not split.wanted([], True)
    big = np.zeros(tsess.MAX_STREAM_BYTES + 1, np.uint8).tobytes()
    assert not split.wanted([comps[0], big], True)


def test_many_finds_in_one_call_equal_one_at_a_time(comps):
    """``find_block_starts`` over streams laid end to end: each find is the
    one-stream finder's on its own stream, and reads nothing past it."""
    lib = tnative.load()
    bodies = [np.frombuffer(c[2:], np.uint8) for c in comps]
    body = np.concatenate(bodies + [np.full(64, 0xFF, np.uint8)])
    offs = [0, bodies[0].size]
    owner, lo, hi = [], [], []
    for s_, b in enumerate(bodies):
        for t in range(0, 8 * b.size, 997):
            owner.append(s_)
            lo.append(t)
            hi.append(min(t + 6000, 8 * b.size + 500))
    got = tnative.find_block_starts(
        lib, body, [offs[k] for k in owner],
        [bodies[k].size for k in owner], lo, hi, n_threads=3)
    want = [tnative.find_block_start(lib, bodies[k], a, b)
            for k, a, b in zip(owner, lo, hi)]
    assert got.tolist() == want and max(want) > 0 and -1 in want
    with pytest.raises(ValueError):
        tnative.find_block_starts(lib, body, [offs[1]], [body.size], [0],
                                  [8])


@pytest.mark.parametrize("seed, copies, threads", [
    (5, 1, 2), (6, 12, 4 * (os.cpu_count() or 1))])
def test_many_stitches_in_one_call_equal_one_at_a_time(comps, seed, copies,
                                                       threads):
    """``stitch_many`` against ``stitch`` chain by chain, on lane metadata
    of random junk with some seams made to validate (as the fuzz of the
    stitch makes it), and with no lane (every gap decoded serially); also
    many chains on more threads than the host has cores."""
    lib = tnative.load()
    rng = np.random.default_rng(seed)
    bodies = [np.frombuffer(c[2:], np.uint8) for c in comps] * copies
    raws = [zlib.decompress(c) for c in comps] * copies
    body = np.concatenate(bodies)
    offs = np.cumsum([0] + [b.size for b in bodies[:-1]])
    cands = []
    for b in bodies:
        c = [0]
        while (h := tnative.find_block_start(lib, b, c[-1] + 999,
                                             8 * b.size)) > 0:
            c.append(h)
        cands.append(c)
    M, T = sum(map(len, cands)), 64
    toks = rng.integers(0, 1 << 32, (M, T), dtype=np.uint64).astype(
        np.uint32)
    dst_pos = rng.integers(0, 5000, M).astype(np.int32)
    status = rng.integers(-1, 2, M).astype(np.int32)
    final = np.zeros(M, np.int32)
    bit_end = np.concatenate([np.append(c[1:], 8 * b.size)
                              for c, b in zip(cands, bodies)])
    bit_end[rng.random(M) < 0.3] += 1
    first = np.cumsum([0] + [len(c) for c in cands[:-1]])
    for lanes in ((toks, dst_pos, status, final, bit_end),
                  (toks, dst_pos, np.ones(M, np.int32), final, bit_end)):
        outs = [np.zeros(len(r) + 4096, np.uint8) for r in raws]
        rs, totals, ends, _ = tnative.stitch_many(
            lib, body, offs, [b.size for b in bodies], first,
            [len(c) for c in cands], np.concatenate(cands), lanes, outs,
            n_threads=threads)
        for k, b in enumerate(bodies):
            own = [a[first[k]:first[k] + len(cands[k])] for a in lanes]
            out = np.zeros_like(outs[k])
            r, total, end = tnative.stitch(lib, b, cands[k], tuple(own), out)
            assert (rs[k], totals[k], ends[k]) == (r, total, end)
            assert np.array_equal(outs[k], out)
    assert rs == [Result.OK] * len(bodies)
    assert [o[:n].tobytes() for o, n in zip(outs, totals)] == raws
